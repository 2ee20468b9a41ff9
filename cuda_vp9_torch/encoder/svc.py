"""VP9 spatial scalable (SVC) encoding.

Reference counterparts: examples/vp9_spatial_svc_encoder.c,
examples/svc_encodeframe.c, vp9/encoder/vp9_svc_layercontext.c.  Each
temporal instant emits ONE superframe containing every spatial layer's
frame: layer 0 at the smallest size (a real keyframe at GOP starts),
each higher layer coded as a non-shown... shown only at the top.  A
layer predicts inter-layer from the immediately lower layer's
reconstruction of the SAME instant via scaled-reference MC
(vp9_scale.c; the lower layer's frame lives in ref slot L-1, refreshed
in decode order within the superframe) — the mechanism the reference's
GPU path cannot handle and this rebuild decodes on device (runtime/
fused.py mcs class).

Layer sizes follow the example's scale-factor ladder: layer i is
(W >> (n-1-i), H >> (n-1-i)) — dyadic, within the spec's 2x
inter-layer limit.
"""

from __future__ import annotations

import numpy as np

from .encoder import Vp9Encoder


def pack_superframe(frames) -> bytes:
    """Append a VP9 superframe index (decoder/bitreader.py
    parse_superframe_index mirror; vp9/vp9_dx_iface.c:354)."""
    if len(frames) == 1:
        return frames[0]
    sizes = [len(f) for f in frames]
    mag = max(1, (max(sizes).bit_length() + 7) // 8)
    marker = 0xC0 | (len(frames) - 1) | ((mag - 1) << 3)
    idx = bytearray([marker])
    for s in sizes:
        idx += s.to_bytes(mag, "little")
    idx.append(marker)
    return b"".join(frames) + bytes(idx)


def downsample2x(planes):
    """2x2 box-average downsample of [y, u, v] (encoder-side choice;
    the spec does not constrain how lower layers are produced)."""
    out = []
    for p in planes:
        p = np.asarray(p)
        h, w = p.shape
        if h & 1:
            p = np.vstack([p, p[-1:]])
        if w & 1:
            p = np.hstack([p, p[:, -1:]])
        q = p.astype(np.uint32).reshape(p.shape[0] // 2, 2,
                                        p.shape[1] // 2, 2)
        out.append(((q.sum(axis=(1, 3)) + 2) >> 2).astype(p.dtype))
    return out


class Vp9SvcEncoder:
    """n_layers-spatial-layer VP9 SVC encoder producing superframes.

    encode_frame(planes) -> one superframe payload (bytes).  Layer i
    refreshes ref slot i; layers > 0 predict ZEROMV from the scaled
    reconstruction of layer i-1 (slot i-1) plus coded residual, with
    per-block intra fallback.  Only the top layer is shown, matching
    vp9_spatial_svc_encoder's output contract.
    """

    def __init__(self, width: int, height: int, n_layers: int = 2,
                 base_qindex=120, gop: int = 8, bit_depth: int = 8):
        if not 2 <= n_layers <= 4:
            raise ValueError("n_layers must be 2..4")
        self.width, self.height = width, height
        self.n = n_layers
        self.gop = max(1, gop)
        self.frame_idx = 0
        if isinstance(base_qindex, int):
            # lower layers get a coarser q (the example's default rc
            # ladder shape)
            base_qindex = [min(255, base_qindex + 12 * (n_layers - 1 - i))
                           for i in range(n_layers)]
        self.layers = []
        for i in range(n_layers):
            sh = n_layers - 1 - i
            lw = max(16, width >> sh)
            lh = max(16, height >> sh)
            enc = Vp9Encoder(lw, lh, base_qindex=base_qindex[i],
                             bit_depth=bit_depth, gop=1)
            enc.ref_slot = max(0, i - 1)
            enc.refresh_slot = i
            enc.show_frame = (i == n_layers - 1)
            self.layers.append(enc)

    def encode_frame(self, planes) -> bytes:
        """Encode one source frame into an n-layer superframe."""
        # per-layer sources: repeated 2x downsampling from the top
        srcs = [None] * self.n
        srcs[self.n - 1] = [np.asarray(p) for p in planes]
        for i in range(self.n - 2, -1, -1):
            s = downsample2x(srcs[i + 1])
            lw, lh = self.layers[i].width, self.layers[i].height
            srcs[i] = [s[0][:lh, :lw], s[1][:(lh + 1) // 2, :(lw + 1) // 2],
                       s[2][:(lh + 1) // 2, :(lw + 1) // 2]]
        is_gop_start = self.frame_idx % self.gop == 0
        chunks = []
        prev_recon = None
        prev_dims = None
        for i, enc in enumerate(self.layers):
            if i == 0:
                # base layer: keyframe at GOP starts, else temporal
                # prediction from its own last reconstruction
                chunks.append(enc.encode_frame(srcs[0],
                                               force_key=is_gop_start))
            else:
                # inter-layer: predict from the lower layer's recon of
                # THIS instant (slot i-1, scaled)
                enc.set_reference(prev_recon, prev_dims)
                chunks.append(enc.encode_frame(srcs[i], force_key=False))
            prev_recon = [p.copy() for p in enc._last_recon]
            prev_dims = (enc.width, enc.height)
        self.frame_idx += 1
        return pack_superframe(chunks)

    @property
    def layer_dims(self):
        return [(e.width, e.height) for e in self.layers]
