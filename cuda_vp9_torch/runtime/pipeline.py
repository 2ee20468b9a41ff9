"""TorchRecon: the torch reconstruction backend for NativeVp9Decoder.

Counterpart of `cuda_vp9_tpu/runtime/pipeline.py` `TpuReconFused`.  Per
frame: pack ONE flat int16 buffer on the host (the C++ packer, or
`runtime/pack.pack_frame` when the plan has no native parser), then run
the frame step of `runtime/fused.py` on `device`.  The reference pool
[8, 3, pha, pwa] int32 and an output ring of RING rows (uint8, or int16
above 8 bits) stay on the device; a frame's planes come back as
LazyPlanes (uint16 numpy), fetched with all other pending rows in one
device-to-host copy when first read, and always before their ring row is
reused.

Tiers as in JAX: intra-only frames pack the "full" tier, inter frames
"tight", escalating to "wide" when tight overflows, and frames with a
reference of another size "scaled".  A frame that overflows its last
tier, or whose reference lies outside the spec's scale range, is decoded
by the host oracle (counted in `frames_on_host`), and the pool slots it
refreshes are re-uploaded before a later device frame reads them
(`_sync_slot`).  The pool canvas is the largest of the frame and its
references, kept across frames until a keyframe changes it, or the bit
depth or chroma format changes.

The slice: bit depths 8, 10 and 12; chroma 4:2:0, 4:4:4 and 4:2:2;
lossless frames; scaled references with 4:2:0 chroma.  4:2:0 frames pack
with the C++ packer, the others with `runtime/pack.pack_frame`, as in
JAX.  Frames outside the slice (4:4:0, scaled references with other
chroma) raise NotImplementedError naming the ROADMAP item, where JAX
sends them to its host oracle; they never go to the host here.  The flat
goes up page-compacted from pinned memory through the recon's
`upload.Uploader` (`TpuReconFused._compact`, without its page tiers), and
the step rebuilds it on the device.  Spans (`utils/spans.py`): vp9.pack
around the pack, vp9.readback around the fetch of the ring rows, and the
step's own.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from .. import models as M
from ..decoder import constants as C
from ..ops.ref import recon as ref_recon
from ..ops.ref.inter import ScaleFactors
from ..utils import spans
from . import fused, pack
from .upload import Uploader


def _align(mi: int) -> int:
    return ((mi + 7) & ~7) * 8


class LazyPlanes:
    """Planes [y, u, v] (uint16 numpy) of a device-decoded frame, read
    from the output ring on first access."""

    def __init__(self, recon, slot, ha, wa, ss=(1, 1)):
        self._recon = recon
        self._slot = slot
        self._geom = (ha, wa)
        self._ss = ss
        self._planes = None

    def _set_from_ring(self, row):
        ha, wa = self._geom
        hc, wc = ha >> self._ss[1], wa >> self._ss[0]
        ny, nc = ha * wa, hc * wc
        self._planes = [
            row[:ny].reshape(ha, wa).astype(np.uint16),
            row[ny:ny + nc].reshape(hc, wc).astype(np.uint16),
            row[ny + nc:ny + 2 * nc].reshape(hc, wc).astype(np.uint16)]

    def _force(self):
        if self._planes is None:
            self._recon.flush()
        return self._planes

    def __getitem__(self, i):
        return self._force()[i]

    def __len__(self):
        return 3

    def __iter__(self):
        return iter(self._force())


class TorchRecon:
    """recon_fn(plan, refs) -> planes, with the frame step on `device`."""

    RING = 32

    def __init__(self, device):
        self.device = torch.device(device)
        self.kernels = torch.as_tensor(np.asarray(M.FILTER_KERNELS, np.int32),
                                       device=self.device)
        self.uploader = Uploader(self.device)
        self._steps = {}
        self._pool = None
        self._ring = None
        self._geom = None            # pool canvas (pha, pwa)
        self._format = None          # (bit depth, chroma ss) of the pool
        self._slot_dirty = [True] * 8
        self._ring_slot = 0
        self._pending = []
        self.frames_on_device = 0
        self.frames_on_host = 0
        self.frames_wide = 0      # inter frames escalated to the wide tier

    def _step(self, mi_rows, mi_cols, tier, pool_ha, lossless, bd, ss):
        key = (mi_rows, mi_cols, tier, pool_ha, lossless, bd, ss)
        if key not in self._steps:
            self._steps[key] = fused.get_frame_step(
                mi_rows, mi_cols, tier, lossless, bd, ss, pool_ha=pool_ha)
        return self._steps[key]

    def flush(self):
        """Fetch every pending frame's ring row in one device-to-host
        copy; the ring is then free from row 0."""
        if self._pending:
            with spans.span("vp9.readback"):
                lo, hi = self._pending[0]._slot, self._pending[-1]._slot
                rows = self._ring[lo:hi + 1].cpu().numpy()
                for lp in self._pending:
                    lp._set_from_ring(rows[lp._slot - lo])
        self._pending = []
        self._ring_slot = 0

    @staticmethod
    def _scaled(hdr, refs) -> bool:
        return not hdr.frame_is_intra_only and any(
            rb is not None and (rb.width, rb.height) != (hdr.width, hdr.height)
            for rb in refs.values())

    @staticmethod
    def _can_run_on_device(hdr, refs) -> bool:
        """TpuReconFused._can_run_on_device (pipeline.py:322-346) for a
        frame inside the slice (require_slice): references outside the
        spec's scale range go to the host oracle."""
        return all(
            ScaleFactors(rb.width, rb.height, hdr.width, hdr.height).is_valid()
            for rb in refs.values() if rb is not None)

    def _ensure_pool(self, hdr, refs):
        """(Re)allocate the pool and ring for the canvas that holds the
        frame and its references (TpuReconFused._ensure_pool): kept while
        it fits and the format holds, except that a keyframe resets it to
        its own need."""
        pha, pwa = _align(hdr.mi_rows), _align(hdr.mi_cols)
        if not hdr.frame_is_intra_only:
            for rb in refs.values():
                if rb is not None:
                    pha = max(pha, _align((rb.height + 7) // 8))
                    pwa = max(pwa, _align((rb.width + 7) // 8))
        ss = (hdr.subsampling_x, hdr.subsampling_y)
        fmt = (hdr.bit_depth, ss)
        cur = self._geom
        if cur is not None and fmt == self._format and pha <= cur[0] \
                and pwa <= cur[1] and not (
                    hdr.frame_type == C.KEY_FRAME and (pha, pwa) != cur):
            return cur
        self.flush()
        nout = pha * pwa + 2 * (pha >> ss[1]) * (pwa >> ss[0])
        self._pool = torch.zeros((8, 3, pha, pwa), dtype=torch.int32,
                                 device=self.device)
        self._ring = torch.zeros((self.RING, nout),
                                 dtype=fused.ring_dtype(hdr.bit_depth),
                                 device=self.device)
        self._geom = (pha, pwa)
        self._format = fmt
        self._slot_dirty = [True] * 8
        return self._geom

    def _sync_slot(self, i, rb):
        """Upload a host RefBuffer into pool slot i."""
        canvas = convert.ref_canvas(rb, *self._geom)
        self._pool[i].copy_(torch.from_numpy(canvas))
        self._slot_dirty[i] = False

    def __call__(self, plan, refs):
        hdr = plan.hdr
        fused.require_slice((hdr.subsampling_x, hdr.subsampling_y),
                            self._scaled(hdr, refs))
        planes = None
        if self._can_run_on_device(hdr, refs):
            planes = self._recon_device(plan, refs)
        if planes is not None:
            self.frames_on_device += 1
            return planes
        self.frames_on_host += 1
        planes = ref_recon.reconstruct_frame(plan, refs)
        for i in range(8):
            if hdr.refresh_frame_flags & (1 << i):
                self._slot_dirty[i] = True
        return planes

    def _recon_device(self, plan, refs):
        hdr = plan.hdr
        ss = (hdr.subsampling_x, hdr.subsampling_y)
        ha, wa = _align(hdr.mi_rows), _align(hdr.mi_cols)
        pha, pwa = self._ensure_pool(hdr, refs)
        pool_ha = pha if (pha, pwa) != (ha, wa) else None
        if not hdr.frame_is_intra_only:
            for k, rb in refs.items():
                rslot = hdr.ref_frame_idx[k - 1]
                if rb is not None and self._slot_dirty[rslot]:
                    self._sync_slot(rslot, rb)
        if self._ring_slot >= self.RING:
            self.flush()
        slot = self._ring_slot
        nparser = getattr(plan, "native_parser", None)

        def pack_tier(tier):
            step, caps, layout = self._step(
                hdr.mi_rows, hdr.mi_cols, tier, pool_ha, bool(hdr.lossless),
                hdr.bit_depth, ss)
            with spans.span("vp9.pack"):
                if nparser is not None and ss == (1, 1):
                    flat = nparser.pack(plan, refs, caps, layout,
                                        ring_slot=slot, pool_ha=pool_ha)
                else:
                    flat = pack.pack_frame(plan, refs, caps, layout,
                                           pool_ha=pha)
                    if flat is not None:
                        layout.view(flat, "misc")[13] = slot
            return step, flat

        tier = "full" if hdr.frame_is_intra_only else (
            "scaled" if self._scaled(hdr, refs) else "tight")
        step, flat = pack_tier(tier)
        if flat is None and tier == "tight":
            step, flat = pack_tier("wide")
            self.frames_wide += flat is not None
        if flat is None:
            return None
        step(self._pool, self._ring, self.kernels, flat,
             uploader=self.uploader)
        planes = LazyPlanes(self, slot, ha, wa, ss)
        self._pending.append(planes)
        self._ring_slot = slot + 1
        for i in range(8):
            if hdr.refresh_frame_flags & (1 << i):
                self._slot_dirty[i] = False
        return planes
