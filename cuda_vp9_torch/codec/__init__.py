"""Public codec API: vpx_codec_* parity (vpx/vpx_decoder.h, vpx_codec.h,
vpx_image.h semantics) for VP9, decoded on a torch device, and VP8,
decoded on the host.

Call-shape parity with the reference (SURVEY.md §2 S14/S15):

    ctx = CodecCtx()
    vpx_codec_dec_init(ctx, vp9_dx_torch("cuda"), DecCfg(threads=1), 0)
    vpx_codec_decode(ctx, frame_bytes, user_priv=None)
    it = FrameIter()
    while (img := vpx_codec_get_frame(ctx, it)) is not None:
        ...  # img.planes / img.stride / img.fmt
    vpx_codec_destroy(ctx)

vpx_codec_dec_init  -> vpx/src/vpx_decoder.c:24  (vpx_codec_dec_init_ver)
vpx_codec_decode    -> vpx/src/vpx_decoder.c:104
vpx_codec_get_frame -> vpx/src/vpx_decoder.c:123
peek_stream_info    -> vp9/vp9_dx_iface.c (decoder_peek_si_internal)
controls            -> vpx/vp8dx.h control IDs (subset)

`vp9_dx_torch(device)` is the iface: the C++ host parser
(`native/`) feeds `TorchRecon(device)` (runtime/pipeline.py), which
reconstructs every frame on `device` (only a frame whose reference lies
outside the spec's scale range, or one that overflows its last capacity
tier, goes to the host oracle, as in the JAX package).  It never swaps the device backend for another one: a failure to build it
fails `vpx_codec_dec_init`.

`vp8_dx()` is the VP8 iface: `vp8.Vp8StreamDecoder`, the NumPy decoder
of RFC 6386, on the host by design (the reference decodes VP8 on the
CPU as well; its GPU passes are VP9's only), with error concealment
(VPX_CODEC_USE_ERROR_CONCEALMENT) and the display-side postproc
(VPX_CODEC_USE_POSTPROC, VP8_SET_POSTPROC), which the VP9 iface refuses
as the reference's does.  It takes no device and puts no work on one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import spans

# --------------------------------------------------------------- error codes

VPX_CODEC_OK = 0
VPX_CODEC_ERROR = 1
VPX_CODEC_MEM_ERROR = 2
VPX_CODEC_ABI_MISMATCH = 3
VPX_CODEC_INCAPABLE = 4
VPX_CODEC_UNSUP_BITSTREAM = 5
VPX_CODEC_UNSUP_FEATURE = 6
VPX_CODEC_CORRUPT_FRAME = 7
VPX_CODEC_INVALID_PARAM = 8
VPX_CODEC_LIST_END = 9

# ----------------------------------------------------------------- img fmts

VPX_IMG_FMT_I420 = 0x102
VPX_IMG_FMT_I42016 = 0x102 | 0x800  # VPX_IMG_FMT_HIGHBITDEPTH

# ----------------------------------------------------------------- controls

# vp8dx.h enum vp8_dec_control_id (VP8_DECODER_CTRL_ID_START = 256)
VP8D_GET_LAST_REF_UPDATES = 256
VP8D_GET_FRAME_CORRUPTED = 257
VP8D_GET_LAST_REF_USED = 258
VPXD_GET_LAST_QUANTIZER = 259
VPXD_SET_DECRYPTOR = 260
VP9D_GET_DISPLAY_SIZE = 261
VP9D_GET_BIT_DEPTH = 262
VP9D_GET_FRAME_SIZE = 263
VP9_INVERT_TILE_DECODE_ORDER = 264
VP9_SET_BYTE_ALIGNMENT = 265
VP9_SET_SKIP_LOOP_FILTER = 266
VP9_DECODE_SVC_SPATIAL_LAYER = 267
VP9D_GET_FRAME_HEADER_INFO = 268
VP9D_SET_ROW_MT = 269
VP9D_GET_TILE_DATA = 270
VP9D_SET_LOOP_FILTER_OPT = 271

# vpx/vp8.h common control ids (decoder-side support mirrors
# vp9_dx_iface.c:675-697): reference get/set/copy + postproc config
VP8_SET_REFERENCE = 1
VP8_COPY_REFERENCE = 2
VP8_SET_POSTPROC = 3
VP9_GET_REFERENCE = 128
# vpx_ref_frame_type (vpx/vp8.h:121)
VP8_LAST_FRAME = 1
VP8_GOLD_FRAME = 2
VP8_ALTR_FRAME = 4

# vpx/vp8.h vp8_postproc_level (VP8 display-side filters)
VP8D_NOFILTERING = 0
VP8D_DEBLOCK = 1 << 0
VP8D_DEMACROBLOCK = 1 << 1
VP8D_ADDNOISE = 1 << 2
VP8D_MFQE = 1 << 10


class PostProcCfg:
    """vp8_postproc_cfg_t parity (vpx/vp8.h:80-85)."""

    def __init__(self, post_proc_flag: int = 0, deblocking_level: int = 4,
                 noise_level: int = 0):
        self.post_proc_flag = post_proc_flag
        self.deblocking_level = deblocking_level
        self.noise_level = noise_level


class RefFrame:
    """vpx_ref_frame_t / vp9_ref_frame_t parity: `frame_type` selects
    the reference for SET/COPY; `planes` ([y, u, v] numpy, visible/crop
    dims) is the input (SET) or is populated (COPY / GET)."""

    def __init__(self, frame_type: int = VP8_LAST_FRAME, planes=None):
        self.frame_type = frame_type
        self.planes = planes


# init-time flags (vpx/vpx_decoder.h:73-80)
VPX_CODEC_USE_POSTPROC = 0x10000
VPX_CODEC_USE_ERROR_CONCEALMENT = 0x20000
# the capabilities they need (vpx/vpx_decoder.h VPX_CODEC_CAP_*)
VPX_CODEC_CAP_POSTPROC = 0x40000
VPX_CODEC_CAP_ERROR_CONCEALMENT = 0x80000


class CodecError(Exception):
    def __init__(self, code, msg=""):
        self.code = code
        super().__init__(msg or f"vpx_codec error {code}")


@dataclasses.dataclass
class DecCfg:
    """vpx_codec_dec_cfg_t parity (vpx/vpx_decoder.h:110)."""
    threads: int = 1
    w: int = 0
    h: int = 0


@dataclasses.dataclass
class StreamInfo:
    """vpx_codec_stream_info_t parity."""
    w: int = 0
    h: int = 0
    is_kf: int = 0


class Image:
    """vpx_image_t parity: planar frame with per-plane strides.

    Pixel planes materialize lazily: with the torch backend, frames live
    in a device-resident output ring and are fetched in batches; touching
    .planes (or .stride) forces the fetch."""

    def __init__(self, frame, width, height, bit_depth, ss_x, ss_y):
        self.fmt = VPX_IMG_FMT_I420 if bit_depth == 8 else VPX_IMG_FMT_I42016
        self.d_w = width
        self.d_h = height
        self.bit_depth = bit_depth
        self.x_chroma_shift = ss_x
        self.y_chroma_shift = ss_y
        self._frame = frame
        self._planes = None

    @property
    def planes(self):
        if self._planes is None:
            self._planes = self._frame.visible_planes()
        return self._planes

    @property
    def stride(self):
        return [p.shape[1] * p.itemsize for p in self.planes]


class Vp9TorchIface:
    """vpx_codec_vp9_dx_algo parity (vp9/vp9_dx_iface.c:719) with the
    frame step on a torch device."""

    name = "cuda-vp9-torch VP9 Decoder"
    # no postproc and no error concealment, as the reference's VP9
    # (vpx_config.h CONFIG_VP9_POSTPROC=0; vp9_dx_iface.c caps)
    caps = 0

    def __init__(self, device):
        self.device = torch.device(device)

    def make_decoder(self, cfg: DecCfg, use_postproc: bool = False,
                     ec: bool = False):
        """(decoder, recon) with the frame step on the iface's device;
        `vpx_codec_dec_init` asks for neither option (caps)."""
        from ..decoder.frame import NativeVp9Decoder
        from ..runtime.pipeline import TorchRecon
        recon = TorchRecon(self.device)
        # cfg.threads -> tile-parallel host entropy parse
        return NativeVp9Decoder(recon_fn=recon, threads=cfg.threads), recon


def vp9_dx_torch(device) -> Vp9TorchIface:
    """The VP9 decoder iface with reconstruction on `device`
    (vpx_codec_vp9_dx() parity)."""
    return Vp9TorchIface(device)


class Vp8HostIface:
    """vpx_codec_vp8_dx_algo parity (vp8/vp8_dx_iface.c:731): key and
    inter frames, bit-exact vs the normative vp8 decoder, decoded on the
    host."""

    name = "cuda-vp9-torch VP8 Decoder (host)"
    # the reference is built --enable-error-concealment
    # (vp8/decoder/onyxd_if.c:97) and with VP8 postproc
    caps = VPX_CODEC_CAP_POSTPROC | VPX_CODEC_CAP_ERROR_CONCEALMENT

    def make_decoder(self, cfg: DecCfg, use_postproc: bool = False,
                     ec: bool = False):
        """(decoder, None): VP8 has no device recon.  `use_postproc` and
        `ec` are the VPX_CODEC_USE_POSTPROC and
        VPX_CODEC_USE_ERROR_CONCEALMENT init flags."""
        from ..vp8 import Vp8StreamDecoder
        return Vp8StreamDecoder(ec_enabled=ec,
                                use_postproc=use_postproc), None


_VP8_IFACE = Vp8HostIface()


def vp8_dx() -> Vp8HostIface:
    """vpx_codec_vp8_dx() parity: the VP8 iface, on the host."""
    return _VP8_IFACE


class CodecCtx:
    """vpx_codec_ctx_t parity."""

    def __init__(self):
        self.iface = None
        self.name = None
        self.err = VPX_CODEC_OK
        self.err_detail = ""
        self._dec = None
        self._recon = None
        self._frames = []
        self._corrupted = 0
        self._last = None
        self._fb_get = None
        self._fb_release = None
        self._fb_priv = None
        self._decrypt = None       # VPXD_SET_DECRYPTOR (cb, state)
        self._svc_layer = -1       # VP9_DECODE_SVC_SPATIAL_LAYER
        self._ext_fbs = []


class FrameIter:
    """vpx_codec_iter_t parity (opaque iterator token)."""

    def __init__(self):
        self.pos = 0


def vpx_codec_dec_init(ctx: CodecCtx, iface, cfg: Optional[DecCfg] = None,
                       flags: int = 0) -> int:
    """vpx_codec_dec_init_ver parity (vpx/src/vpx_decoder.c:24)."""
    if ctx is None or iface is None:
        return VPX_CODEC_INVALID_PARAM
    cfg = cfg or DecCfg()
    ctx.iface = iface
    ctx.name = iface.name
    use_postproc = bool(flags & VPX_CODEC_USE_POSTPROC)
    ec = bool(flags & VPX_CODEC_USE_ERROR_CONCEALMENT)
    # vpx_codec_dec_init_ver: a flag whose capability the iface lacks
    if use_postproc and not iface.caps & VPX_CODEC_CAP_POSTPROC:
        ctx.err = VPX_CODEC_INCAPABLE
        ctx.err_detail = "postproc not supported for this codec"
        return ctx.err
    if ec and not iface.caps & VPX_CODEC_CAP_ERROR_CONCEALMENT:
        ctx.err = VPX_CODEC_INCAPABLE
        ctx.err_detail = "error concealment not supported"
        return ctx.err
    try:
        ctx._dec, ctx._recon = iface.make_decoder(
            cfg, use_postproc=use_postproc, ec=ec)
    except Exception as e:  # pragma: no cover
        ctx.err = VPX_CODEC_MEM_ERROR
        ctx.err_detail = str(e)
        return ctx.err
    ctx.err = VPX_CODEC_OK
    return VPX_CODEC_OK


def vpx_codec_decode(ctx: CodecCtx, data: Optional[bytes],
                     user_priv=None, deadline: int = 0) -> int:
    """vpx_codec_decode parity (vpx/src/vpx_decoder.c:104), in an
    api.vpx_codec_decode span (`utils/spans.py`).

    data=None flushes (end of stream), matching the reference's NULL-data
    convention."""
    with spans.span("api.vpx_codec_decode"):
        return _decode(ctx, data, user_priv)


def _decode(ctx: CodecCtx, data: Optional[bytes], user_priv) -> int:
    if ctx is None or ctx._dec is None:
        return VPX_CODEC_INVALID_PARAM
    if data is None:
        return VPX_CODEC_OK
    if ctx._decrypt is not None:
        # VPXD_SET_DECRYPTOR: (cb, state); the reference decrypts
        # buffers on demand during parse, we decrypt the whole payload
        cb, state = ctx._decrypt
        data = bytes(cb(state, data))
    try:
        if ctx._svc_layer >= 0:
            # VP9_DECODE_SVC_SPATIAL_LAYER: decode only the first
            # layer+1 frames of each superframe (vp9_dx_iface.c:358)
            from ..decoder.bitreader import parse_superframe_index
            layers = parse_superframe_index(data)
            for off, sz in layers[:ctx._svc_layer + 1]:
                ctx._dec.decode(data[off:off + sz])
        else:
            ctx._dec.decode(data)
    except Exception as e:
        ctx.err = VPX_CODEC_CORRUPT_FRAME
        ctx.err_detail = str(e)
        ctx._corrupted = 1
        return ctx.err
    # under error concealment a decode can succeed yet conceal: the
    # corrupt flag is still reported (VP8D_GET_FRAME_CORRUPTED)
    ctx._corrupted = 1 if getattr(ctx._dec, "frame_corrupt", False) else 0
    for f in ctx._dec.frames():
        ctx._frames.append((f, user_priv))
    return VPX_CODEC_OK


def vpx_codec_get_frame(ctx: CodecCtx, it: FrameIter) -> Optional[Image]:
    """vpx_codec_get_frame parity (vpx/src/vpx_decoder.c:123), in an
    api.vpx_codec_get_frame span (`utils/spans.py`)."""
    with spans.span("api.vpx_codec_get_frame"):
        return _get_frame(ctx, it)


def _get_frame(ctx: CodecCtx, it: FrameIter) -> Optional[Image]:
    if ctx is None or it is None:
        return None
    if it.pos >= len(ctx._frames):
        ctx._frames = []
        it.pos = 0
        return None
    f, user_priv = ctx._frames[it.pos]
    it.pos += 1
    img = Image(f, f.width, f.height, f.bit_depth,
                f.ss_x if hasattr(f, "ss_x") else 1,
                f.ss_y if hasattr(f, "ss_y") else 1)
    img.user_priv = user_priv
    if ctx._fb_get is not None:
        _attach_external_fb(ctx, img, f)
    ctx._last = img
    return img


class FrameBuffer:
    """vpx_codec_frame_buffer_t parity: the user's get callback fills
    `data` (a writable buffer of >= min_size bytes) and `priv`."""

    def __init__(self):
        self.data = None
        self.size = 0
        self.priv = None


def _attach_external_fb(ctx, img, frame):
    """Realize the frame's pixels into a user-provided buffer
    (vpx/vpx_frame_buffer.h semantics: get cb -> write -> the Image's
    planes view the user's memory; release cb fires when the codec no
    longer references it -- here, when the next frame displaces it or
    the decoder is destroyed)."""
    import numpy as np
    planes = frame._crop()      # inside vpx_codec_get_frame's span
    itemsize = 1 if frame.bit_depth == 8 else 2
    min_size = sum(int(p.size) * itemsize for p in planes)
    fb = FrameBuffer()
    if ctx._fb_get(ctx._fb_priv, min_size, fb) != 0 or fb.data is None \
            or fb.size < min_size:
        ctx.err = VPX_CODEC_MEM_ERROR
        return
    buf = np.frombuffer(fb.data, np.uint8, count=fb.size)
    off = 0
    views = []
    for p in planes:
        n = int(p.size) * itemsize
        dst = buf[off:off + n].view(p.dtype).reshape(p.shape)
        dst[:] = p
        views.append(dst)
        off += n
    img._planes = views
    img.fb_priv = fb.priv
    ctx._ext_fbs.append(fb)
    # the pool holds at most the ref slots + this frame; approximate the
    # reference's release timing by capping live external buffers
    while len(ctx._ext_fbs) > 12:
        ctx._fb_release(ctx._fb_priv, ctx._ext_fbs.pop(0))


def vpx_codec_set_frame_buffer_functions(ctx: CodecCtx, cb_get, cb_release,
                                         cb_priv=None) -> int:
    """vpx_codec_set_frame_buffer_functions parity
    (vpx/src/vpx_decoder.c:174).  Must be called after dec_init and
    before the first decode."""
    if ctx is None or cb_get is None or cb_release is None:
        return VPX_CODEC_INVALID_PARAM
    if ctx.iface is None or ctx._dec is None:
        return VPX_CODEC_ERROR
    if ctx._frames or ctx._last is not None:
        return VPX_CODEC_ERROR  # after decoding started
    ctx._fb_get = cb_get
    ctx._fb_release = cb_release
    ctx._fb_priv = cb_priv
    return VPX_CODEC_OK


def vpx_codec_release_frame_buffers(ctx: CodecCtx) -> None:
    """Release every outstanding external frame buffer (decoder
    teardown; vpx_codec_destroy analog for external FBs)."""
    if ctx is None or ctx._fb_release is None:
        return
    for fb in ctx._ext_fbs:
        ctx._fb_release(ctx._fb_priv, fb)
    ctx._ext_fbs = []


def vpx_codec_peek_stream_info(iface, data: bytes,
                               si: StreamInfo) -> int:
    """vpx_codec_peek_stream_info parity: parse enough of the uncompressed
    header to report dimensions/keyframe without decoding
    (vp9/vp9_dx_iface.c decoder_peek_si_internal)."""
    from ..decoder.bitreader import BitReader, parse_superframe_index
    try:
        frames = parse_superframe_index(data)
        off, sz = frames[0]
        r = BitReader(data[off:off + sz])
        if r.read_literal(2) != 2:  # frame marker
            return VPX_CODEC_UNSUP_BITSTREAM
        profile = r.read_bit()
        profile |= r.read_bit() << 1
        if profile > 2:
            profile += r.read_bit()
        if r.read_bit():  # show_existing_frame
            si.is_kf = 0
            return VPX_CODEC_OK
        frame_type = r.read_bit()
        show_frame = r.read_bit()
        error_resilient = r.read_bit()
        si.is_kf = 1 if frame_type == 0 else 0

        def _skip_bitdepth_colorspace():
            if profile >= 2:
                r.read_bit()  # ten_or_twelve
            cs = r.read_literal(3)
            if cs != 7:  # != SRGB
                r.read_bit()  # color range
                if profile in (1, 3):
                    r.read_literal(3)
            else:
                if profile in (1, 3):
                    r.read_bit()

        if frame_type == 0:  # key frame
            if r.read_literal(24) != 0x498342:
                return VPX_CODEC_UNSUP_BITSTREAM
            _skip_bitdepth_colorspace()
            si.w = r.read_literal(16) + 1
            si.h = r.read_literal(16) + 1
        else:
            # intra-only branch of decoder_peek_si_internal
            # (vp9/vp9_dx_iface.c:141-170): non-shown intra frames carry a
            # sync code, optional bitdepth/colorspace, refresh flags and a
            # frame size.
            intra_only = 0 if show_frame else r.read_bit()
            if not error_resilient:
                r.read_literal(2)  # reset_frame_context
            if intra_only:
                if r.read_literal(24) != 0x498342:
                    return VPX_CODEC_UNSUP_BITSTREAM
                if profile > 0:
                    _skip_bitdepth_colorspace()
                r.read_literal(8)  # refresh_frame_flags
                si.w = r.read_literal(16) + 1
                si.h = r.read_literal(16) + 1
        return VPX_CODEC_OK
    except Exception:
        return VPX_CODEC_UNSUP_BITSTREAM


def vpx_codec_get_stream_info(ctx: CodecCtx, si: StreamInfo) -> int:
    if ctx is None or ctx._dec is None:
        return VPX_CODEC_INVALID_PARAM
    last = ctx._last
    if last is not None:
        si.w, si.h = last.d_w, last.d_h
    return VPX_CODEC_OK


def _vp9_ref_planes(rb):
    """Materialized visible-dim plane views + chroma dims of a
    RefBuffer."""
    import numpy as np
    cw = (rb.width + rb.ss_x) >> rb.ss_x
    chh = (rb.height + rb.ss_y) >> rb.ss_y
    planes = [np.asarray(p) for p in rb.planes]
    return planes, cw, chh


def _ctrl_set_reference(ctx, rf) -> int:
    """VP8_SET_REFERENCE (vp9_set_reference_dec / vp8dx_set_reference):
    overwrite the LAST/GOLDEN/ALTREF reference BUFFER in place — every
    ref-map slot sharing that buffer sees the new pixels, matching the
    reference's ref-counted frame pool."""
    import numpy as np
    if rf is None or rf.planes is None:
        return VPX_CODEC_INVALID_PARAM
    dec = ctx._dec
    if hasattr(dec, "ref_slots"):                      # VP9
        # encoder convention lst/gld/alt = map slots 0/1/2
        # (vp9_set_reference_dec:287-306)
        slot = {VP8_LAST_FRAME: 0, VP8_GOLD_FRAME: 1,
                VP8_ALTR_FRAME: 2}.get(rf.frame_type)
        if slot is None:
            return VPX_CODEC_ERROR
        rb = dec.ref_slots[slot]
        if rb is None:
            return VPX_CODEC_ERROR
        y, u, v = (np.asarray(p) for p in rf.planes)
        planes, cw, chh = _vp9_ref_planes(rb)
        if y.shape != (rb.height, rb.width) \
                or u.shape != (chh, cw) or v.shape != (chh, cw):
            return VPX_CODEC_ERROR  # "Incorrect buffer dimensions"
        planes[0][:rb.height, :rb.width] = y
        planes[1][:chh, :cw] = u
        planes[2][:chh, :cw] = v
        rb.planes = planes
        # device pool slots holding this buffer are stale
        recon = ctx._recon
        if recon is not None and hasattr(recon, "_slot_dirty"):
            for i, s in enumerate(dec.ref_slots):
                if s is rb:
                    recon._slot_dirty[i] = True
        return VPX_CODEC_OK
    d8 = getattr(dec, "_dec", None)
    if d8 is not None and hasattr(d8, "refs"):         # VP8
        from ..vp8.decoder import (LAST, GOLDEN, ALTREF, BY, BC,
                                   Vp8Decoder)
        key = {VP8_LAST_FRAME: LAST, VP8_GOLD_FRAME: GOLDEN,
               VP8_ALTR_FRAME: ALTREF}.get(rf.frame_type)
        if key is None:
            return VPX_CODEC_ERROR
        buf = d8.refs.get(key)
        if buf is None:
            return VPX_CODEC_ERROR
        w, h = d8.hdr.width, d8.hdr.height
        cw, chh = (w + 1) >> 1, (h + 1) >> 1
        y, u, v = (np.asarray(p) for p in rf.planes)
        if y.shape != (h, w) or u.shape != (chh, cw) \
                or v.shape != (chh, cw):
            return VPX_CODEC_ERROR
        Y, U, V = buf
        Y[BY:BY + h, BY:BY + w] = y
        U[BC:BC + chh, BC:BC + cw] = u
        V[BC:BC + chh, BC:BC + cw] = v
        # re-extend borders (MC reads the pre-extended apron)
        Vp8Decoder._extend_borders(Y, U, V, d8.mb_cols * 16,
                                   d8.mb_rows * 16)
        return VPX_CODEC_OK
    return VPX_CODEC_INCAPABLE


def _ctrl_copy_reference(ctx, rf) -> int:
    """VP8_COPY_REFERENCE (vp9_copy_reference_dec:258-285): copy the
    current frame's LAST reference out (VP9 supports LAST only, like
    the reference; VP8 copies any of the three)."""
    import numpy as np
    if rf is None:
        return VPX_CODEC_INVALID_PARAM
    dec = ctx._dec
    if hasattr(dec, "ref_slots"):                      # VP9
        if rf.frame_type != VP8_LAST_FRAME:
            return VPX_CODEC_ERROR  # "Invalid reference frame"
        rb = getattr(dec, "last_ref_buf", None)
        if rb is None:
            return VPX_CODEC_ERROR  # "No 'last' reference frame"
        planes, cw, chh = _vp9_ref_planes(rb)
        rf.planes = [planes[0][:rb.height, :rb.width].copy(),
                     planes[1][:chh, :cw].copy(),
                     planes[2][:chh, :cw].copy()]
        return VPX_CODEC_OK
    d8 = getattr(dec, "_dec", None)
    if d8 is not None and hasattr(d8, "refs"):         # VP8
        from ..vp8.decoder import LAST, GOLDEN, ALTREF, BY, BC
        key = {VP8_LAST_FRAME: LAST, VP8_GOLD_FRAME: GOLDEN,
               VP8_ALTR_FRAME: ALTREF}.get(rf.frame_type)
        if key is None:
            return VPX_CODEC_ERROR
        buf = d8.refs.get(key)
        if buf is None:
            return VPX_CODEC_ERROR
        w, h = d8.hdr.width, d8.hdr.height
        cw, chh = (w + 1) >> 1, (h + 1) >> 1
        Y, U, V = buf
        rf.planes = [Y[BY:BY + h, BY:BY + w].copy(),
                     U[BC:BC + chh, BC:BC + cw].copy(),
                     V[BC:BC + chh, BC:BC + cw].copy()]
        return VPX_CODEC_OK
    return VPX_CODEC_INCAPABLE


def _ctrl_get_reference(ctx, rf) -> int:
    """VP9_GET_REFERENCE (ctrl_get_reference:472-487): the last SHOWN
    frame's buffer."""
    if rf is None:
        return VPX_CODEC_INVALID_PARAM
    last = ctx._last
    if last is None:
        return VPX_CODEC_ERROR
    rf.planes = list(last.planes)
    return VPX_CODEC_OK


def vpx_codec_control(ctx: CodecCtx, ctrl_id: int, *args):
    """vpx_codec_control_ parity for the decoder-control set
    (vpx/vp8dx.h:63-201 + the vpx/vp8.h common ids)."""
    if ctx is None:
        return VPX_CODEC_INVALID_PARAM
    if ctrl_id == VP8_SET_REFERENCE:
        return _ctrl_set_reference(ctx, args[0] if args else None)
    if ctrl_id == VP8_COPY_REFERENCE:
        return _ctrl_copy_reference(ctx, args[0] if args else None)
    if ctrl_id == VP9_GET_REFERENCE:
        return _ctrl_get_reference(ctx, args[0] if args else None)
    if ctrl_id == VP8_SET_POSTPROC:
        # VP8 only; VP9 is built without postproc in the reference
        # (vpx_config.h CONFIG_VP9_POSTPROC=0)
        dec = ctx._dec
        if not hasattr(dec, "postproc_cfg"):
            return VPX_CODEC_INCAPABLE
        cfg = args[0] if args else None
        if cfg is None:
            return VPX_CODEC_INVALID_PARAM
        dec.postproc_cfg = (cfg.post_proc_flag, cfg.deblocking_level,
                            cfg.noise_level)
        return VPX_CODEC_OK
    if ctrl_id == VP8D_GET_FRAME_CORRUPTED:
        return ctx._corrupted
    if ctrl_id == VPXD_GET_LAST_QUANTIZER:
        return int(getattr(ctx._dec, "last_qindex", 0))
    if ctrl_id == VP8D_GET_LAST_REF_UPDATES:
        return int(getattr(ctx._dec, "last_ref_updates", 0))
    if ctrl_id == VP8D_GET_LAST_REF_USED:
        return int(getattr(ctx._dec, "last_ref_used", 0))
    if ctrl_id == VP9D_GET_BIT_DEPTH:
        return ctx._last.bit_depth if ctx._last else 8
    if ctrl_id in (VP9D_GET_DISPLAY_SIZE, VP9D_GET_FRAME_SIZE):
        return (ctx._last.d_w, ctx._last.d_h) if ctx._last else (0, 0)
    if ctrl_id == VP9_SET_SKIP_LOOP_FILTER:
        if hasattr(ctx._dec, "skip_loop_filter"):
            ctx._dec.skip_loop_filter = bool(args[0]) if args else True
            return VPX_CODEC_OK
        return VPX_CODEC_INCAPABLE
    if ctrl_id == VP9_SET_BYTE_ALIGNMENT:
        # legal values: 0 (default) or powers of two in [32, 1024]
        v = args[0] if args else 0
        if v != 0 and (v < 32 or v > 1024 or (v & (v - 1))):
            return VPX_CODEC_INVALID_PARAM
        return VPX_CODEC_OK  # numpy planes are always contiguous
    if ctrl_id == VP9_INVERT_TILE_DECODE_ORDER:
        # tiles are independent entropy streams; parse order cannot
        # change output (the control exists to test that invariant)
        return VPX_CODEC_OK
    if ctrl_id == VPXD_SET_DECRYPTOR:
        if not args or args[0] is None:
            ctx._decrypt = None
        else:
            cb = args[0]
            state = args[1] if len(args) > 1 else None
            ctx._decrypt = (cb, state)
        return VPX_CODEC_OK
    if ctrl_id == VP9_DECODE_SVC_SPATIAL_LAYER:
        layer = args[0] if args else -1
        if layer < 0:
            return VPX_CODEC_INVALID_PARAM
        ctx._svc_layer = layer
        return VPX_CODEC_OK
    if ctrl_id == VP9D_GET_FRAME_HEADER_INFO:
        # (uncompressed, compressed) header byte sizes of the last frame
        return getattr(ctx._dec, "last_header_sizes", (0, 0))
    if ctrl_id in (VP9D_SET_ROW_MT, VP9D_SET_LOOP_FILTER_OPT):
        return VPX_CODEC_OK  # scheduling hints: device path decides
    if ctrl_id == VP9D_GET_TILE_DATA:
        # per-tile (byte_offset, size) spans of the last frame's payload
        # (the reference's libvpx v1.9 predates this control; provided
        # for tile-inspection tooling)
        td = getattr(ctx._dec, "last_tile_data", None)
        if td is None:
            return VPX_CODEC_ERROR
        return td
    return VPX_CODEC_INCAPABLE


def vpx_codec_destroy(ctx: CodecCtx) -> int:
    if ctx is None:
        return VPX_CODEC_INVALID_PARAM
    ctx._dec = None
    ctx._frames = []
    return VPX_CODEC_OK


def vpx_codec_error(ctx: CodecCtx) -> str:
    return {VPX_CODEC_OK: "Success",
            VPX_CODEC_CORRUPT_FRAME: "Corrupt frame detected",
            VPX_CODEC_UNSUP_BITSTREAM:
                "Bitstream not supported by this decoder",
            }.get(ctx.err, f"error {ctx.err}")


def vpx_codec_error_detail(ctx: CodecCtx) -> str:
    return ctx.err_detail
