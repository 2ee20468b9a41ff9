"""VP9 uncompressed frame header parsing.

Parity with `read_uncompressed_header` and its helpers in the reference
(`vp9/decoder/vp9_decodeframe.c:3114`, `setup_segmentation:1560`,
`setup_loopfilter:1610`, `setup_quantization:1640`, `setup_frame_size:1743`,
`setup_tile_info:1857`, `read_bitdepth_colorspace_sampling:3054`), written
from the normative VP9 frame-header syntax.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import constants as C
from .bitreader import BitReader


class BitstreamError(ValueError):
    pass


@dataclass
class LoopFilterParams:
    filter_level: int = 0
    sharpness_level: int = 0
    mode_ref_delta_enabled: int = 1
    mode_ref_delta_update: int = 0
    ref_deltas: list = field(default_factory=lambda: [1, 0, -1, -1])
    mode_deltas: list = field(default_factory=lambda: [0, 0])


@dataclass
class SegmentationParams:
    enabled: int = 0
    update_map: int = 0
    temporal_update: int = 0
    abs_delta: int = 0
    tree_probs: list = field(default_factory=lambda: [255] * 7)
    pred_probs: list = field(default_factory=lambda: [255] * 3)
    feature_enabled: list = field(
        default_factory=lambda: [[0] * C.SEG_LVL_MAX
                                 for _ in range(C.MAX_SEGMENTS)])
    feature_data: list = field(
        default_factory=lambda: [[0] * C.SEG_LVL_MAX
                                 for _ in range(C.MAX_SEGMENTS)])

    def active(self, seg_id: int, feature: int) -> bool:
        return bool(self.enabled and self.feature_enabled[seg_id][feature])

    def data(self, seg_id: int, feature: int) -> int:
        return self.feature_data[seg_id][feature]


@dataclass
class FrameHeader:
    profile: int = 0
    show_existing_frame: int = 0
    frame_to_show: int = -1
    frame_type: int = C.KEY_FRAME
    show_frame: int = 1
    error_resilient_mode: int = 0
    intra_only: int = 0
    reset_frame_context: int = 0
    bit_depth: int = 8
    color_space: int = C.CS_BT_601
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    refresh_frame_flags: int = 0
    ref_frame_idx: list = field(default_factory=lambda: [0, 0, 0])
    ref_frame_sign_bias: list = field(default_factory=lambda: [0, 0, 0, 0])
    allow_high_precision_mv: int = 0
    interp_filter: int = C.SWITCHABLE
    refresh_frame_context: int = 0
    frame_parallel_decoding_mode: int = 1
    frame_context_idx: int = 0
    lf: LoopFilterParams = field(default_factory=LoopFilterParams)
    base_qindex: int = 0
    y_dc_delta_q: int = 0
    uv_dc_delta_q: int = 0
    uv_ac_delta_q: int = 0
    lossless: int = 0
    seg: SegmentationParams = field(default_factory=SegmentationParams)
    log2_tile_cols: int = 0
    log2_tile_rows: int = 0
    header_size_in_bytes: int = 0
    uncompressed_header_size_in_bytes: int = 0
    # derived geometry
    mi_cols: int = 0
    mi_rows: int = 0
    sb_cols: int = 0
    sb_rows: int = 0

    @property
    def is_key(self) -> bool:
        return self.frame_type == C.KEY_FRAME

    @property
    def frame_is_intra_only(self) -> bool:
        return self.is_key or bool(self.intra_only)

    def compute_geometry(self):
        self.mi_cols = (self.width + 7) >> C.MI_SIZE_LOG2
        self.mi_rows = (self.height + 7) >> C.MI_SIZE_LOG2
        self.sb_cols = (self.mi_cols + C.MI_BLOCK_SIZE - 1) >> \
            C.MI_BLOCK_SIZE_LOG2
        self.sb_rows = (self.mi_rows + C.MI_BLOCK_SIZE - 1) >> \
            C.MI_BLOCK_SIZE_LOG2


def _read_bitdepth_colorspace_sampling(rb: BitReader, hdr: FrameHeader):
    if hdr.profile >= 2:
        hdr.bit_depth = 12 if rb.read_bit() else 10
    else:
        hdr.bit_depth = 8
    hdr.color_space = rb.f(3)
    if hdr.color_space != C.CS_SRGB:
        hdr.color_range = rb.read_bit()
        if hdr.profile in (1, 3):
            hdr.subsampling_x = rb.read_bit()
            hdr.subsampling_y = rb.read_bit()
            if rb.read_bit():
                raise BitstreamError("reserved bit set")
        else:
            hdr.subsampling_x = hdr.subsampling_y = 1
    else:
        hdr.color_range = 1
        if hdr.profile in (1, 3):
            hdr.subsampling_x = hdr.subsampling_y = 0
            if rb.read_bit():
                raise BitstreamError("reserved bit set")
        else:
            raise BitstreamError("4:2:0 not supported in profile for sRGB")


def _read_frame_size(rb: BitReader):
    width = rb.f(16) + 1
    height = rb.f(16) + 1
    return width, height


def _read_render_size(rb: BitReader, hdr: FrameHeader):
    if rb.read_bit():
        hdr.render_width = rb.f(16) + 1
        hdr.render_height = rb.f(16) + 1
    else:
        hdr.render_width = hdr.width
        hdr.render_height = hdr.height


def _check_sync_code(rb: BitReader):
    if (rb.f(8), rb.f(8), rb.f(8)) != C.VP9_SYNC_CODE:
        raise BitstreamError("invalid frame sync code")


def _read_interp_filter(rb: BitReader) -> int:
    if rb.read_bit():
        return C.SWITCHABLE
    return C.LITERAL_TO_FILTER_MAP[rb.f(2)]


def _setup_loopfilter(rb: BitReader, lf: LoopFilterParams):
    lf.filter_level = rb.f(6)
    lf.sharpness_level = rb.f(3)
    lf.mode_ref_delta_update = 0
    lf.mode_ref_delta_enabled = rb.read_bit()
    if lf.mode_ref_delta_enabled:
        lf.mode_ref_delta_update = rb.read_bit()
        if lf.mode_ref_delta_update:
            for i in range(C.MAX_REF_LF_DELTAS):
                if rb.read_bit():
                    lf.ref_deltas[i] = rb.sf(6)
            for i in range(C.MAX_MODE_LF_DELTAS):
                if rb.read_bit():
                    lf.mode_deltas[i] = rb.sf(6)


def _read_delta_q(rb: BitReader) -> int:
    return rb.sf(4) if rb.read_bit() else 0


def _setup_quantization(rb: BitReader, hdr: FrameHeader):
    hdr.base_qindex = rb.f(8)
    hdr.y_dc_delta_q = _read_delta_q(rb)
    hdr.uv_dc_delta_q = _read_delta_q(rb)
    hdr.uv_ac_delta_q = _read_delta_q(rb)
    hdr.lossless = int(hdr.base_qindex == 0 and hdr.y_dc_delta_q == 0
                       and hdr.uv_dc_delta_q == 0 and hdr.uv_ac_delta_q == 0)
    # NOTE: lossless is FRAME-level here, matching the reference exactly
    # (vp9_decodeframe.c:1647 sets xd->lossless from base_qindex/deltas
    # only; libvpx v1.9 has no per-segment lossless).  The encoder
    # clamps segment ALT_Q deltas so no segment reaches qindex 0.


_SEG_FEATURE_BITS = [8, 6, 2, 0]


def _setup_segmentation(rb: BitReader, seg: SegmentationParams):
    seg.update_map = 0
    seg.temporal_update = 0
    seg.enabled = rb.read_bit()
    if not seg.enabled:
        return
    seg.update_map = rb.read_bit()
    if seg.update_map:
        seg.tree_probs = [rb.f(8) if rb.read_bit() else 255
                          for _ in range(C.SEG_TREE_PROBS)]
        seg.temporal_update = rb.read_bit()
        if seg.temporal_update:
            seg.pred_probs = [rb.f(8) if rb.read_bit() else 255
                              for _ in range(C.PREDICTION_PROBS)]
        else:
            seg.pred_probs = [255] * C.PREDICTION_PROBS
    if rb.read_bit():  # update_data
        seg.abs_delta = rb.read_bit()
        for i in range(C.MAX_SEGMENTS):
            for j in range(C.SEG_LVL_MAX):
                data = 0
                enabled = rb.read_bit()
                seg.feature_enabled[i][j] = enabled
                if enabled:
                    bits = _SEG_FEATURE_BITS[j]
                    if bits:
                        data = rb.f(bits)
                        data = min(data, C.SEG_FEATURE_DATA_MAX[j])
                    if C.SEG_FEATURE_DATA_SIGNED[j] and rb.read_bit():
                        data = -data
                seg.feature_data[i][j] = data


def _get_min_log2_tile_cols(sb64_cols: int) -> int:
    v = 0
    while (C.MAX_TILE_WIDTH_B64 << v) < sb64_cols:
        v += 1
    return v


def _get_max_log2_tile_cols(sb64_cols: int) -> int:
    v = 1
    while (sb64_cols >> v) >= C.MIN_TILE_WIDTH_B64:
        v += 1
    return v - 1


def _setup_tile_info(rb: BitReader, hdr: FrameHeader):
    sb64_cols = hdr.sb_cols
    min_log2 = _get_min_log2_tile_cols(sb64_cols)
    max_log2 = _get_max_log2_tile_cols(sb64_cols)
    log2 = min_log2
    while log2 < max_log2:
        if rb.read_bit():
            log2 += 1
        else:
            break
    hdr.log2_tile_cols = log2
    hdr.log2_tile_rows = rb.read_bit()
    if hdr.log2_tile_rows:
        hdr.log2_tile_rows += rb.read_bit()


def parse_uncompressed_header(data: bytes, ref_sizes=None,
                              dec_ctx=None) -> FrameHeader:
    """Parse the frame's uncompressed header.

    `ref_sizes` is a callable idx -> (width, height) over the decoder's
    8-slot reference pool (for size-from-refs resolution); may be None when
    only peeking stream info.

    `dec_ctx`, when given, supplies decoder-persistent state: `.lf` and
    `.seg` (loop-filter deltas and segmentation features persist across
    frames, vp9/common/vp9_entropymode.c:425) and an
    `.on_past_independence(hdr)` hook invoked at the normative point
    (vp9_decodeframe.c:3293) for intra-only / error-resilient frames.
    """
    rb = BitReader(data)
    hdr = FrameHeader()
    if dec_ctx is not None:
        hdr.lf = dec_ctx.lf
        hdr.seg = dec_ctx.seg
    if rb.f(2) != C.VP9_FRAME_MARKER:
        raise BitstreamError("bad frame marker")
    hdr.profile = rb.read_bit() | (rb.read_bit() << 1)
    if hdr.profile > 2:
        hdr.profile += rb.read_bit()
    if hdr.profile > 3:
        raise BitstreamError("unsupported profile")

    hdr.show_existing_frame = rb.read_bit()
    if hdr.show_existing_frame:
        hdr.frame_to_show = rb.f(3)
        hdr.refresh_frame_flags = 0
        hdr.lf.filter_level = 0
        hdr.uncompressed_header_size_in_bytes = rb.byte_offset()
        return hdr

    hdr.frame_type = rb.read_bit()
    hdr.show_frame = rb.read_bit()
    hdr.error_resilient_mode = rb.read_bit()

    if hdr.frame_type == C.KEY_FRAME:
        _check_sync_code(rb)
        _read_bitdepth_colorspace_sampling(rb, hdr)
        hdr.refresh_frame_flags = (1 << C.REF_FRAMES) - 1
        hdr.width, hdr.height = _read_frame_size(rb)
        _read_render_size(rb, hdr)
    else:
        hdr.intra_only = rb.read_bit() if not hdr.show_frame else 0
        hdr.reset_frame_context = 0 if hdr.error_resilient_mode else rb.f(2)
        if hdr.intra_only:
            _check_sync_code(rb)
            if hdr.profile > 0:
                _read_bitdepth_colorspace_sampling(rb, hdr)
            else:
                hdr.bit_depth = 8
                hdr.color_space = C.CS_BT_601
                hdr.subsampling_x = hdr.subsampling_y = 1
            hdr.refresh_frame_flags = rb.f(8)
            hdr.width, hdr.height = _read_frame_size(rb)
            _read_render_size(rb, hdr)
        else:
            hdr.refresh_frame_flags = rb.f(8)
            for i in range(C.REFS_PER_FRAME):
                hdr.ref_frame_idx[i] = rb.f(C.REF_FRAMES_LOG2)
                hdr.ref_frame_sign_bias[C.LAST_FRAME + i] = rb.read_bit()
            # frame size with refs
            found = False
            for i in range(C.REFS_PER_FRAME):
                if rb.read_bit():
                    if ref_sizes is None:
                        raise BitstreamError(
                            "size-from-ref without reference state")
                    hdr.width, hdr.height = ref_sizes(hdr.ref_frame_idx[i])
                    found = True
                    break
            if not found:
                hdr.width, hdr.height = _read_frame_size(rb)
            if hdr.width <= 0 or hdr.height <= 0:
                raise BitstreamError("invalid frame size from refs")
            _read_render_size(rb, hdr)
            hdr.allow_high_precision_mv = rb.read_bit()
            hdr.interp_filter = _read_interp_filter(rb)

    if not hdr.error_resilient_mode:
        hdr.refresh_frame_context = rb.read_bit()
        hdr.frame_parallel_decoding_mode = rb.read_bit()
    else:
        hdr.refresh_frame_context = 0
        hdr.frame_parallel_decoding_mode = 1

    hdr.frame_context_idx = rb.f(C.FRAME_CONTEXTS_LOG2)
    hdr.compute_geometry()

    if hdr.frame_is_intra_only or hdr.error_resilient_mode:
        # vp9_setup_past_independence (vp9_entropymode.c:467) zeroes the
        # reference sign biases — an error-resilient frame can never
        # code compound prediction, and MV sign flips are disabled,
        # regardless of the sign-bias bits parsed above
        hdr.ref_frame_sign_bias = [0, 0, 0, 0]
        if dec_ctx is not None:
            dec_ctx.on_past_independence(hdr)
            hdr.frame_context_idx = 0

    _setup_loopfilter(rb, hdr.lf)
    _setup_quantization(rb, hdr)
    _setup_segmentation(rb, hdr.seg)
    _setup_tile_info(rb, hdr)
    hdr.header_size_in_bytes = rb.f(16)
    if rb.overrun():
        raise BitstreamError("truncated uncompressed header")
    hdr.uncompressed_header_size_in_bytes = rb.byte_offset()
    return hdr


def peek_stream_info(data: bytes):
    """vpx_codec_peek_stream_info parity: (width, height, is_key, profile)."""
    hdr = parse_uncompressed_header(data, ref_sizes=lambda i: (0, 0))
    return hdr.width, hdr.height, int(hdr.is_key), hdr.profile
