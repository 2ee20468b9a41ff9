"""VP9 encoder: normative bitstream writer with motion search, rate
control, segmentation, two-pass, SVC and high-bit-depth support.

Counterpart of the reference's vp9/encoder/ (SURVEY S19 — vp9_encoder.c,
vp9_bitstream.c `write_uncompressed_header`/`write_compressed_header`/
`pack_mb_tokens`, vp9_cx_iface.c).  Design (host NumPy, as the reference's encoder runs
on the CPU):

- keyframes (and every frame when gop <= 1) are intra-only with
  error_resilient_mode=1, so no backward adaptation and no
  frame-context bookkeeping is needed;
- with gop > 1, non-key frames are single-reference (LAST) inter
  frames: per block ZEROMV or a NEWMV found by diamond + subpel
  refinement (encoder/motion.py), with an intra fallback (full
  10-mode search) chosen by SAD; skip when the residual quantizes
  away;
- 1-pass and 2-pass rate control (first-pass stats drive per-frame bit
  allocation and scene-cut keyframes), segmentation (per-segment
  quantizers: ROI maps + variance AQ), lossless mode, 10/12-bit
  (profile 2), and spatial+temporal SVC (encoder/svc.py);
- a fixed partition grid (default 16x16 blocks, forced splits at frame
  edges) with per-block intra mode search over DC/V/H/TM by SAD;
- forward transforms derived from the repo's own normative inverse
  (encoder/transforms.py), quantization against the normative dequant
  tables, tokens written by the decode-tree mirror (encoder/tokenize.py);
- the in-loop reconstruction mirrors `ops/ref/recon` exactly (intra
  edges AND the full-pel edge-clamped ZEROMV prediction), so prediction
  feedback matches any conformant decoder, bit-for-bit;
- inter-frame symbol contexts (mode context, ref context, partition
  context) come from the DECODER'S own machinery
  (decoder.tiles.FrameParseState + decodemv/mvref helpers), so the
  writer cannot drift from the parse side;
- loop filter level is 0 (valid; the decoder then skips filtering).

This copy's packets are held byte for byte against the JAX package's
encoder, and its streams decode through the port (and the normative
libavcodec vp9 decoder) to the encoder's own reconstruction, frame by
frame (tests/test_torch_encoder.py).
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from ..decoder import constants as C
from .bitwriter import BitWriter, BoolEncoder, tree_paths
from . import tokenize
from .transforms import fwd_txfm2d, fwd_wht2d
from ..ops.ref import inter as inter_ops
from ..ops.ref import intra
from ..ops.ref import transforms as inv

_INTRA_MODE_TO_TX_TYPE = [C.DCT_DCT, C.ADST_DCT, C.DCT_ADST, C.DCT_DCT,
                          C.ADST_ADST, C.ADST_DCT, C.DCT_ADST, C.DCT_ADST,
                          C.ADST_DCT, C.ADST_ADST]

_PARTITION_PATHS = tree_paths(M.PARTITION_TREE)
_INTRA_MODE_PATHS = tree_paths(M.INTRA_MODE_TREE)
_INTER_MODE_PATHS = tree_paths(M.INTER_MODE_TREE)

# intra mode search candidates: the full normative set (S19 parity with
# vp9_rd_pick_intra_mode; the diagonal modes matter most on oriented
# texture).  Prediction + edge construction reuse the decoder's own
# machinery, so every candidate reconstructs bit-identically.
_MODE_CANDIDATES = (C.DC_PRED, C.V_PRED, C.H_PRED, C.TM_PRED,
                    C.D45_PRED, C.D135_PRED, C.D117_PRED, C.D153_PRED,
                    C.D207_PRED, C.D63_PRED)


class Vp9Encoder:
    """VP9 encoder (see the module docstring for the feature surface).

    gop<=1 (default): intra-only, every frame a keyframe.  gop>1: LAST-ref
    inter frames with motion search and 1-/2-pass rate control.  Profiles
    0 (8-bit 4:2:0) and 2 (10/12-bit 4:2:0).  `block_size` is the fixed
    coding block size (BLOCK_8X8 / 16X16 / 32X32 / 64X64).
    """

    def __init__(self, width: int, height: int, base_qindex: int = 60,
                 bit_depth: int = 8, block_size: int = C.BLOCK_16X16,
                 lossless: bool = False, mode_search: bool = True,
                 gop: int = 1, target_bitrate_kbps: int = 0,
                 fps: float = 30.0):
        if not (0 < width < 65536 and 0 < height < 65536):
            raise ValueError("bad frame size")
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.profile = 0 if bit_depth == 8 else 2
        self.lossless = lossless
        self.base_qindex = 0 if lossless else max(1, min(255, base_qindex))
        self.block_size = block_size
        self.mode_search = mode_search
        # gop <= 1: every frame a keyframe.  Lossless inter coding is
        # not implemented (tx_mode layout differs); force all-key.
        self.gop = 1 if lossless else max(1, gop)
        self.frame_idx = 0
        self._ref_recon = None   # previous frame's reconstruction
        # frame plumbing for layered (SVC) streams: which pool slot the
        # inter frames reference / refresh, whether frames are shown,
        # and an optional externally-supplied reference whose size may
        # differ from the frame (inter-layer prediction; the decoder
        # then runs scaled-reference MC, vp9_scale.c)
        self.show_frame = True
        self.ref_slot = 0
        self.refresh_slot = 0
        self._ext_ref = None     # (planes, (crop_w, crop_h)) or None
        # per-stream inter mode decisions (observability; the reference
        # tracks the same in cpi->mode_chosen_counts)
        self.mode_counts = {C.ZEROMV: 0, C.NEARESTMV: 0, C.NEARMV: 0,
                            C.NEWMV: 0, "intra": 0}

        self.mi_cols = (width + 7) >> C.MI_SIZE_LOG2
        self.mi_rows = (height + 7) >> C.MI_SIZE_LOG2
        self.sb_cols = (self.mi_cols + 7) >> 3
        self.sb_rows = (self.mi_rows + 7) >> 3

        # tile columns: the spec's minimum for this width
        sb64_cols = self.sb_cols
        log2 = 0
        while (C.MAX_TILE_WIDTH_B64 << log2) < sb64_cols:
            log2 += 1
        self.log2_tile_cols = log2
        max_log2 = 1
        while (sb64_cols >> max_log2) >= C.MIN_TILE_WIDTH_B64:
            max_log2 += 1
        self.max_log2_tile_cols = max_log2 - 1

        # one-pass rate control (vp9_ratectrl.c one-pass CBR analog):
        # a virtual buffer integrates (target - actual) bytes per frame
        # and nudges qindex each frame; 0 = fixed-QP
        self.target_bitrate_kbps = 0 if lossless else target_bitrate_kbps
        self.fps = fps
        self._rc_q = self.base_qindex
        self._rc_buffer = 0.0

        # segmentation (SEG_LVL_ALT_Q per-segment quantizers: ROI / AQ)
        self.seg_map = None          # [mi_rows, mi_cols] ids, or None
        self.seg_qdeltas = None      # requested per-segment q deltas
        self._seg_eff_deltas = None  # per-frame clamped deltas (coded)
        self._seg_dqs = None         # per-segment (dc, ac) dequant
        self._seg_tree_probs = [255] * 7
        from .bitwriter import tree_paths
        self._seg_paths = tree_paths(M.SEGMENT_TREE)

        self._set_frame_q(self.base_qindex)

        self.fc = M.FrameContext.default()
        self.coef_probs_list = self.fc.coef.tolist()
        self.skip_probs = self.fc.skip.tolist()
        self.kf_partition_probs = M.KF_PARTITION_PROBS.tolist()
        self.kf_y_probs = M.KF_Y_MODE_PROB.tolist()
        self.kf_uv_probs = M.KF_UV_MODE_PROB.tolist()
        self.scans = M.SCAN_ORDERS

    # ------------------------------------------------------------ frame

    def _set_frame_q(self, q: int) -> None:
        """Per-frame quantizer (normative dequant tables; deltas = 0)."""
        q = 0 if self.lossless else max(1, min(255, int(q)))
        self.base_qindex = q
        dcq = M.DC_QLOOKUP[self.bit_depth]
        acq = M.AC_QLOOKUP[self.bit_depth]
        self.dq_y = (int(dcq[q]), int(acq[q]))
        self.dq_uv = (int(dcq[q]), int(acq[q]))
        if self.seg_map is not None:
            # per-segment quantizers (vp9_get_qindex: base + ALT_Q delta
            # clamped to [0, 255]).  The coded delta is clamped so no
            # segment reaches qindex 0 — that would flip the segment to
            # lossless 4x4-WHT coding mid-frame (xd->lossless[seg])
            self._seg_eff_deltas = [
                max(1 - q, min(255 - q, int(d))) for d in self.seg_qdeltas]
            self._seg_dqs = [
                (int(dcq[q + d]), int(acq[q + d]))
                for d in self._seg_eff_deltas]

    def set_segmentation(self, seg_map, qindex_deltas) -> None:
        """Enable segmentation with per-segment qindex deltas
        (SEG_LVL_ALT_Q; setup_segmentation / vp9_get_qindex parity:
        ROI maps and the vpxenc variance-AQ mode ride this).

        seg_map: [mi_rows, mi_cols] segment ids 0-7 — each coded block
        takes the id at its top-left mi cell.  qindex_deltas: per-
        segment delta added to the frame's base qindex (clamped per
        frame so every segment stays in [1, 255]).  None disables."""
        if seg_map is None:
            self.seg_map = self.seg_qdeltas = None
            self._seg_dqs = self._seg_eff_deltas = None
            self._seg_tree_probs = [255] * 7
            return
        if self.lossless:
            raise ValueError("segmentation requires a lossy encode")
        m = np.asarray(seg_map)
        if m.shape != (self.mi_rows, self.mi_cols):
            raise ValueError(
                f"seg_map must be [{self.mi_rows}, {self.mi_cols}]")
        if m.min() < 0 or m.max() >= C.MAX_SEGMENTS:
            raise ValueError("segment ids must be 0-7")
        deltas = list(qindex_deltas)
        if len(deltas) < C.MAX_SEGMENTS:
            deltas += [0] * (C.MAX_SEGMENTS - len(deltas))
        self.seg_map = m.astype(np.int32)
        self.seg_qdeltas = deltas[:C.MAX_SEGMENTS]
        # tree probs from the id histogram (vp9_segmentation.c
        # choose_segmap_coding_method's get_binary_prob shape)
        counts = np.bincount(self.seg_map.reshape(-1),
                             minlength=C.MAX_SEGMENTS)
        probs = [255] * 7
        node_counts = {}
        for leaf in range(C.MAX_SEGMENTS):
            for node, bit in self._seg_paths[leaf]:
                c = node_counts.setdefault(node >> 1, [0, 0])
                c[bit] += int(counts[leaf])
        for idx, (c0, c1) in node_counts.items():
            if c0 + c1:
                probs[idx] = max(1, min(255,
                                        round(256 * c0 / (c0 + c1))))
        self._seg_tree_probs = probs
        self._set_frame_q(self.base_qindex)

    def _blk_dq(self, seg_id: int):
        """(dc, ac) dequant pair for a block in segment seg_id."""
        if self._seg_dqs is None:
            return self.dq_y
        return self._seg_dqs[seg_id]

    def _write_segmentation(self, wb) -> None:
        """Mirror of _setup_segmentation (decoder/headers.py:198)."""
        if self.seg_map is None:
            wb.write_bit(0)          # segmentation enabled
            return
        wb.write_bit(1)              # enabled
        wb.write_bit(1)              # update_map
        for p in self._seg_tree_probs:
            if p == 255:
                wb.write_bit(0)
            else:
                wb.write_bit(1)
                wb.f(p, 8)
        wb.write_bit(0)              # temporal_update
        wb.write_bit(1)              # update_data
        wb.write_bit(0)              # abs_delta: deltas vs base q
        for i in range(C.MAX_SEGMENTS):
            d = self._seg_eff_deltas[i]
            wb.write_bit(1)          # SEG_LVL_ALT_Q enabled
            wb.f(min(abs(d), 255), 8)
            wb.write_bit(1 if d < 0 else 0)
            wb.write_bit(0)          # SEG_LVL_ALT_LF
            wb.write_bit(0)          # SEG_LVL_REF_FRAME
            wb.write_bit(0)          # SEG_LVL_SKIP

    def _rc_frame_target(self, is_key: bool) -> float:
        """Per-frame byte budget.  The keyframe borrows from its GOP's
        inter frames so each GOP sums to gop * per-frame-target
        (vp9_ratectrl.c rc->this_frame_target shaping).  A two-pass
        driver overrides per frame via next_frame_target (the
        vp9_firstpass.c bit-allocation analog)."""
        if self.next_frame_target is not None:
            return self.next_frame_target
        base = self.target_bitrate_kbps * 1000.0 / 8.0 / self.fps
        if self.gop <= 1:
            return base
        boost = min(self.gop, 4)
        if is_key:
            return base * boost
        return base * (self.gop - boost) / (self.gop - 1)

    next_frame_target = None   # two-pass per-frame byte target

    def _rc_pre_frame(self, is_key: bool) -> None:
        """Pick this frame's qindex from the running rate-control state
        (one-pass CBR shape: vp9/encoder/vp9_ratectrl.c)."""
        if not self.target_bitrate_kbps:
            return
        q = self._rc_q
        if is_key:
            q = max(1, q - q // 8)   # quality boost for the GOP anchor
        self._set_frame_q(q)

    @staticmethod
    def _rc_qstep(actual: float, target: float, gain: float = 16.0,
                  bound: int = 24) -> int:
        """Proportional qindex correction: the quantizer tables are
        near-exponential in qindex (~2x per 24 steps), so the log2 of
        the byte-ratio maps directly to a qindex delta."""
        import math
        ratio = max(actual, 1.0) / max(target, 1.0)
        return max(-bound, min(bound, round(gain * math.log2(ratio))))

    def _rc_post_frame(self, nbytes: int, is_key: bool) -> None:
        if not self.target_bitrate_kbps:
            return
        target = self._rc_frame_target(is_key)
        # integrate drift (clamped: old debt must not cause windup)
        self._rc_buffer += target - nbytes
        self._rc_buffer = max(-8.0 * target, min(8.0 * target,
                                                 self._rc_buffer))
        q = self._rc_q + self._rc_qstep(nbytes, target)
        # small integral trim against accumulated drift
        q -= max(-8, min(8, int(self._rc_buffer / max(target, 1.0) * 2)))
        self._rc_q = max(1, min(255, q))

    def set_reference(self, planes, crop_dims) -> None:
        """Supply the next frame's prediction reference explicitly
        (SVC inter-layer prediction).  `planes` are mi-aligned recon
        planes; `crop_dims` the reference's visible (w, h).  When the
        size differs from this encoder's frame size the blocks are
        coded ZEROMV-vs-intra with vpx_scaled_2d-parity prediction."""
        self._ext_ref = (planes, crop_dims)

    def encode_frame(self, planes, force_key=None) -> bytes:
        """Encode [y, u, v] planes (uint8/uint16, crop dims).

        Keyframe when the GOP says so (or gop <= 1), else a
        single-reference inter frame predicting from the previous
        frame's reconstruction (or the reference set with
        set_reference)."""
        is_key = (self.frame_idx % self.gop == 0
                  or (self._ref_recon is None and self._ext_ref is None))
        if force_key is not None:
            is_key = force_key
        self._rc_pre_frame(is_key)
        target = self._rc_frame_target(is_key)
        for attempt in range(4):
            st = _FrameState(self, planes)
            if is_key:
                tile_data = self._encode_tiles(st)
                comp = self._compressed_header()
                unc = self._uncompressed_header(len(comp))
            else:
                tile_data = self._encode_inter_tiles(st)
                from .interframe import _compressed_header_inter
                comp = _compressed_header_inter()
                unc = self._uncompressed_header_inter(len(comp))
            out = unc + comp + tile_data
            # recode loop (vp9_encoder.c recode_loop_test): a frame that
            # badly overshoots its target is re-encoded at a corrected q
            thresh = 1.3 if is_key else 1.75
            if not self.target_bitrate_kbps or attempt == 3 \
                    or len(out) <= thresh * target \
                    or self.base_qindex >= 255:
                break
            self._set_frame_q(self.base_qindex
                              + max(8, self._rc_qstep(len(out), target,
                                                      gain=24, bound=64)))
        self._last_recon = st.recon  # in-loop reconstruction (PSNR probes)
        self._ref_recon = [p.copy() for p in st.recon]
        self._ext_ref = None         # consumed (one frame)
        self.frame_idx += 1
        self._rc_q = self.base_qindex if self.target_bitrate_kbps \
            and not is_key else self._rc_q
        self._rc_post_frame(len(out), is_key)
        self.next_frame_target = None    # two-pass override: one frame
        return out

    _last_recon = None

    # ----------------------------------------------------------- headers

    def _uncompressed_header(self, comp_size: int) -> bytes:
        """Mirror of parse_uncompressed_header (decoder/headers.py:261)."""
        wb = BitWriter()
        wb.f(C.VP9_FRAME_MARKER, 2)
        wb.write_bit(self.profile & 1)
        wb.write_bit((self.profile >> 1) & 1)
        wb.write_bit(0)              # show_existing_frame
        wb.write_bit(C.KEY_FRAME)    # frame_type
        wb.write_bit(1 if self.show_frame else 0)
        wb.write_bit(1)              # error_resilient_mode
        for b in C.VP9_SYNC_CODE:
            wb.f(b, 8)
        if self.profile >= 2:
            wb.write_bit(0 if self.bit_depth == 10 else 1)
        wb.f(C.CS_BT_601, 3)         # color_space
        wb.write_bit(0)              # color_range (studio)
        # profile 0/2: 4:2:0 implied, no subsampling bits
        wb.f(self.width - 1, 16)
        wb.f(self.height - 1, 16)
        wb.write_bit(0)              # render size == frame size
        # error_resilient: no refresh_frame_context/frame_parallel bits
        wb.f(0, C.FRAME_CONTEXTS_LOG2)  # frame_context_idx
        # loop filter: level 0 (decoder skips filtering)
        wb.f(0, 6)                   # filter_level
        wb.f(0, 3)                   # sharpness
        wb.write_bit(0)              # mode_ref_delta_enabled
        # quantization
        wb.f(self.base_qindex, 8)
        wb.write_bit(0)              # y_dc_delta_q
        wb.write_bit(0)              # uv_dc_delta_q
        wb.write_bit(0)              # uv_ac_delta_q
        self._write_segmentation(wb)
        # tile info: unary-ish increment bits from min to chosen (== min)
        if self.log2_tile_cols < self.max_log2_tile_cols:
            wb.write_bit(0)          # stop at min_log2_tile_cols
        wb.write_bit(0)              # log2_tile_rows = 0
        wb.f(comp_size, 16)          # first partition size
        return wb.data()

    def _compressed_header(self) -> bytes:
        """Keyframe compressed header with zero probability updates
        (mirror of read_compressed_header, decoder/compressed_header.py)."""
        w = BoolEncoder()
        if not self.lossless:
            w.write_literal(C.ALLOW_32X32, 2)
            w.write_bit(0)           # not TX_MODE_SELECT
        # coef prob update flags: one bit per tx size <= biggest tx
        n_tx = 1 if self.lossless else (C.TX_32X32 + 1)
        for _ in range(n_tx):
            w.write_bit(0)
        for _ in range(C.SKIP_CONTEXTS):
            w.write(0, C.DIFF_UPDATE_PROB)
        return w.stop()

    # ------------------------------------------------- inter frames

    def _uncompressed_header_inter(self, comp_size: int) -> bytes:
        """Non-key error-resilient inter header (single ref, slot 0,
        refresh slot 0; mirror of parse_uncompressed_header)."""
        wb = BitWriter()
        wb.f(C.VP9_FRAME_MARKER, 2)
        wb.write_bit(self.profile & 1)
        wb.write_bit((self.profile >> 1) & 1)
        wb.write_bit(0)              # show_existing_frame
        wb.write_bit(1)              # frame_type: non-key
        wb.write_bit(1 if self.show_frame else 0)
        wb.write_bit(1)              # error_resilient_mode
        if not self.show_frame:
            wb.write_bit(0)          # intra_only = 0 (coded only when
            #                          the frame is not shown)
        # refresh_frame_flags (refresh_slot None = refresh nothing:
        # temporal-layer frames that no later frame references)
        wb.f(0 if self.refresh_slot is None else 1 << self.refresh_slot,
             8)
        for _ in range(C.REFS_PER_FRAME):
            wb.f(self.ref_slot, C.REF_FRAMES_LOG2)
            wb.write_bit(0)              # sign bias
        for _ in range(C.REFS_PER_FRAME):
            wb.write_bit(0)              # size NOT taken from this ref
        wb.f(self.width - 1, 16)
        wb.f(self.height - 1, 16)
        wb.write_bit(0)              # render == frame size
        wb.write_bit(0)              # allow_high_precision_mv
        wb.write_bit(0)              # interp filter: literal follows
        wb.f(0, 2)                   # EIGHTTAP
        # error_resilient: no refresh_frame_context / frame_parallel
        wb.f(0, C.FRAME_CONTEXTS_LOG2)
        wb.f(0, 6)                   # lf filter_level
        wb.f(0, 3)                   # lf sharpness
        wb.write_bit(0)              # mode_ref_delta_enabled
        wb.f(self.base_qindex, 8)
        wb.write_bit(0)              # y_dc_delta_q
        wb.write_bit(0)              # uv_dc_delta_q
        wb.write_bit(0)              # uv_ac_delta_q
        self._write_segmentation(wb)
        if self.log2_tile_cols < self.max_log2_tile_cols:
            wb.write_bit(0)
        wb.write_bit(0)              # log2_tile_rows
        wb.f(comp_size, 16)
        return wb.data()

    # ------------------------------------------- intra-only frames

    def encode_intra_only_frame(self, planes, refresh_flags: int = 0xFF,
                                error_resilient: bool = True,
                                reset_frame_context: int = 0,
                                frame_context_idx: int = 0) -> bytes:
        """Hidden intra-only frame: frame_type=non-key, show_frame=0,
        intra_only=1 (vp9_decodeframe.c:3182-3213).  Intra-only frames
        use the keyframe mode syntax (frame_is_intra_only selects
        read_intra_frame_mode_info for both), so the keyframe tile coder
        is reused verbatim; only the uncompressed header differs.  The
        frame is not shown — pair with write_show_existing() to display
        it.  Non-error-resilient variants exercise the decoder's
        reset_frame_context semantics (vp9_entropymode.c:440-469); every
        saved context a stream from this encoder can reach holds the
        defaults (refresh_frame_context is never set), so any reset
        value stays consistent with coding against default probs."""
        st = _FrameState(self, planes)
        tile_data = self._encode_tiles(st)
        comp = self._compressed_header()
        unc = self._uncompressed_header_intra_only(
            len(comp), refresh_flags, error_resilient,
            reset_frame_context, frame_context_idx)
        self._last_recon = st.recon
        if refresh_flags & (1 << self.ref_slot):
            self._ref_recon = [p.copy() for p in st.recon]
            self._ext_ref = None
        self.frame_idx += 1
        return unc + comp + tile_data

    def write_show_existing(self, slot: int) -> bytes:
        """show_existing_frame packet: displays ref pool slot `slot`
        (one byte for profiles 0/1)."""
        wb = BitWriter()
        wb.f(C.VP9_FRAME_MARKER, 2)
        wb.write_bit(self.profile & 1)
        wb.write_bit((self.profile >> 1) & 1)
        wb.write_bit(1)              # show_existing_frame
        wb.f(slot, 3)                # frame_to_show_map_idx
        return wb.data()

    def _uncompressed_header_intra_only(self, comp_size, refresh_flags,
                                        error_resilient, reset_fc,
                                        fc_idx) -> bytes:
        wb = BitWriter()
        wb.f(C.VP9_FRAME_MARKER, 2)
        wb.write_bit(self.profile & 1)
        wb.write_bit((self.profile >> 1) & 1)
        wb.write_bit(0)              # show_existing_frame
        wb.write_bit(1)              # frame_type: non-key
        wb.write_bit(0)              # show_frame (intra_only requires 0)
        wb.write_bit(1 if error_resilient else 0)
        wb.write_bit(1)              # intra_only
        if not error_resilient:
            wb.f(reset_fc, 2)        # reset_frame_context
        for b in C.VP9_SYNC_CODE:
            wb.f(b, 8)
        if self.profile > 0:
            # profile 2: bit depth + colorspace (4:2:0 implied); the
            # profile-0 intra-only header codes NO colorspace (4:2:0
            # BT.601 is normative, vp9_decodeframe.c:3195-3203)
            wb.write_bit(0 if self.bit_depth == 10 else 1)
            wb.f(C.CS_BT_601, 3)
            wb.write_bit(0)          # color_range (studio)
        wb.f(refresh_flags, 8)
        wb.f(self.width - 1, 16)
        wb.f(self.height - 1, 16)
        wb.write_bit(0)              # render size == frame size
        if not error_resilient:
            wb.write_bit(0)          # refresh_frame_context
            wb.write_bit(1)          # frame_parallel_decoding_mode
        wb.f(fc_idx, C.FRAME_CONTEXTS_LOG2)
        wb.f(0, 6)                   # lf filter_level
        wb.f(0, 3)                   # lf sharpness
        wb.write_bit(0)              # mode_ref_delta_enabled
        wb.f(self.base_qindex, 8)
        wb.write_bit(0)              # y_dc_delta_q
        wb.write_bit(0)              # uv_dc_delta_q
        wb.write_bit(0)              # uv_ac_delta_q
        self._write_segmentation(wb)
        if self.log2_tile_cols < self.max_log2_tile_cols:
            wb.write_bit(0)
        wb.write_bit(0)              # log2_tile_rows
        wb.f(comp_size, 16)
        return wb.data()

    def _make_parse_state(self):
        """Decoder-machinery state for inter symbol contexts (mode /
        ref / partition), exactly as encoder/interframe.py builds it."""
        from ..decoder.headers import (FrameHeader, LoopFilterParams,
                                       SegmentationParams)
        from ..decoder.compressed_header import CompressedHeader
        from ..decoder.tiles import FrameParseState
        hdr = FrameHeader()
        hdr.profile = self.profile
        hdr.frame_type = 1
        hdr.show_frame = 1
        hdr.error_resilient_mode = 1
        hdr.intra_only = 0
        hdr.width = self.width
        hdr.height = self.height
        hdr.bit_depth = self.bit_depth
        hdr.subsampling_x = hdr.subsampling_y = 1
        hdr.base_qindex = self.base_qindex
        hdr.refresh_frame_flags = 1
        for i in range(C.REFS_PER_FRAME):
            hdr.ref_frame_idx[i] = 0
            hdr.ref_frame_sign_bias[C.LAST_FRAME + i] = 0
        hdr.allow_high_precision_mv = 0
        hdr.interp_filter = C.LITERAL_TO_FILTER_MAP[0]
        hdr.lf = LoopFilterParams()
        hdr.lf.filter_level = 0
        hdr.seg = SegmentationParams()
        hdr.compute_geometry()
        hdr.log2_tile_cols = self.log2_tile_cols
        hdr.log2_tile_rows = 0
        ch = CompressedHeader()
        ch.tx_mode = C.ALLOW_32X32
        ch.reference_mode = C.SINGLE_REFERENCE

        class _DS:
            subsampling_x = 1
            subsampling_y = 1
            seg_map_last = None
            use_prev_frame_mvs = False
            prev_ref = None
            prev_mv = None

        return FrameParseState(hdr, ch, self.fc, None, _DS)

    def _encode_inter_tiles(self, st: "_FrameState") -> bytes:
        from ..decoder.tiles import TileInfo, Xd
        pst = self._make_parse_state()
        tile_cols = 1 << self.log2_tile_cols
        chunks = []
        for tc in range(tile_cols):
            col_start = _tile_offset(tc, self.mi_cols, self.log2_tile_cols)
            col_end = _tile_offset(tc + 1, self.mi_cols, self.log2_tile_cols)
            w = BoolEncoder()
            st.tile_col_start = col_start
            xd = Xd()
            xd.tile = TileInfo(0, self.mi_rows, col_start, col_end)
            for mi_row in range(0, self.mi_rows, C.MI_BLOCK_SIZE):
                st.zero_left_ctx()
                pst.zero_left_ctx()
                for mi_col in range(col_start, col_end, C.MI_BLOCK_SIZE):
                    self._encode_inter_partition(pst, st, xd, w, mi_row,
                                                 mi_col, C.BLOCK_64X64, 4)
            chunks.append(w.stop())
        out = bytearray()
        for i, c in enumerate(chunks):
            if i != len(chunks) - 1:
                out += len(c).to_bytes(4, "big")
            out += c
        return bytes(out)

    def _encode_inter_partition(self, pst, st, xd, w, mi_row, mi_col,
                                bsize, n4x4_l2):
        from ..decoder.tiles import (_dec_partition_plane_context,
                                     _dec_update_partition_context)
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        n8x8_l2 = n4x4_l2 - 1
        num_8x8_wh = 1 << n8x8_l2
        hbs = num_8x8_wh >> 1
        has_rows = (mi_row + hbs) < self.mi_rows
        has_cols = (mi_col + hbs) < self.mi_cols
        fits = has_rows and has_cols
        if bsize <= self.block_size and fits:
            partition = C.PARTITION_NONE
        elif not hbs:
            partition = C.PARTITION_NONE
        else:
            partition = C.PARTITION_SPLIT

        ctx = _dec_partition_plane_context(pst, mi_row, mi_col, n8x8_l2)
        probs = self.fc.partition[ctx].tolist()
        if has_rows and has_cols:
            w.write_tree(M.PARTITION_TREE, probs, _PARTITION_PATHS, partition)
        elif not has_rows and has_cols:
            w.write(1 if partition == C.PARTITION_SPLIT else 0, probs[1])
        elif has_rows and not has_cols:
            w.write(1 if partition == C.PARTITION_SPLIT else 0, probs[2])

        subsize = int(M.SUBSIZE_LOOKUP[partition][bsize])
        if partition == C.PARTITION_NONE:
            self._encode_inter_block(pst, st, xd, w, mi_row, mi_col,
                                     subsize, max(n4x4_l2, 1),
                                     max(n4x4_l2, 1))
        else:
            self._encode_inter_partition(pst, st, xd, w, mi_row, mi_col,
                                         subsize, n8x8_l2)
            self._encode_inter_partition(pst, st, xd, w, mi_row,
                                         mi_col + hbs, subsize, n8x8_l2)
            self._encode_inter_partition(pst, st, xd, w, mi_row + hbs,
                                         mi_col, subsize, n8x8_l2)
            self._encode_inter_partition(pst, st, xd, w, mi_row + hbs,
                                         mi_col + hbs, subsize, n8x8_l2)

        if bsize >= C.BLOCK_8X8 and (bsize == C.BLOCK_8X8
                                     or partition != C.PARTITION_SPLIT):
            _dec_update_partition_context(pst, mi_row, mi_col, subsize,
                                          num_8x8_wh)

    def _encode_inter_block(self, pst, st, xd, w, mi_row, mi_col, bsize,
                            bwl, bhl):
        """One block of an inter frame: ZEROMV/LAST (skip or coded
        residual) vs intra fallback, contexts via the decoder machinery
        (read_inter_frame_mode_info parity)."""
        from ..decoder import decodemv, mvref
        bd = self.bit_depth
        g = pst.mi
        fc = self.fc
        bw_mi = 1 << (bwl - 1)
        bh_mi = 1 << (bhl - 1)
        x_mis = min(bw_mi, self.mi_cols - mi_col)
        y_mis = min(bh_mi, self.mi_rows - mi_row)
        mb_to_right = (self.mi_cols - bw_mi - mi_col) * 64
        mb_to_bottom = (self.mi_rows - bh_mi - mi_row) * 64
        tx_size_y = int(M.MAX_TXSIZE_LOOKUP[bsize])

        xd.mb_to_top_edge = -((mi_row * C.MI_SIZE) * 8)
        xd.mb_to_bottom_edge = ((self.mi_rows - bh_mi - mi_row)
                                * C.MI_SIZE) * 8
        xd.mb_to_left_edge = -((mi_col * C.MI_SIZE) * 8)
        xd.mb_to_right_edge = ((self.mi_cols - bw_mi - mi_col)
                               * C.MI_SIZE) * 8
        xd.above = g.at(mi_row - 1, mi_col) if mi_row > 0 else None
        xd.left = (g.at(mi_row, mi_col - 1)
                   if mi_col > xd.tile.mi_col_start else None)
        seg_id = (int(self.seg_map[mi_row, mi_col])
                  if self.seg_map is not None else 0)
        g.sb_type[mi_row, mi_col] = bsize
        g.segment_id[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis] = seg_id

        # ---- mode decision: inter candidates (ZEROMV / NEARESTMV /
        # NEARMV from the decoder's own mv-ref machinery / NEWMV by
        # motion search) vs best-intra, scored by probe SAD plus
        # rate-weighted MV bits (vp9_rd_pick_inter_mode_sb spirit,
        # vp9/encoder/vp9_rdopt.c)
        from .motion import (full_pel_search, mv_bits_estimate,
                             subpel_refine, write_mv)
        x0 = mi_col * 8
        y0 = mi_row * 8
        probe = min((1 << bwl) * 4, 32)
        s = st.src[0][y0:y0 + probe, x0:x0 + probe].astype(np.int64)
        kernel = M.FILTER_KERNELS[pst.interp_filter]
        lam = max(1, self.dq_y[1] >> 3)
        # prediction reference: previous recon, or an external one
        # (SVC inter-layer); a size mismatch switches this block to
        # scaled-reference ZEROMV (vpx_scaled_2d parity via the oracle's
        # _mc_unit) vs intra
        ext_sf = None
        if self._ext_ref is not None:
            ref_planes, (ref_w, ref_h) = self._ext_ref
            if (ref_w, ref_h) != (self.width, self.height):
                from ..ops.ref.inter import ScaleFactors
                ext_sf = ScaleFactors(ref_w, ref_h, self.width,
                                      self.height)
            ref_crops = [(ref_w, ref_h), ((ref_w + 1) >> 1,
                                          (ref_h + 1) >> 1),
                         ((ref_w + 1) >> 1, (ref_h + 1) >> 1)]
        else:
            ref_planes = self._ref_recon
            ref_crops = st.crop_dims
        cw, ch = ref_crops[0]
        refY = ref_planes[0]

        def probe_sad(mv):
            if mv == (0, 0):
                p = _zeromv_pred(refY, (cw, ch), x0, y0,
                                 s.shape[1], s.shape[0])
            else:
                srow_q4, scol_q4 = mv[0] * 2, mv[1] * 2
                p = inter_ops.convolve_block(
                    refY, cw, ch, x0 + (scol_q4 >> 4), y0 + (srow_q4 >> 4),
                    scol_q4 & 15, srow_q4 & 15, 16, 16,
                    s.shape[1], s.shape[0], kernel, bd, None)
            return int(np.abs(s - p).sum())

        if ext_sf is not None:
            # scaled inter-layer reference: ZEROMV only (prediction via
            # the oracle's _mc_unit, bit-exact with the decoder's
            # scaled branch); MV modes would need scale_mv-aware search
            from ..ops.ref import recon as oracle_recon
            bw_px = (1 << bwl) * 4
            bh_px = (1 << bhl) * 4
            oracle_recon._mc_unit(
                st.recon[0], refY, cw, ch, (0, 0), 0, 0, bw_px, bh_px,
                mi_col * 8, mi_row * 8, xd.mb_to_left_edge,
                xd.mb_to_top_edge, mb_to_right, mb_to_bottom, 0, 0,
                ext_sf, True, kernel, bd, 0)
            pr = st.recon[0][y0:y0 + s.shape[0],
                             x0:x0 + s.shape[1]].astype(np.int64)
            cands = [(C.ZEROMV, (0, 0), int(np.abs(s - pr).sum()))]
            ref_mv = (0, 0)
        else:
            # candidate MVs exactly as the decoder will derive them
            # (read_inter_block_mode_info: tmp[refmv_count - 1] per mode)
            mvl, cnt = mvref.dec_find_mv_refs(pst, xd, C.NEARESTMV,
                                              C.LAST_FRAME, bsize,
                                              mi_row, mi_col, -1)
            mv_nearest = mvref.lower_mv_precision(mvl[cnt - 1], 0)
            mvl, cnt = mvref.dec_find_mv_refs(pst, xd, C.NEARMV,
                                              C.LAST_FRAME,
                                              bsize, mi_row, mi_col, -1)
            mv_near = mvref.lower_mv_precision(mvl[cnt - 1], 0)
            mvl, _ = mvref.dec_find_mv_refs(pst, xd, C.NEWMV, C.LAST_FRAME,
                                            bsize, mi_row, mi_col, -1)
            ref_mv = mvref.lower_mv_precision(mvl[0], 0)

            cands = [(C.ZEROMV, (0, 0), probe_sad((0, 0)))]
            for m, mv in ((C.NEARESTMV, mv_nearest), (C.NEARMV, mv_near)):
                if mv != (0, 0) and C.MV_LOW < mv[0] < C.MV_UPP \
                        and C.MV_LOW < mv[1] < C.MV_UPP:
                    cands.append((m, mv, probe_sad(mv)))
            if self.mode_search:
                starts = [(0, 0),
                          ((ref_mv[0] + 4) >> 3, (ref_mv[1] + 4) >> 3)]
                fr, fcl, _, _ = full_pel_search(s, refY, cw, ch, x0, y0,
                                                starts, sad_range=24,
                                                lam=lam, pred_mv=ref_mv)
                mv_new, _, nsad = subpel_refine(s, refY, cw, ch, x0, y0,
                                                (fr, fcl), kernel, bd,
                                                lam=lam, pred_mv=ref_mv)
                if mv_new not in ((0, 0), mv_nearest, mv_near):
                    cands.append((C.NEWMV, mv_new,
                                  nsad + lam * mv_bits_estimate(mv_new,
                                                                ref_mv)))
        inter_mode, best_mv, inter_cost = min(cands, key=lambda t: t[2])

        y_mode = self._pick_mode(st, 0, mi_row, mi_col, bsize, bwl, bhl,
                                 mb_to_right, mb_to_bottom) \
            if self.mode_search else C.DC_PRED
        # intra probe SAD for the chosen mode
        intra_sad = None
        try:
            above, tl, left = intra.build_edges(
                st.recon[0], *st.aligned_dims[0], x0, y0, probe, y_mode,
                mi_row > 0, mi_col > st.tile_col_start, False,
                mb_to_right < 0, mb_to_bottom < 0, bd)
            ipred = intra.predict(y_mode, probe, above, tl, left,
                                  mi_col > st.tile_col_start, mi_row > 0, bd)
            intra_sad = int(np.abs(
                s - ipred[:s.shape[0], :s.shape[1]]).sum())
        except Exception:
            pass
        use_inter = intra_sad is None or inter_cost <= intra_sad
        self.mode_counts[inter_mode if use_inter else "intra"] += 1

        # ---- compute prediction + residual transforms
        tx_blocks = []
        eobtotal_nz = False
        for plane in range(3):
            sx = 1 if plane else 0
            sy = 1 if plane else 0
            recon = st.recon[plane]
            src = st.src[plane]
            fw, fh = st.aligned_dims[plane]
            tx_size = tx_size_y if plane == 0 else \
                int(M.UV_TXSIZE_LOOKUP[bsize][tx_size_y][sx][sy])
            n4_w = (1 << bwl) >> sx
            n4_h = (1 << bhl) >> sy
            n4_wl = bwl - sx
            step = 1 << tx_size
            max_bw = n4_w + (mb_to_right >> (5 + sx) if mb_to_right < 0
                             else 0)
            max_bh = n4_h + (mb_to_bottom >> (5 + sy) if mb_to_bottom < 0
                             else 0)
            bx4 = (mi_col * 2) >> sx
            by4 = (mi_row * 2) >> sy
            px0, py0 = bx4 * 4, by4 * 4
            bs_full = 4 << tx_size
            dq = self._blk_dq(seg_id)
            mode = y_mode
            if use_inter:
                # whole-block edge-clamped prediction at best_mv
                # (dec_build_inter_predictors / _mc_unit unscaled branch:
                # chroma positions are q4 of the half-res plane)
                bw_px = n4_w * 4
                bh_px = n4_h * 4
                pcw, pch = ref_crops[plane]
                if ext_sf is not None:
                    from ..ops.ref import recon as oracle_recon
                    oracle_recon._mc_unit(
                        recon, ref_planes[plane], pcw, pch, (0, 0), 0, 0,
                        bw_px, bh_px, mi_col * 8, mi_row * 8,
                        xd.mb_to_left_edge, xd.mb_to_top_edge,
                        mb_to_right, mb_to_bottom, sx, sy, ext_sf, True,
                        M.FILTER_KERNELS[pst.interp_filter], bd, 0)
                elif best_mv == (0, 0):
                    recon[py0:py0 + bh_px, px0:px0 + bw_px] = _zeromv_pred(
                        ref_planes[plane], ref_crops[plane],
                        px0, py0, bw_px, bh_px)
                else:
                    srow = best_mv[0] * (1 << (1 - sy))
                    scol = best_mv[1] * (1 << (1 - sx))
                    recon[py0:py0 + bh_px, px0:px0 + bw_px] = \
                        inter_ops.convolve_block(
                            ref_planes[plane], pcw, pch,
                            px0 + (scol >> 4), py0 + (srow >> 4),
                            scol & 15, srow & 15, 16, 16, bw_px, bh_px,
                            M.FILTER_KERNELS[pst.interp_filter], bd, None)
            have_up_blk = mi_row > 0
            have_left_blk = mi_col > st.tile_col_start
            for row in range(0, max_bh, step):
                for col in range(0, max_bw, step):
                    tx0 = (bx4 + col) * 4
                    ty0 = (by4 + row) * 4
                    if use_inter:
                        pred = recon[ty0:ty0 + bs_full,
                                     tx0:tx0 + bs_full].astype(np.int64)
                        tx_type = C.DCT_DCT
                    else:
                        have_up = (row > 0) or have_up_blk
                        have_left = (col > 0) or have_left_blk
                        have_right = (col + step) < (1 << n4_wl)
                        above, tl, left = intra.build_edges(
                            recon, fw, fh, tx0, ty0, bs_full, mode,
                            have_up, have_left, have_right,
                            mb_to_right < 0, mb_to_bottom < 0, bd)
                        pred = intra.predict(mode, bs_full, above, tl,
                                             left, have_left, have_up, bd)
                        recon[ty0:ty0 + bs_full, tx0:tx0 + bs_full] = pred
                        tx_type = (C.DCT_DCT if plane
                                   else _INTRA_MODE_TO_TX_TYPE[mode])
                    resid = (src[ty0:ty0 + bs_full,
                                 tx0:tx0 + bs_full].astype(np.int64) - pred)
                    cf = fwd_txfm2d(resid[None], tx_size, tx_type)
                    levels = tokenize.quantize_block(
                        cf[0], dq[0], dq[1], tx_size, bd)
                    if levels.any():
                        eobtotal_nz = True
                        dq_shift = 1 if tx_size == C.TX_32X32 else 0
                        dqv = np.full(levels.shape, dq[1], np.int64)
                        dqv[0] = dq[0]
                        dqc = (np.sign(levels)
                               * ((np.abs(levels) * dqv) >> dq_shift))
                        dqc = ((dqc + (1 << 31)) % (1 << 32)) - (1 << 31)
                        res = inv.inv_txfm2d(
                            dqc.astype(np.int32)[None], tx_size,
                            tx_type, bd)[0]
                        region = recon[ty0:ty0 + bs_full, tx0:tx0 + bs_full]
                        region[:] = np.clip(
                            region.astype(np.int64) + res, 0, (1 << bd) - 1)
                    tx_blocks.append((plane, row, col, tx_size, levels,
                                      tx_type, step, max_bw, max_bh))

        skip = 0 if eobtotal_nz else 1

        # ---- syntax (read_inter_frame_mode_info order)
        if self.seg_map is not None:
            # inter_segment_id first (update_map, no temporal pred)
            w.write_tree(M.SEGMENT_TREE, self._seg_tree_probs,
                         self._seg_paths, seg_id)
        above, left = xd.above, xd.left
        skip_ctx = ((above.skip if above is not None else 0)
                    + (left.skip if left is not None else 0))
        w.write(skip, int(fc.skip[skip_ctx]))
        ii_ctx = decodemv._get_intra_inter_context(xd)
        w.write(1 if use_inter else 0, int(fc.intra_inter[ii_ctx]))
        # tx_size: tx_mode != TX_MODE_SELECT -> no bits
        if use_inter:
            g.ref[mi_row, mi_col, 0] = C.LAST_FRAME
            g.ref[mi_row, mi_col, 1] = C.NONE_FRAME
            p1_ctx = decodemv._get_pred_context_single_ref_p1(xd)
            w.write(0, int(fc.single_ref[p1_ctx][0]))
            mode_ctx = mvref.get_mode_context(pst, xd, bsize, mi_row,
                                              mi_col)
            w.write_tree(M.INTER_MODE_TREE,
                         fc.inter_mode[mode_ctx].tolist(),
                         _INTER_MODE_PATHS, inter_mode - C.NEARESTMV)
            if inter_mode == C.NEWMV:
                # MV residual vs the decoder's best_ref_mvs[0]
                # (vp9_encodemv.c vp9_encode_mv / _read_mv mirror)
                write_mv(w, fc, best_mv, ref_mv)
            g.mode[mi_row, mi_col] = inter_mode
            g.uv_mode[mi_row, mi_col] = C.DC_PRED
            g.mv[mi_row, mi_col, 0, 0] = best_mv[0]
            g.mv[mi_row, mi_col, 0, 1] = best_mv[1]
            g.mv[mi_row, mi_col, 1] = 0
        else:
            g.ref[mi_row, mi_col, 0] = C.INTRA_FRAME
            g.ref[mi_row, mi_col, 1] = C.NONE_FRAME
            # read_intra_block_mode_info: fc.y_mode[size group] tree
            sg = int(M.SIZE_GROUP[bsize])
            w.write_tree(M.INTRA_MODE_TREE, fc.y_mode[sg].tolist(),
                         _INTRA_MODE_PATHS, y_mode)
            w.write_tree(M.INTRA_MODE_TREE, fc.uv_mode[y_mode].tolist(),
                         _INTRA_MODE_PATHS, y_mode)
            g.mode[mi_row, mi_col] = y_mode
            g.uv_mode[mi_row, mi_col] = y_mode
            g.mv[mi_row, mi_col] = 0
        g.skip[mi_row, mi_col] = skip
        g.tx_size[mi_row, mi_col] = tx_size_y
        g.interp_filter[mi_row, mi_col] = pst.interp_filter
        decodemv._replicate(pst, mi_row, mi_col, x_mis, y_mis)

        # ---- tokens (identical entropy-context handling to keyframes)
        if skip:
            _reset_skip_ctx(st, mi_row, mi_col, bwl, bhl)
        else:
            ref_type = 1 if use_inter else 0
            for (plane, row, col, tx_size, levels, tx_type, step,
                 max_bw, max_bh) in tx_blocks:
                sx = 1 if plane else 0
                sy = 1 if plane else 0
                plane_type = 1 if plane else 0
                above_c = st.above_ctx[plane]
                left_c = st.left_ctx[plane]
                apos = (mi_col * 2) >> sx
                lpos = ((mi_row * 2) & 15) >> sy
                clip_w = max_bw if mb_to_right < 0 else 0
                clip_h = max_bh if mb_to_bottom < 0 else 0
                if tx_size == C.TX_4X4:
                    ctx = int(above_c[apos + col] != 0) + \
                        int(left_c[lpos + row] != 0)
                else:
                    ctx = int(above_c[apos + col:apos + col
                                      + step].any()) + \
                        int(left_c[lpos + row:lpos + row + step].any())
                sc = self.scans[tx_size][tx_type if not plane_type
                                         else C.DCT_DCT]
                coef_probs = \
                    self.coef_probs_list[tx_size][plane_type][ref_type]
                eob = tokenize.encode_coefs(
                    w, coef_probs, levels, tx_size, ctx,
                    sc.scan.tolist(), sc.neighbors.reshape(-1).tolist(),
                    self.bit_depth)
                nz = 1 if eob > 0 else 0
                sh_a = (step - (clip_w - col)) if (clip_w
                                                   and step + col > clip_w) \
                    else 0
                sh_l = (step - (clip_h - row)) if (clip_h
                                                   and step + row > clip_h) \
                    else 0
                above_c[apos + col:apos + col + step] = 0
                above_c[apos + col:apos + col + step - sh_a] = nz
                left_c[lpos + row:lpos + row + step] = 0
                left_c[lpos + row:lpos + row + step - sh_l] = nz

    # ------------------------------------------------------------- tiles

    def _encode_tiles(self, st: "_FrameState") -> bytes:
        tile_cols = 1 << self.log2_tile_cols
        chunks = []
        for tc in range(tile_cols):
            col_start = _tile_offset(tc, self.mi_cols, self.log2_tile_cols)
            col_end = _tile_offset(tc + 1, self.mi_cols, self.log2_tile_cols)
            w = BoolEncoder()
            st.tile_col_start = col_start
            for mi_row in range(0, self.mi_rows, C.MI_BLOCK_SIZE):
                st.zero_left_ctx()
                for mi_col in range(col_start, col_end, C.MI_BLOCK_SIZE):
                    self._encode_partition(st, w, mi_row, mi_col,
                                           C.BLOCK_64X64, 4)
            chunks.append(w.stop())
        out = bytearray()
        for i, c in enumerate(chunks):
            if i != len(chunks) - 1:
                out += len(c).to_bytes(4, "big")
            out += c
        return bytes(out)

    # --------------------------------------------------------- partition

    def _encode_partition(self, st, w, mi_row, mi_col, bsize, n4x4_l2):
        """Mirror of tiles._decode_partition with a fixed target size."""
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        n8x8_l2 = n4x4_l2 - 1
        num_8x8_wh = 1 << n8x8_l2
        hbs = num_8x8_wh >> 1
        has_rows = (mi_row + hbs) < self.mi_rows
        has_cols = (mi_col + hbs) < self.mi_cols

        # choose: NONE once we reach the target size AND the block fits;
        # SPLIT otherwise (partial nodes always split until everything fits)
        fits = has_rows and has_cols
        if bsize <= self.block_size and fits:
            partition = C.PARTITION_NONE
        elif not hbs:
            partition = C.PARTITION_NONE  # 8x8 leaf always fits
        else:
            partition = C.PARTITION_SPLIT

        ctx = _partition_ctx(st, mi_row, mi_col, n8x8_l2)
        probs = self.kf_partition_probs[ctx]
        if has_rows and has_cols:
            w.write_tree(M.PARTITION_TREE, probs, _PARTITION_PATHS, partition)
        elif not has_rows and has_cols:
            w.write(1 if partition == C.PARTITION_SPLIT else 0, probs[1])
        elif has_rows and not has_cols:
            w.write(1 if partition == C.PARTITION_SPLIT else 0, probs[2])
        # neither: forced SPLIT, no bits

        subsize = int(M.SUBSIZE_LOOKUP[partition][bsize])
        if partition == C.PARTITION_NONE:
            self._encode_block(st, w, mi_row, mi_col, subsize,
                               max(n4x4_l2, 1), max(n4x4_l2, 1))
        else:  # SPLIT
            self._encode_partition(st, w, mi_row, mi_col, subsize, n8x8_l2)
            self._encode_partition(st, w, mi_row, mi_col + hbs, subsize,
                                   n8x8_l2)
            self._encode_partition(st, w, mi_row + hbs, mi_col, subsize,
                                   n8x8_l2)
            self._encode_partition(st, w, mi_row + hbs, mi_col + hbs,
                                   subsize, n8x8_l2)

        if bsize >= C.BLOCK_8X8 and (bsize == C.BLOCK_8X8
                                     or partition != C.PARTITION_SPLIT):
            _update_partition_ctx(st, mi_row, mi_col, subsize, num_8x8_wh)

    # ------------------------------------------------------------- block

    def _encode_block(self, st, w, mi_row, mi_col, bsize, bwl, bhl):
        bd = self.bit_depth
        bw_mi = 1 << (bwl - 1)
        bh_mi = 1 << (bhl - 1)
        x_mis = min(bw_mi, self.mi_cols - mi_col)
        y_mis = min(bh_mi, self.mi_rows - mi_row)
        mb_to_right = (self.mi_cols - bw_mi - mi_col) * 64
        mb_to_bottom = (self.mi_rows - bh_mi - mi_row) * 64
        seg_id = (int(self.seg_map[mi_row, mi_col])
                  if self.seg_map is not None else 0)

        tx_size_y = int(M.MAX_TXSIZE_LOOKUP[bsize]) if not self.lossless \
            else C.TX_4X4

        # ---- mode decision (whole-block SAD approximation)
        y_mode = C.DC_PRED
        uv_mode = C.DC_PRED
        if self.mode_search:
            y_mode = self._pick_mode(st, 0, mi_row, mi_col, bsize, bwl, bhl,
                                     mb_to_right, mb_to_bottom)
            uv_mode = y_mode

        # ---- compute + reconstruct (mirror of recon._recon_intra_block)
        tx_blocks = []  # (plane, row, col, tx_size, levels, tx_type)
        eobtotal_nz = False
        for plane in range(3):
            sx = 1 if plane else 0
            sy = 1 if plane else 0
            recon = st.recon[plane]
            src = st.src[plane]
            fw, fh = st.aligned_dims[plane]
            tx_size = tx_size_y if plane == 0 else \
                int(M.UV_TXSIZE_LOOKUP[bsize][tx_size_y][sx][sy])
            n4_w = (1 << bwl) >> sx
            n4_h = (1 << bhl) >> sy
            n4_wl = bwl - sx
            step = 1 << tx_size
            max_bw = n4_w + (mb_to_right >> (5 + sx) if mb_to_right < 0
                             else 0)
            max_bh = n4_h + (mb_to_bottom >> (5 + sy) if mb_to_bottom < 0
                             else 0)
            bx4 = (mi_col * 2) >> sx
            by4 = (mi_row * 2) >> sy
            mode = y_mode if plane == 0 else uv_mode
            bs = 4 << tx_size
            have_up_blk = mi_row > 0
            have_left_blk = mi_col > st.tile_col_start
            dq = self._blk_dq(seg_id)
            for row in range(0, max_bh, step):
                for col in range(0, max_bw, step):
                    x0 = (bx4 + col) * 4
                    y0 = (by4 + row) * 4
                    have_up = (row > 0) or have_up_blk
                    have_left = (col > 0) or have_left_blk
                    have_right = (col + step) < (1 << n4_wl)
                    above, tl, left = intra.build_edges(
                        recon, fw, fh, x0, y0, bs, mode, have_up, have_left,
                        have_right, mb_to_right < 0, mb_to_bottom < 0, bd)
                    pred = intra.predict(mode, bs, above, tl, left,
                                         have_left, have_up, bd)
                    resid = (src[y0:y0 + bs, x0:x0 + bs].astype(np.int64)
                             - pred)
                    tx_type = (C.DCT_DCT if (plane or self.lossless)
                               else _INTRA_MODE_TO_TX_TYPE[mode])
                    if self.lossless:
                        # exact integer WHT levels (dequant at q0 is 4,
                        # the iwht input >>2 undoes it bit-exactly)
                        levels = fwd_wht2d(resid[None])[0].astype(np.int32)
                    else:
                        cf = fwd_txfm2d(resid[None], tx_size, tx_type)
                        levels = tokenize.quantize_block(
                            cf[0], dq[0], dq[1], tx_size, bd)
                    recon[y0:y0 + bs, x0:x0 + bs] = pred
                    if levels.any():
                        eobtotal_nz = True
                        # dequant + inverse = what the decoder adds
                        dq_shift = 1 if tx_size == C.TX_32X32 else 0
                        dqv = np.full(levels.shape, dq[1], np.int64)
                        dqv[0] = dq[0]
                        dqc = (np.sign(levels)
                               * ((np.abs(levels) * dqv) >> dq_shift))
                        dqc = ((dqc + (1 << 31)) % (1 << 32)) - (1 << 31)
                        if self.lossless:
                            res = inv.inv_wht2d(
                                dqc.astype(np.int32)[None], bd)[0]
                        else:
                            res = inv.inv_txfm2d(
                                dqc.astype(np.int32)[None], tx_size,
                                tx_type, bd)[0]
                        region = recon[y0:y0 + bs, x0:x0 + bs]
                        region[:] = np.clip(
                            region.astype(np.int64) + res, 0,
                            (1 << bd) - 1)
                    tx_blocks.append((plane, row, col, tx_size, levels,
                                      tx_type, step, max_bw, max_bh))

        skip = 0 if eobtotal_nz else 1

        # ---- write syntax (mirror of read_mode_info + _detoken_block)
        if self.seg_map is not None:
            # intra_segment_id comes FIRST (read_intra_frame_mode_info)
            w.write_tree(M.SEGMENT_TREE, self._seg_tree_probs,
                         self._seg_paths, seg_id)
        above_mi = (mi_row - 1, mi_col) if mi_row > 0 else None
        left_mi = (mi_row, mi_col - 1) if mi_col > st.tile_col_start \
            else None
        skip_ctx = ((st.skip_grid[above_mi] if above_mi else 0)
                    + (st.skip_grid[left_mi] if left_mi else 0))
        w.write(skip, self.skip_probs[skip_ctx])
        # tx_size: tx_mode != TX_MODE_SELECT -> no bits
        a_mode = int(st.mode_grid[above_mi]) if above_mi else C.DC_PRED
        l_mode = int(st.mode_grid[left_mi]) if left_mi else C.DC_PRED
        w.write_tree(M.INTRA_MODE_TREE, self.kf_y_probs[a_mode][l_mode],
                     _INTRA_MODE_PATHS, y_mode)
        w.write_tree(M.INTRA_MODE_TREE, self.kf_uv_probs[y_mode],
                     _INTRA_MODE_PATHS, uv_mode)

        if skip:
            _reset_skip_ctx(st, mi_row, mi_col, bwl, bhl)
        else:
            for (plane, row, col, tx_size, levels, tx_type, step,
                 max_bw, max_bh) in tx_blocks:
                sx = 1 if plane else 0
                sy = 1 if plane else 0
                plane_type = 1 if plane else 0
                above = st.above_ctx[plane]
                left = st.left_ctx[plane]
                apos = (mi_col * 2) >> sx
                lpos = ((mi_row * 2) & 15) >> sy
                n4_w = (1 << bwl) >> sx
                n4_h = (1 << bhl) >> sy
                clip_w = max_bw if mb_to_right < 0 else 0
                clip_h = max_bh if mb_to_bottom < 0 else 0
                if tx_size == C.TX_4X4:
                    ctx = int(above[apos + col] != 0) + \
                        int(left[lpos + row] != 0)
                else:
                    ctx = int(above[apos + col:apos + col + step].any()) + \
                        int(left[lpos + row:lpos + row + step].any())
                sc = self.scans[tx_size][
                    tx_type if not (plane or self.lossless) else C.DCT_DCT]
                coef_probs = self.coef_probs_list[tx_size][plane_type][0]
                eob = tokenize.encode_coefs(
                    w, coef_probs, levels, tx_size, ctx,
                    sc.scan.tolist(), sc.neighbors.reshape(-1).tolist(),
                    self.bit_depth)
                nz = 1 if eob > 0 else 0
                sh_a = (step - (clip_w - col)) if (clip_w
                                                   and step + col > clip_w) \
                    else 0
                sh_l = (step - (clip_h - row)) if (clip_h
                                                   and step + row > clip_h) \
                    else 0
                above[apos + col:apos + col + step] = 0
                above[apos + col:apos + col + step - sh_a] = nz
                left[lpos + row:lpos + row + step] = 0
                left[lpos + row:lpos + row + step - sh_l] = nz

        # ---- mi grid updates over the block extent (replicate)
        sl = np.s_[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis]
        st.mode_grid[sl] = y_mode
        st.skip_grid[sl] = skip

    def _pick_mode(self, st, plane, mi_row, mi_col, bsize, bwl, bhl,
                   mb_to_right, mb_to_bottom):
        """Whole-block single-prediction SAD over the mode candidates.

        Approximates per-tx-block prediction (no recon feedback inside the
        block); only mode CHOICE depends on it, so any error costs quality,
        never correctness."""
        bd = self.bit_depth
        recon = st.recon[plane]
        src = st.src[plane]
        fw, fh = st.aligned_dims[plane]
        x0 = mi_col * 8
        y0 = mi_row * 8
        have_up = mi_row > 0
        have_left = mi_col > st.tile_col_start
        # probe with one square predictor over the block (cap 32x32)
        probe = min((1 << bwl) * 4, 32)
        best_mode, best_sad = C.DC_PRED, None
        s = src[y0:y0 + probe, x0:x0 + probe].astype(np.int64)
        for mode in _MODE_CANDIDATES:
            try:
                above, tl, left = intra.build_edges(
                    recon, fw, fh, x0, y0, probe, mode, have_up, have_left,
                    False, mb_to_right < 0, mb_to_bottom < 0, bd)
                pred = intra.predict(mode, probe, above, tl, left,
                                     have_left, have_up, bd)
            except Exception:
                continue
            sad = int(np.abs(s - pred[:s.shape[0], :s.shape[1]]).sum())
            if best_sad is None or sad < best_sad:
                best_mode, best_sad = mode, sad
        return best_mode


# ----------------------------------------------------------- frame state

class _FrameState:
    def __init__(self, enc: Vp9Encoder, planes):
        self.enc = enc
        mi_rows, mi_cols = enc.mi_rows, enc.mi_cols
        wa = ((mi_cols + 7) & ~7) * 8
        ha = ((mi_rows + 7) & ~7) * 8
        w, h = mi_cols * 8, mi_rows * 8
        self.aligned_dims = [(w, h), (w >> 1, h >> 1), (w >> 1, h >> 1)]
        # visible crop per plane (inter prediction clamps reads here)
        cw, ch = enc.width, enc.height
        self.crop_dims = [(cw, ch), ((cw + 1) >> 1, (ch + 1) >> 1),
                          ((cw + 1) >> 1, (ch + 1) >> 1)]
        self.recon = [np.zeros((ha, wa), np.uint16),
                      np.zeros((ha >> 1, wa >> 1), np.uint16),
                      np.zeros((ha >> 1, wa >> 1), np.uint16)]
        # source padded to the aligned dims by edge replication
        self.src = []
        for p in range(3):
            sp = np.asarray(planes[p])
            th, tw = self.recon[p].shape
            padded = np.zeros((th, tw), np.uint16)
            sh, sw = min(sp.shape[0], th), min(sp.shape[1], tw)
            padded[:sh, :sw] = sp[:sh, :sw]
            if sw < tw:
                padded[:sh, sw:] = padded[:sh, sw - 1:sw]
            if sh < th:
                padded[sh:, :] = padded[sh - 1:sh, :]
            self.src.append(padded)

        self.mode_grid = np.full((mi_rows, mi_cols), C.DC_PRED, np.int8)
        self.skip_grid = np.zeros((mi_rows, mi_cols), np.int8)

        aligned = (mi_cols + 7) & ~7
        self.above_ctx = [np.zeros(((aligned * 2) >> (1 if p else 0)) + 8,
                                   np.uint8) for p in range(3)]
        self.left_ctx = [np.zeros(16 >> (1 if p else 0), np.uint8)
                         for p in range(3)]
        self.above_seg_ctx = np.zeros(aligned + 8, np.uint8)
        self.left_seg_ctx = np.zeros(8, np.uint8)
        self.tile_col_start = 0

    def zero_left_ctx(self):
        for p in range(3):
            self.left_ctx[p][:] = 0
        self.left_seg_ctx[:] = 0


def _zeromv_pred(ref_plane, crop, x0, y0, w, h):
    """Full-pel edge-clamped ZEROMV prediction (convolve at phase 0 is
    a clamped copy; ref sample coordinates clip into the visible crop,
    dec_build_inter_predictors / build_mc_border parity)."""
    cw, ch = crop
    rows = np.clip(np.arange(y0, y0 + h), 0, ch - 1)
    cols = np.clip(np.arange(x0, x0 + w), 0, cw - 1)
    return ref_plane[np.ix_(rows, cols)].astype(np.int64)


def _tile_offset(idx, mis, log2):
    sb_cols = ((mis + 7) & ~7) >> C.MI_BLOCK_SIZE_LOG2
    offset = ((idx * sb_cols) >> log2) << C.MI_BLOCK_SIZE_LOG2
    return min(offset, mis)


def _partition_ctx(st, mi_row, mi_col, bsl):
    above = (int(st.above_seg_ctx[mi_col]) >> bsl) & 1
    left = (int(st.left_seg_ctx[mi_row & 7]) >> bsl) & 1
    return (left * 2 + above) + bsl * C.PARTITION_PLOFFSET


def _update_partition_ctx(st, mi_row, mi_col, subsize, bw):
    st.above_seg_ctx[mi_col:mi_col + bw] = \
        M.PARTITION_CONTEXT_LOOKUP[subsize][0]
    base = mi_row & 7
    st.left_seg_ctx[base:base + bw] = M.PARTITION_CONTEXT_LOOKUP[subsize][1]


def _reset_skip_ctx(st, mi_row, mi_col, bwl, bhl):
    for plane in range(3):
        sx = 1 if plane else 0
        sy = 1 if plane else 0
        n4_w = (1 << bwl) >> sx
        n4_h = (1 << bhl) >> sy
        apos = (mi_col * 2) >> sx
        lpos = ((mi_row * 2) & 15) >> sy
        st.above_ctx[plane][apos:apos + n4_w] = 0
        st.left_ctx[plane][lpos:lpos + n4_h] = 0
