"""Synthetic VP9 inter-frame writer: ZEROMV / skip-all frames.

Writes spec-valid non-key frames whose every block is a 64x64 (or edge-
split) SINGLE-reference LAST_FRAME ZEROMV skip block — i.e. the decoded
frame is EXACTLY the (possibly scaled) motion-compensated prediction of
the reference.  Encoding the frame at a different size than its
reference makes every pixel exercise the scaled-reference MC path
(vp9/common/vp9_scale.c vp9_setup_scale_factors_for_frame), which no
encoder reachable from this environment will otherwise produce — this is
both the scaled-MC test-vector generator and the first inter-frame slice
of the encoder (S19).

All entropy contexts are computed by the DECODER'S own machinery
(decoder.tiles.FrameParseState + decodemv/mvref context helpers), so the
writer cannot drift from the parse side.
"""

from __future__ import annotations

from .. import models as M
from ..decoder import constants as C
from ..decoder import decodemv, mvref
from ..decoder.headers import (FrameHeader, LoopFilterParams,
                               SegmentationParams)
from ..decoder.compressed_header import CompressedHeader
from ..decoder.tiles import (FrameParseState, TileInfo, Xd,
                             _dec_partition_plane_context,
                             _dec_update_partition_context)
from .bitwriter import BitWriter, BoolEncoder, tree_paths

_PARTITION_PATHS = tree_paths(M.PARTITION_TREE)
_INTER_MODE_PATHS = tree_paths(M.INTER_MODE_TREE)
_MV_JOINT_PATHS = tree_paths(M.MV_JOINT_TREE)
_MV_CLASS_PATHS = tree_paths(M.MV_CLASS_TREE)
_MV_FP_PATHS = tree_paths(M.MV_FP_TREE)


def _write_mv_component(w, fc, comp: int, v: int) -> None:
    """Encode one nonzero MV-difference component (1/8-pel units, EVEN
    magnitude: the writer emits allow_high_precision_mv=0 frames, so the
    hp bit is implied 1 and |v| must be even — read_mv_component parity,
    decoder/decodemv.py:384)."""
    sign = 1 if v < 0 else 0
    mag = -v if sign else v
    assert mag > 0 and (mag & 1) == 0, "hp-less MV diffs must be even"
    z = mag - 1
    c, o = decodemv._get_mv_class(z)
    d, f, e = o >> 3, (o >> 1) & 3, o & 1
    assert e == 1  # implied by even magnitude
    w.write(sign, int(fc.mv_sign[comp]))
    w.write_tree(M.MV_CLASS_TREE, fc.mv_classes[comp].tolist(),
                 _MV_CLASS_PATHS, c)
    if c == 0:
        w.write(d, int(fc.mv_class0[comp][0]))
    else:
        for i in range(c + C.CLASS0_BITS - 1):
            w.write((d >> i) & 1, int(fc.mv_bits[comp][i]))
    fp = fc.mv_class0_fp[comp][d] if c == 0 else fc.mv_fp[comp]
    w.write_tree(M.MV_FP_TREE, fp.tolist(), _MV_FP_PATHS, f)
    # usehp False: no hp bit (decoder substitutes 1)


def _write_mv(w, fc, diff) -> None:
    """Encode an MV difference (joint + components), read_mv parity."""
    dr, dc = diff
    joint = ((C.MV_JOINT_HNZVNZ if dc else C.MV_JOINT_HZVNZ) if dr
             else (C.MV_JOINT_HNZVZ if dc else C.MV_JOINT_ZERO))
    w.write_tree(M.MV_JOINT_TREE, fc.mv_joints.tolist(),
                 _MV_JOINT_PATHS, joint)
    if dr:
        _write_mv_component(w, fc, 0, dr)
    if dc:
        _write_mv_component(w, fc, 1, dc)


def write_inter_zeromv_frame(width: int, height: int, base_qindex: int = 60,
                             ref_slot: int = 0, refresh_flags: int = 0,
                             profile: int = 0, bit_depth: int = 8,
                             compound_slots: tuple | None = None,
                             mv_fn=None, show_frame: int = 1) -> bytes:
    """One show_frame=1 error-resilient inter frame, all-ZEROMV-skip.

    The frame references `ref_slot` for LAST/GOLDEN/ALTREF; its size may
    differ from the reference's (within the normative 2x-down / 16x-up
    scaling bounds, vp9/common/vp9_common.h valid_ref_frame_size).

    With compound_slots=(var_slot, fixed_slot), every block is instead a
    COMPOUND_REFERENCE LAST+ALTREF ZEROMV pair: the ALTREF sign bias is
    flipped (vp9_decodeframe.c:3221 -> allow_comp_inter_inter), LAST/
    GOLDEN map to var_slot and ALTREF to fixed_slot, and the decoded
    frame is the normative (p0 + p1 + 1) >> 1 average of the two
    references — the compound prediction path end to end."""
    hdr = _make_header(width, height, base_qindex, ref_slot, refresh_flags,
                       profile, bit_depth, compound_slots)
    hdr.show_frame = show_frame
    fc = M.FrameContext.default()
    st = _make_state(hdr, fc, compound=compound_slots is not None)

    comp = _compressed_header_inter(compound=compound_slots is not None)
    tile = _write_tile(st, hdr, fc, mv_fn)
    unc = _uncompressed_header(hdr, len(comp))
    return unc + comp + tile


def _make_header(width, height, base_qindex, ref_slot, refresh_flags,
                 profile, bit_depth, compound_slots=None) -> FrameHeader:
    hdr = FrameHeader()
    hdr.profile = profile
    hdr.frame_type = 1  # non-key
    hdr.show_frame = 1
    # error-resilient frames CANNOT code compound prediction:
    # vp9_setup_past_independence zeroes the sign biases
    # (vp9_entropymode.c:467), and mixed sign biases are what allow it.
    # Compound frames are written non-resilient with
    # reset_frame_context=0 / refresh_frame_context=0 /
    # frame_parallel=1, so default probabilities still apply.
    hdr.error_resilient_mode = 0 if compound_slots is not None else 1
    hdr.intra_only = 0
    hdr.width = width
    hdr.height = height
    hdr.render_width = width
    hdr.render_height = height
    hdr.bit_depth = bit_depth
    hdr.subsampling_x = hdr.subsampling_y = 1
    hdr.base_qindex = base_qindex
    hdr.lossless = 0
    hdr.refresh_frame_flags = refresh_flags
    if compound_slots is not None:
        var_slot, fixed_slot = compound_slots
        hdr.ref_frame_idx[0] = var_slot    # LAST
        hdr.ref_frame_idx[1] = var_slot    # GOLDEN
        hdr.ref_frame_idx[2] = fixed_slot  # ALTREF (comp_fixed_ref)
        hdr.ref_frame_sign_bias[C.LAST_FRAME] = 0
        hdr.ref_frame_sign_bias[C.GOLDEN_FRAME] = 0
        hdr.ref_frame_sign_bias[C.ALTREF_FRAME] = 1
    else:
        for i in range(C.REFS_PER_FRAME):
            hdr.ref_frame_idx[i] = ref_slot
            hdr.ref_frame_sign_bias[C.LAST_FRAME + i] = 0
    hdr.allow_high_precision_mv = 0
    hdr.interp_filter = C.LITERAL_TO_FILTER_MAP[0]
    hdr.refresh_frame_context = 0
    hdr.frame_parallel_decoding_mode = 1
    hdr.frame_context_idx = 0
    hdr.lf = LoopFilterParams()
    hdr.lf.filter_level = 0
    hdr.seg = SegmentationParams()
    hdr.compute_geometry()
    hdr.log2_tile_cols = _min_log2_tile_cols(hdr.sb_cols)
    hdr.log2_tile_rows = 0
    return hdr


def _min_log2_tile_cols(sb64_cols: int) -> int:
    v = 0
    while (C.MAX_TILE_WIDTH_B64 << v) < sb64_cols:
        v += 1
    return v


def _max_log2_tile_cols(sb64_cols: int) -> int:
    v = 1
    while (sb64_cols >> v) >= C.MIN_TILE_WIDTH_B64:
        v += 1
    return v - 1


def _make_state(hdr: FrameHeader, fc, compound=False) -> FrameParseState:
    from ..decoder.compressed_header import _setup_compound_reference_mode
    ch = CompressedHeader()
    ch.tx_mode = C.ALLOW_32X32
    ch.reference_mode = C.SINGLE_REFERENCE
    if compound:
        ch.reference_mode = C.COMPOUND_REFERENCE
        ch.allow_comp_inter_inter = True
        _setup_compound_reference_mode(hdr, ch)

    class _DS:
        subsampling_x = 1
        subsampling_y = 1
        seg_map_last = None
        use_prev_frame_mvs = False
        prev_ref = None
        prev_mv = None

    return FrameParseState(hdr, ch, fc, None, _DS)


def _uncompressed_header(hdr: FrameHeader, comp_size: int) -> bytes:
    wb = BitWriter()
    wb.f(C.VP9_FRAME_MARKER, 2)
    wb.write_bit(hdr.profile & 1)
    wb.write_bit((hdr.profile >> 1) & 1)
    wb.write_bit(0)                    # show_existing_frame
    wb.write_bit(1)                    # frame_type: non-key
    wb.write_bit(hdr.show_frame)
    wb.write_bit(hdr.error_resilient_mode)
    if not hdr.show_frame:
        wb.write_bit(0)                # intra_only = 0 (hidden inter)
    if not hdr.error_resilient_mode:
        wb.f(0, 2)                     # reset_frame_context = 0
    wb.f(hdr.refresh_frame_flags, 8)
    for i in range(C.REFS_PER_FRAME):
        wb.f(hdr.ref_frame_idx[i], C.REF_FRAMES_LOG2)
        wb.write_bit(hdr.ref_frame_sign_bias[C.LAST_FRAME + i])
    for _ in range(C.REFS_PER_FRAME):
        wb.write_bit(0)                # size NOT taken from this ref
    wb.f(hdr.width - 1, 16)
    wb.f(hdr.height - 1, 16)
    wb.write_bit(0)                    # render == frame size
    wb.write_bit(0)                    # allow_high_precision_mv
    wb.write_bit(0)                    # interp filter: literal follows
    wb.f(0, 2)                         # LITERAL_TO_FILTER_MAP[0] (EIGHTTAP)
    if not hdr.error_resilient_mode:
        wb.write_bit(0)                # refresh_frame_context
        wb.write_bit(1)                # frame_parallel_decoding_mode
    wb.f(0, C.FRAME_CONTEXTS_LOG2)     # frame_context_idx
    wb.f(0, 6)                         # lf filter_level
    wb.f(0, 3)                         # lf sharpness
    wb.write_bit(0)                    # mode_ref_delta_enabled
    wb.f(hdr.base_qindex, 8)
    wb.write_bit(0)                    # y_dc_delta
    wb.write_bit(0)                    # uv_dc_delta
    wb.write_bit(0)                    # uv_ac_delta
    wb.write_bit(0)                    # segmentation
    if hdr.log2_tile_cols < _max_log2_tile_cols(hdr.sb_cols):
        wb.write_bit(0)
    wb.write_bit(0)                    # log2_tile_rows
    wb.f(comp_size, 16)
    return wb.data()


def _compressed_header_inter(compound=False) -> bytes:
    """Inter-frame compressed header with zero probability updates
    (mirror of read_compressed_header's non-intra-only sections)."""
    w = BoolEncoder()
    w.write_literal(C.ALLOW_32X32, 2)
    w.write_bit(0)                     # not TX_MODE_SELECT
    for _ in range(C.TX_32X32 + 1):    # coef prob updates per tx size
        w.write_bit(0)
    no = lambda: w.write(0, C.DIFF_UPDATE_PROB)  # noqa: E731
    for _ in range(C.SKIP_CONTEXTS):
        no()
    for _ in range(C.INTER_MODE_CONTEXTS * (C.INTER_MODES - 1)):
        no()
    # interp_filter != SWITCHABLE: no switchable section
    for _ in range(C.INTRA_INTER_CONTEXTS):
        no()
    if compound:
        # mixed sign biases -> reference-mode bits are read
        # (_read_frame_reference_mode): (1, 0) = COMPOUND_REFERENCE,
        # then comp_ref updates only
        w.write_bit(1)
        w.write_bit(0)
        for _ in range(C.REF_CONTEXTS):
            no()
    else:
        # sign biases all equal -> compound not allowed -> no
        # reference-mode bits; SINGLE_REFERENCE -> single_ref updates
        for _ in range(C.REF_CONTEXTS * 2):
            no()
    for _ in range(C.BLOCK_SIZE_GROUPS * (C.INTRA_MODES - 1)):
        no()
    for _ in range(C.PARTITION_CONTEXTS * (C.PARTITION_TYPES - 1)):
        no()
    # mv probs (update_mv_prob bools at MV_UPDATE_PROB)
    nomv = lambda: w.write(0, C.MV_UPDATE_PROB)  # noqa: E731
    for _ in range(C.MV_JOINTS - 1):
        nomv()
    for _ in range(2):
        nomv()                                   # sign
        for _ in range(C.MV_CLASSES - 1):
            nomv()
        for _ in range(C.CLASS0_SIZE - 1):
            nomv()
        for _ in range(C.MV_OFFSET_BITS):
            nomv()
    for _ in range(2):
        for _ in range(C.CLASS0_SIZE * (C.MV_FP_SIZE - 1)):
            nomv()
        for _ in range(C.MV_FP_SIZE - 1):
            nomv()
    # allow_hp == 0: no hp updates
    return w.stop()


def _write_tile(st: FrameParseState, hdr: FrameHeader, fc,
                mv_fn=None) -> bytes:
    tile_cols = 1 << hdr.log2_tile_cols
    chunks = []
    partition_probs = fc.partition.tolist()
    for tci in range(tile_cols):
        col_start = _tile_offset(tci, hdr.mi_cols, hdr.log2_tile_cols)
        col_end = _tile_offset(tci + 1, hdr.mi_cols, hdr.log2_tile_cols)
        w = BoolEncoder()
        xd = Xd()
        xd.tile = TileInfo(0, hdr.mi_rows, col_start, col_end)
        for mi_row in range(0, hdr.mi_rows, C.MI_BLOCK_SIZE):
            st.zero_left_ctx()
            for mi_col in range(col_start, col_end, C.MI_BLOCK_SIZE):
                _encode_partition(st, xd, w, partition_probs, mi_row,
                                  mi_col, C.BLOCK_64X64, 4, mv_fn)
        chunks.append(w.stop())
    out = bytearray()
    for i, c in enumerate(chunks):
        if i != len(chunks) - 1:
            out += len(c).to_bytes(4, "big")
        out += c
    return bytes(out)


def _tile_offset(idx, mis, log2):
    sb_cols = ((mis + 7) & ~7) >> C.MI_BLOCK_SIZE_LOG2
    return min(((idx * sb_cols) >> log2) << C.MI_BLOCK_SIZE_LOG2, mis)


def _encode_partition(st, xd, w, probs_all, mi_row, mi_col, bsize,
                      n4x4_l2, mv_fn=None):
    if mi_row >= st.mi_rows or mi_col >= st.mi_cols:
        return
    n8x8_l2 = n4x4_l2 - 1
    num8 = 1 << n8x8_l2
    hbs = num8 >> 1
    has_rows = (mi_row + hbs) < st.mi_rows
    has_cols = (mi_col + hbs) < st.mi_cols
    fits = has_rows and has_cols
    partition = (C.PARTITION_NONE if (not hbs or fits)
                 else C.PARTITION_SPLIT)
    ctx = _dec_partition_plane_context(st, mi_row, mi_col, n8x8_l2)
    probs = probs_all[ctx]
    if has_rows and has_cols:
        w.write_tree(M.PARTITION_TREE, probs, _PARTITION_PATHS, partition)
    elif not has_rows and has_cols:
        w.write(1, probs[1])           # SPLIT
    elif has_rows and not has_cols:
        w.write(1, probs[2])           # SPLIT
    subsize = int(M.SUBSIZE_LOOKUP[partition][bsize])
    if partition == C.PARTITION_NONE:
        _encode_block(st, xd, w, mi_row, mi_col, subsize,
                      max(n4x4_l2, 1), max(n4x4_l2, 1), mv_fn)
    else:
        _encode_partition(st, xd, w, probs_all, mi_row, mi_col, subsize,
                          n8x8_l2, mv_fn)
        _encode_partition(st, xd, w, probs_all, mi_row, mi_col + hbs,
                          subsize, n8x8_l2, mv_fn)
        _encode_partition(st, xd, w, probs_all, mi_row + hbs, mi_col,
                          subsize, n8x8_l2, mv_fn)
        _encode_partition(st, xd, w, probs_all, mi_row + hbs, mi_col + hbs,
                          subsize, n8x8_l2, mv_fn)
    if bsize >= C.BLOCK_8X8 and (bsize == C.BLOCK_8X8
                                 or partition != C.PARTITION_SPLIT):
        _dec_update_partition_context(st, mi_row, mi_col, subsize, num8)


def _encode_block(st, xd, w, mi_row, mi_col, bsize, bwl, bhl, mv_fn=None):
    """One ZEROMV (or, with mv_fn, NEWMV) LAST skip inter block;
    contexts via decodemv.  mv_fn(mi_row, mi_col) -> (row, col) in
    1/8-pel units (EVEN components: frames code allow_hp=0); (0, 0)
    writes the classic ZEROMV block."""
    g = st.mi
    fc = st.fc
    bw = 1 << (bwl - 1)
    bh = 1 << (bhl - 1)
    x_mis = min(bw, st.mi_cols - mi_col)
    y_mis = min(bh, st.mi_rows - mi_row)

    g.sb_type[mi_row, mi_col] = bsize
    xd.mb_to_top_edge = -((mi_row * C.MI_SIZE) * 8)
    xd.mb_to_bottom_edge = ((st.mi_rows - bh - mi_row) * C.MI_SIZE) * 8
    xd.mb_to_left_edge = -((mi_col * C.MI_SIZE) * 8)
    xd.mb_to_right_edge = ((st.mi_cols - bw - mi_col) * C.MI_SIZE) * 8
    xd.above = g.at(mi_row - 1, mi_col) if mi_row > 0 else None
    xd.left = (g.at(mi_row, mi_col - 1)
               if mi_col > xd.tile.mi_col_start else None)

    # skip = 1 (fc.skip[ctx]; _read_skip parity)
    above, left = xd.above, xd.left
    skip_ctx = ((above.skip if above is not None else 0)
                + (left.skip if left is not None else 0))
    w.write(1, int(fc.skip[skip_ctx]))
    # is_inter = 1 (_read_is_inter_block parity)
    ii_ctx = decodemv._get_intra_inter_context(xd)
    w.write(1, int(fc.intra_inter[ii_ctx]))
    # tx_size: allow_select = (!skip || !inter) = False -> no bits
    g.segment_id[mi_row, mi_col] = 0
    if st.reference_mode == C.COMPOUND_REFERENCE:
        # comp_ref bit 0 -> first var ref (LAST); fixed ref = ALTREF
        # (_read_ref_frames COMPOUND branch)
        cr_ctx = decodemv._get_pred_context_comp_ref_p(st, xd)
        w.write(0, int(fc.comp_ref[cr_ctx]))
        idx = st.ref_frame_sign_bias[st.comp_fixed_ref]
        ref = [0, 0]
        ref[idx] = st.comp_fixed_ref
        ref[1 - idx] = st.comp_var_ref[0]
        g.ref[mi_row, mi_col, 0] = ref[0]
        g.ref[mi_row, mi_col, 1] = ref[1]
    else:
        # SINGLE_REFERENCE; single_ref p1 bit 0 -> LAST_FRAME
        p1_ctx = decodemv._get_pred_context_single_ref_p1(xd)
        w.write(0, int(fc.single_ref[p1_ctx][0]))
        g.ref[mi_row, mi_col, 0] = C.LAST_FRAME
        g.ref[mi_row, mi_col, 1] = C.NONE_FRAME
    # inter mode via the tree at the mvref-derived mode context
    mode_ctx = mvref.get_mode_context(st, xd, bsize, mi_row, mi_col)
    mv = mv_fn(mi_row, mi_col) if mv_fn is not None else (0, 0)
    if mv == (0, 0):
        w.write_tree(M.INTER_MODE_TREE, fc.inter_mode[mode_ctx].tolist(),
                     _INTER_MODE_PATHS, C.ZEROMV - C.NEARESTMV)
        g.mode[mi_row, mi_col] = C.ZEROMV
        g.mv[mi_row, mi_col] = 0
    else:
        # NEWMV: diff vs the decoder's own best_ref derivation
        # (read_inter_block_mode_info NEWMV branch parity)
        w.write_tree(M.INTER_MODE_TREE, fc.inter_mode[mode_ctx].tolist(),
                     _INTER_MODE_PATHS, C.NEWMV - C.NEARESTMV)
        tmp, refmv_count = mvref.dec_find_mv_refs(
            st, xd, C.NEWMV, C.LAST_FRAME, bsize, mi_row, mi_col, -1)
        best = mvref.lower_mv_precision(tmp[refmv_count - 1], False)
        _write_mv(w, fc, (mv[0] - best[0], mv[1] - best[1]))
        g.mode[mi_row, mi_col] = C.NEWMV
        g.mv[mi_row, mi_col] = 0
        g.mv[mi_row, mi_col, 0, 0] = mv[0]
        g.mv[mi_row, mi_col, 0, 1] = mv[1]
    # interp_filter != SWITCHABLE: no bits

    # grid updates (read_mode_info tail parity)
    g.skip[mi_row, mi_col] = 1
    g.tx_size[mi_row, mi_col] = min(
        int(M.MAX_TXSIZE_LOOKUP[bsize]),
        int(M.TX_MODE_TO_BIGGEST_TX_SIZE[C.ALLOW_32X32]))
    g.interp_filter[mi_row, mi_col] = st.interp_filter
    decodemv._replicate(st, mi_row, mi_col, x_mis, y_mis)
