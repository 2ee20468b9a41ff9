"""Mode-info decode: segment ids, skip, tx size, intra modes, refs, MVs.

Parity with vp9/decoder/vp9_decodemv.c (vp9_read_mode_info:811,
read_intra_frame_mode_info:192, read_inter_frame_mode_info:786,
read_inter_block_mode_info:689, read_mv_component:235, assign_mv:402)
and the context helpers in vp9/common/vp9_pred_common.{h,c}.

The port parses with the C++ parser (native/); this module is here for
the encoder (encoder/), whose symbol contexts come from the parse side.
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from . import constants as C
from . import mvref
from .bitreader import BoolDecoder


# ----------------------------------------------------------- small helpers

def _read_intra_mode(r: BoolDecoder, probs) -> int:
    return r.read_tree(M.INTRA_MODE_TREE, probs)


def _read_inter_mode(state, r: BoolDecoder, ctx: int) -> int:
    mode = r.read_tree(M.INTER_MODE_TREE, state.fc.inter_mode[ctx])
    if state.counts is not None:
        state.counts.inter_mode[ctx][mode] += 1
    return C.NEARESTMV + mode


def _read_segment_id(r: BoolDecoder, seg) -> int:
    return r.read_tree(M.SEGMENT_TREE, seg.tree_probs)


def _above_block_mode(mi, above, b):
    if b in (0, 1):
        if above is None or above.is_inter:
            return C.DC_PRED
        return above.y_mode(b + 2)
    return mi.bmi_as_mode(b - 2)


def _left_block_mode(mi, left, b):
    if b in (0, 2):
        if left is None or left.is_inter:
            return C.DC_PRED
        return left.y_mode(b + 1)
    return mi.bmi_as_mode(b - 1)


def _get_y_mode_probs(mi, above, left, b):
    return M.KF_Y_MODE_PROB[_above_block_mode(mi, above, b)][
        _left_block_mode(mi, left, b)]


# ----------------------------------------------------------- tx size

def _get_tx_size_context(xd, max_tx_size: int) -> int:
    above, left = xd.above, xd.left
    above_ctx = (above.tx_size if (above is not None and not above.skip)
                 else max_tx_size)
    left_ctx = (left.tx_size if (left is not None and not left.skip)
                else max_tx_size)
    if left is None:
        left_ctx = above_ctx
    if above is None:
        above_ctx = left_ctx
    return int((above_ctx + left_ctx) > max_tx_size)


def _read_selected_tx_size(state, xd, max_tx_size: int, r: BoolDecoder) -> int:
    ctx = _get_tx_size_context(xd, max_tx_size)
    fc = state.fc
    if max_tx_size == C.TX_32X32:
        probs, cnt = fc.tx32[ctx], (state.counts.tx32[ctx]
                                    if state.counts else None)
    elif max_tx_size == C.TX_16X16:
        probs, cnt = fc.tx16[ctx], (state.counts.tx16[ctx]
                                    if state.counts else None)
    else:
        probs, cnt = fc.tx8[ctx], (state.counts.tx8[ctx]
                                   if state.counts else None)
    tx_size = r.read(probs[0])
    if tx_size != C.TX_4X4 and max_tx_size >= C.TX_16X16:
        tx_size += r.read(probs[1])
        if tx_size != C.TX_8X8 and max_tx_size >= C.TX_32X32:
            tx_size += r.read(probs[2])
    if cnt is not None:
        cnt[tx_size] += 1
    return tx_size


def _read_tx_size(state, xd, bsize: int, allow_select: bool,
                  r: BoolDecoder) -> int:
    max_tx_size = int(M.MAX_TXSIZE_LOOKUP[bsize])
    if (allow_select and state.tx_mode == C.TX_MODE_SELECT
            and bsize >= C.BLOCK_8X8):
        return _read_selected_tx_size(state, xd, max_tx_size, r)
    return min(max_tx_size, int(M.TX_MODE_TO_BIGGEST_TX_SIZE[state.tx_mode]))


# ----------------------------------------------------------- segment / skip

def _read_skip(state, xd, segment_id: int, r: BoolDecoder) -> int:
    if state.seg.active(segment_id, C.SEG_LVL_SKIP):
        return 1
    above, left = xd.above, xd.left
    ctx = ((above.skip if above is not None else 0)
           + (left.skip if left is not None else 0))
    skip = r.read(state.fc.skip[ctx])
    if state.counts is not None:
        state.counts.skip[ctx][skip] += 1
    return skip


def _read_intra_segment_id(state, mi_row, mi_col, x_mis, y_mis,
                           r: BoolDecoder) -> int:
    seg = state.seg
    if not seg.enabled:
        return 0
    sl = np.s_[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis]
    if not seg.update_map:
        state.seg_map_cur[sl] = (state.seg_map_last[sl]
                                 if state.seg_map_last is not None else 0)
        return 0
    segment_id = _read_segment_id(r, seg)
    state.seg_map_cur[sl] = segment_id
    return segment_id


def _read_inter_segment_id(state, xd, mi_row, mi_col, x_mis, y_mis,
                           r: BoolDecoder) -> int:
    seg = state.seg
    if not seg.enabled:
        return 0
    sl = np.s_[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis]
    predicted = (int(state.seg_map_last[sl].min())
                 if state.seg_map_last is not None else 0)
    if not seg.update_map:
        state.seg_map_cur[sl] = (state.seg_map_last[sl]
                                 if state.seg_map_last is not None else 0)
        return predicted
    if seg.temporal_update:
        above, left = xd.above, xd.left
        ctx = ((above.seg_id_predicted if above is not None else 0)
               + (left.seg_id_predicted if left is not None else 0))
        pred_flag = r.read(seg.pred_probs[ctx])
        state.mi.seg_id_predicted[mi_row, mi_col] = pred_flag
        segment_id = predicted if pred_flag else _read_segment_id(r, seg)
    else:
        segment_id = _read_segment_id(r, seg)
    state.seg_map_cur[sl] = segment_id
    return segment_id


# ----------------------------------------------------------- reference frames

def _get_reference_mode_context(state, xd) -> int:
    above, left = xd.above, xd.left
    fixed = state.comp_fixed_ref
    if above is not None and left is not None:
        if not above.has_second_ref and not left.has_second_ref:
            ctx = int(above.ref_frame(0) == fixed) ^ int(
                left.ref_frame(0) == fixed)
        elif not above.has_second_ref:
            ctx = 2 + int(above.ref_frame(0) == fixed or not above.is_inter)
        elif not left.has_second_ref:
            ctx = 2 + int(left.ref_frame(0) == fixed or not left.is_inter)
        else:
            ctx = 4
    elif above is not None or left is not None:
        edge = above if above is not None else left
        ctx = 3 if edge.has_second_ref else int(edge.ref_frame(0) == fixed)
    else:
        ctx = 1
    return ctx


def _get_pred_context_comp_ref_p(state, xd) -> int:
    above, left = xd.above, xd.left
    fix_ref_idx = state.ref_frame_sign_bias[state.comp_fixed_ref]
    var_ref_idx = 0 if fix_ref_idx else 1
    fixed = state.comp_fixed_ref
    var0, var1 = state.comp_var_ref

    if above is not None and left is not None:
        above_intra = not above.is_inter
        left_intra = not left.is_inter
        if above_intra and left_intra:
            ctx = 2
        elif above_intra or left_intra:
            edge = left if above_intra else above
            if not edge.has_second_ref:
                ctx = 1 + 2 * int(edge.ref_frame(0) != var1)
            else:
                ctx = 1 + 2 * int(edge.ref_frame(var_ref_idx) != var1)
        else:
            l_sg = not left.has_second_ref
            a_sg = not above.has_second_ref
            vrfa = above.ref_frame(0) if a_sg else above.ref_frame(var_ref_idx)
            vrfl = left.ref_frame(0) if l_sg else left.ref_frame(var_ref_idx)
            if vrfa == vrfl and var1 == vrfa:
                ctx = 0
            elif l_sg and a_sg:
                if ((vrfa == fixed and vrfl == var0)
                        or (vrfl == fixed and vrfa == var0)):
                    ctx = 4
                elif vrfa == vrfl:
                    ctx = 3
                else:
                    ctx = 1
            elif l_sg or a_sg:
                vrfc = vrfa if l_sg else vrfl
                rfs = vrfa if a_sg else vrfl
                if vrfc == var1 and rfs != var1:
                    ctx = 1
                elif rfs == var1 and vrfc != var1:
                    ctx = 2
                else:
                    ctx = 4
            elif vrfa == vrfl:
                ctx = 4
            else:
                ctx = 2
    elif above is not None or left is not None:
        edge = above if above is not None else left
        if not edge.is_inter:
            ctx = 2
        elif edge.has_second_ref:
            ctx = 4 * int(edge.ref_frame(var_ref_idx) != var1)
        else:
            ctx = 3 * int(edge.ref_frame(0) != var1)
    else:
        ctx = 2
    return ctx


def _get_pred_context_single_ref_p1(xd) -> int:
    above, left = xd.above, xd.left
    LAST = C.LAST_FRAME
    if above is not None and left is not None:
        above_intra = not above.is_inter
        left_intra = not left.is_inter
        if above_intra and left_intra:
            ctx = 2
        elif above_intra or left_intra:
            edge = left if above_intra else above
            if not edge.has_second_ref:
                ctx = 4 * int(edge.ref_frame(0) == LAST)
            else:
                ctx = 1 + int(edge.ref_frame(0) == LAST
                              or edge.ref_frame(1) == LAST)
        else:
            a2, l2 = above.has_second_ref, left.has_second_ref
            a0, a1 = above.ref_frame(0), above.ref_frame(1)
            l0, l1 = left.ref_frame(0), left.ref_frame(1)
            if a2 and l2:
                ctx = 1 + int(a0 == LAST or a1 == LAST
                              or l0 == LAST or l1 == LAST)
            elif a2 or l2:
                rfs = a0 if not a2 else l0
                crf1 = a0 if a2 else l0
                crf2 = a1 if a2 else l1
                if rfs == LAST:
                    ctx = 3 + int(crf1 == LAST or crf2 == LAST)
                else:
                    ctx = int(crf1 == LAST or crf2 == LAST)
            else:
                ctx = 2 * int(a0 == LAST) + 2 * int(l0 == LAST)
    elif above is not None or left is not None:
        edge = above if above is not None else left
        if not edge.is_inter:
            ctx = 2
        elif not edge.has_second_ref:
            ctx = 4 * int(edge.ref_frame(0) == LAST)
        else:
            ctx = 1 + int(edge.ref_frame(0) == LAST
                          or edge.ref_frame(1) == LAST)
    else:
        ctx = 2
    return ctx


def _get_pred_context_single_ref_p2(xd) -> int:
    above, left = xd.above, xd.left
    LAST, GOLDEN, ALTREF = C.LAST_FRAME, C.GOLDEN_FRAME, C.ALTREF_FRAME
    if above is not None and left is not None:
        above_intra = not above.is_inter
        left_intra = not left.is_inter
        if above_intra and left_intra:
            ctx = 2
        elif above_intra or left_intra:
            edge = left if above_intra else above
            if not edge.has_second_ref:
                if edge.ref_frame(0) == LAST:
                    ctx = 3
                else:
                    ctx = 4 * int(edge.ref_frame(0) == GOLDEN)
            else:
                ctx = 1 + 2 * int(edge.ref_frame(0) == GOLDEN
                                  or edge.ref_frame(1) == GOLDEN)
        else:
            a2, l2 = above.has_second_ref, left.has_second_ref
            a0, a1 = above.ref_frame(0), above.ref_frame(1)
            l0, l1 = left.ref_frame(0), left.ref_frame(1)
            if a2 and l2:
                if a0 == l0 and a1 == l1:
                    ctx = 3 * int(a0 == GOLDEN or a1 == GOLDEN
                                  or l0 == GOLDEN or l1 == GOLDEN)
                else:
                    ctx = 2
            elif a2 or l2:
                rfs = a0 if not a2 else l0
                crf1 = a0 if a2 else l0
                crf2 = a1 if a2 else l1
                if rfs == GOLDEN:
                    ctx = 3 + int(crf1 == GOLDEN or crf2 == GOLDEN)
                elif rfs == ALTREF:
                    ctx = int(crf1 == GOLDEN or crf2 == GOLDEN)
                else:
                    ctx = 1 + 2 * int(crf1 == GOLDEN or crf2 == GOLDEN)
            else:
                if a0 == LAST and l0 == LAST:
                    ctx = 3
                elif a0 == LAST or l0 == LAST:
                    edge0 = l0 if a0 == LAST else a0
                    ctx = 4 * int(edge0 == GOLDEN)
                else:
                    ctx = 2 * int(a0 == GOLDEN) + 2 * int(l0 == GOLDEN)
    elif above is not None or left is not None:
        edge = above if above is not None else left
        if (not edge.is_inter
                or (edge.ref_frame(0) == LAST and not edge.has_second_ref)):
            ctx = 2
        elif not edge.has_second_ref:
            ctx = 4 * int(edge.ref_frame(0) == GOLDEN)
        else:
            ctx = 3 * int(edge.ref_frame(0) == GOLDEN
                          or edge.ref_frame(1) == GOLDEN)
    else:
        ctx = 2
    return ctx


def _read_ref_frames(state, xd, r: BoolDecoder, segment_id: int):
    fc = state.fc
    counts = state.counts
    if state.seg.active(segment_id, C.SEG_LVL_REF_FRAME):
        return [state.seg.data(segment_id, C.SEG_LVL_REF_FRAME), C.NONE_FRAME]
    if state.reference_mode == C.REFERENCE_MODE_SELECT:
        ctx = _get_reference_mode_context(state, xd)
        mode = r.read(fc.comp_inter[ctx])
        if counts is not None:
            counts.comp_inter[ctx][mode] += 1
    else:
        mode = state.reference_mode
    if mode == C.COMPOUND_REFERENCE:
        idx = state.ref_frame_sign_bias[state.comp_fixed_ref]
        ctx = _get_pred_context_comp_ref_p(state, xd)
        bit = r.read(fc.comp_ref[ctx])
        if counts is not None:
            counts.comp_ref[ctx][bit] += 1
        ref = [0, 0]
        ref[idx] = state.comp_fixed_ref
        ref[1 - idx] = state.comp_var_ref[bit]
        return ref
    # single reference
    ctx0 = _get_pred_context_single_ref_p1(xd)
    bit0 = r.read(fc.single_ref[ctx0][0])
    if counts is not None:
        counts.single_ref[ctx0][0][bit0] += 1
    if bit0:
        ctx1 = _get_pred_context_single_ref_p2(xd)
        bit1 = r.read(fc.single_ref[ctx1][1])
        if counts is not None:
            counts.single_ref[ctx1][1][bit1] += 1
        return [C.ALTREF_FRAME if bit1 else C.GOLDEN_FRAME, C.NONE_FRAME]
    return [C.LAST_FRAME, C.NONE_FRAME]


# ----------------------------------------------------------- motion vectors

def _read_mv_component(state, r: BoolDecoder, comp: int, usehp: bool) -> int:
    fc = state.fc
    sign = r.read(fc.mv_sign[comp])
    mv_class = r.read_tree(M.MV_CLASS_TREE, fc.mv_classes[comp])
    class0 = mv_class == 0
    if class0:
        d = r.read(fc.mv_class0[comp][0])
        mag = 0
    else:
        d = 0
        n = mv_class + C.CLASS0_BITS - 1
        for i in range(n):
            d |= r.read(fc.mv_bits[comp][i]) << i
        mag = C.CLASS0_SIZE << (mv_class + 2)
    fr = r.read_tree(M.MV_FP_TREE,
                     fc.mv_class0_fp[comp][d] if class0 else fc.mv_fp[comp])
    hp = (r.read(fc.mv_class0_hp[comp] if class0 else fc.mv_hp[comp])
          if usehp else 1)
    mag += ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def _get_mv_class(z: int):
    q = z >> 3
    c = 0 if q == 0 else min(10, q.bit_length() - 1)
    base = 0 if c == 0 else C.CLASS0_SIZE << (c + 2)
    return c, z - base


def _inc_mv(counts, diff):
    if counts is None:
        return
    row, col = diff
    j = (2 if col == 0 else 3) if row != 0 else (0 if col == 0 else 1)
    counts.mv_joints[j] += 1
    for comp, v in ((0, row), (1, col)):
        if v == 0:
            continue
        s = 1 if v < 0 else 0
        counts.mv_sign[comp][s] += 1
        z = (-v if s else v) - 1
        c, o = _get_mv_class(z)
        counts.mv_classes[comp][c] += 1
        d = o >> 3
        f = (o >> 1) & 3
        e = o & 1
        if c == 0:
            counts.mv_class0[comp][d] += 1
            counts.mv_class0_fp[comp][d][f] += 1
            counts.mv_class0_hp[comp][e] += 1
        else:
            b = c + C.CLASS0_BITS - 1
            for i in range(b):
                counts.mv_bits[comp][i][(d >> i) & 1] += 1
            counts.mv_fp[comp][f] += 1
            counts.mv_hp[comp][e] += 1


def _read_mv(state, r: BoolDecoder, ref, allow_hp: bool):
    joint = r.read_tree(M.MV_JOINT_TREE, state.fc.mv_joints)
    usehp = allow_hp and mvref.use_mv_hp(ref)
    diff_row = diff_col = 0
    if joint in (C.MV_JOINT_HZVNZ, C.MV_JOINT_HNZVNZ):
        diff_row = _read_mv_component(state, r, 0, usehp)
    if joint in (C.MV_JOINT_HNZVZ, C.MV_JOINT_HNZVNZ):
        diff_col = _read_mv_component(state, r, 1, usehp)
    _inc_mv(state.counts, (diff_row, diff_col))
    return (ref[0] + diff_row, ref[1] + diff_col)


def _is_mv_valid(mv) -> bool:
    return (C.MV_LOW < mv[0] < C.MV_UPP) and (C.MV_LOW < mv[1] < C.MV_UPP)


def _assign_mv(state, r: BoolDecoder, mode, best_ref_mvs, near_nearest,
               is_compound, allow_hp):
    """Returns (mv_pair, ok)."""
    if mode == C.NEWMV:
        mv = []
        ok = True
        for i in range(1 + is_compound):
            m = _read_mv(state, r, best_ref_mvs[i], allow_hp)
            ok = ok and _is_mv_valid(m)
            mv.append(m)
        if len(mv) < 2:
            mv.append((0, 0))
        return mv, ok
    if mode in (C.NEARMV, C.NEARESTMV):
        return [near_nearest[0], near_nearest[1]], True
    if mode == C.ZEROMV:
        return [(0, 0), (0, 0)], True
    return [(0, 0), (0, 0)], False


# ----------------------------------------------------------- intra blocks

def _read_intra_mode_y(state, r, size_group: int) -> int:
    mode = _read_intra_mode(r, state.fc.y_mode[size_group])
    if state.counts is not None:
        state.counts.y_mode[size_group][mode] += 1
    return mode


def _read_intra_mode_uv(state, r, y_mode: int) -> int:
    mode = _read_intra_mode(r, state.fc.uv_mode[y_mode])
    if state.counts is not None:
        state.counts.uv_mode[y_mode][mode] += 1
    return mode


def _read_intra_frame_mode_info(state, xd, r, mi_row, mi_col):
    g = state.mi
    mi = g.at(mi_row, mi_col)
    above, left = xd.above, xd.left
    bsize = mi.sb_type
    bmode = g.bmi_mode[mi_row, mi_col]

    if bsize == C.BLOCK_4X4:
        for i in range(4):
            bmode[i] = _read_intra_mode(
                r, _get_y_mode_probs(mi, above, left, i))
        g.mode[mi_row, mi_col] = bmode[3]
    elif bsize == C.BLOCK_4X8:
        bmode[0] = bmode[2] = _read_intra_mode(
            r, _get_y_mode_probs(mi, above, left, 0))
        bmode[1] = bmode[3] = _read_intra_mode(
            r, _get_y_mode_probs(mi, above, left, 1))
        g.mode[mi_row, mi_col] = bmode[3]
    elif bsize == C.BLOCK_8X4:
        bmode[0] = bmode[1] = _read_intra_mode(
            r, _get_y_mode_probs(mi, above, left, 0))
        bmode[2] = bmode[3] = _read_intra_mode(
            r, _get_y_mode_probs(mi, above, left, 2))
        g.mode[mi_row, mi_col] = bmode[3]
    else:
        g.mode[mi_row, mi_col] = _read_intra_mode(
            r, _get_y_mode_probs(mi, above, left, 0))
    g.uv_mode[mi_row, mi_col] = _read_intra_mode(
        r, M.KF_UV_MODE_PROB[int(g.mode[mi_row, mi_col])])


def _read_intra_block_mode_info(state, xd, r, mi_row, mi_col):
    g = state.mi
    bsize = int(g.sb_type[mi_row, mi_col])
    bmode = g.bmi_mode[mi_row, mi_col]
    if bsize == C.BLOCK_4X4:
        for i in range(4):
            bmode[i] = _read_intra_mode_y(state, r, 0)
        g.mode[mi_row, mi_col] = bmode[3]
    elif bsize == C.BLOCK_4X8:
        bmode[0] = bmode[2] = _read_intra_mode_y(state, r, 0)
        bmode[1] = bmode[3] = _read_intra_mode_y(state, r, 0)
        g.mode[mi_row, mi_col] = bmode[3]
    elif bsize == C.BLOCK_8X4:
        bmode[0] = bmode[1] = _read_intra_mode_y(state, r, 0)
        bmode[2] = bmode[3] = _read_intra_mode_y(state, r, 0)
        g.mode[mi_row, mi_col] = bmode[3]
    else:
        g.mode[mi_row, mi_col] = _read_intra_mode_y(
            state, r, int(M.SIZE_GROUP[bsize]))
    g.uv_mode[mi_row, mi_col] = _read_intra_mode_uv(
        state, r, int(g.mode[mi_row, mi_col]))
    # so switchable-filter context never sees an inter filter here
    g.interp_filter[mi_row, mi_col] = C.SWITCHABLE_FILTERS
    g.ref[mi_row, mi_col, 0] = C.INTRA_FRAME
    g.ref[mi_row, mi_col, 1] = C.NONE_FRAME


# ----------------------------------------------------------- inter blocks

def _get_pred_context_switchable_interp(xd) -> int:
    left_type = (xd.left.interp_filter if xd.left is not None
                 else C.SWITCHABLE_FILTERS)
    above_type = (xd.above.interp_filter if xd.above is not None
                  else C.SWITCHABLE_FILTERS)
    if left_type == above_type:
        return left_type
    if left_type == C.SWITCHABLE_FILTERS:
        return above_type
    if above_type == C.SWITCHABLE_FILTERS:
        return left_type
    return C.SWITCHABLE_FILTERS


def _read_switchable_interp_filter(state, xd, r) -> int:
    ctx = _get_pred_context_switchable_interp(xd)
    t = r.read_tree(M.SWITCHABLE_INTERP_TREE, state.fc.switchable_interp[ctx])
    if state.counts is not None:
        state.counts.switchable_interp[ctx][t] += 1
    return t


def _get_intra_inter_context(xd) -> int:
    above, left = xd.above, xd.left
    if above is not None and left is not None:
        above_intra = not above.is_inter
        left_intra = not left.is_inter
        return 3 if (above_intra and left_intra) else int(
            above_intra or left_intra)
    if above is not None or left is not None:
        edge = above if above is not None else left
        return 2 * int(not edge.is_inter)
    return 0


def _read_is_inter_block(state, xd, segment_id, r) -> int:
    if state.seg.active(segment_id, C.SEG_LVL_REF_FRAME):
        return int(state.seg.data(segment_id, C.SEG_LVL_REF_FRAME)
                   != C.INTRA_FRAME)
    ctx = _get_intra_inter_context(xd)
    is_inter = r.read(state.fc.intra_inter[ctx])
    if state.counts is not None:
        state.counts.intra_inter[ctx][is_inter] += 1
    return is_inter


def _read_inter_block_mode_info(state, xd, r, mi_row, mi_col):
    g = state.mi
    bsize = int(g.sb_type[mi_row, mi_col])
    allow_hp = state.allow_high_precision_mv
    segment_id = int(g.segment_id[mi_row, mi_col])
    corrupted = False

    ref_frames = _read_ref_frames(state, xd, r, segment_id)
    g.ref[mi_row, mi_col, 0] = ref_frames[0]
    g.ref[mi_row, mi_col, 1] = ref_frames[1]
    is_compound = int(ref_frames[1] > C.INTRA_FRAME)
    inter_mode_ctx = mvref.get_mode_context(state, xd, bsize, mi_row, mi_col)

    mode = C.ZEROMV
    if state.seg.active(segment_id, C.SEG_LVL_SKIP):
        mode = C.ZEROMV
        if bsize < C.BLOCK_8X8:
            raise ValueError("seg-skip on sub-8x8 block (corrupt stream)")
    elif bsize >= C.BLOCK_8X8:
        mode = _read_inter_mode(state, r, inter_mode_ctx)

    g.interp_filter[mi_row, mi_col] = (
        _read_switchable_interp_filter(state, xd, r)
        if state.interp_filter == C.SWITCHABLE else state.interp_filter)

    best_ref_mvs = [(0, 0), (0, 0)]
    if bsize < C.BLOCK_8X8:
        num_4x4_w = 1 << xd.bmode_blocks_wl
        num_4x4_h = 1 << xd.bmode_blocks_hl
        bmi = g.bmi_mv[mi_row, mi_col]
        got_mv_refs_for_new = False
        best_sub8x8 = [(0, 0), (-32768, -32768)]
        b_mode = C.ZEROMV
        for idy in range(0, 2, num_4x4_h):
            for idx in range(0, 2, num_4x4_w):
                j = idy * 2 + idx
                b_mode = _read_inter_mode(state, r, inter_mode_ctx)
                if b_mode in (C.NEARESTMV, C.NEARMV):
                    for ref in range(1 + is_compound):
                        best_sub8x8[ref] = mvref.append_sub8x8_mvs_for_idx(
                            state, xd, b_mode, j, ref, ref_frames[ref],
                            mi_row, mi_col, bsize, bmi)
                elif b_mode == C.NEWMV and not got_mv_refs_for_new:
                    for ref in range(1 + is_compound):
                        tmp, _ = mvref.dec_find_mv_refs(
                            state, xd, C.NEWMV, ref_frames[ref], bsize,
                            mi_row, mi_col, -1)
                        best_ref_mvs[ref] = mvref.lower_mv_precision(
                            tmp[0], allow_hp)
                        got_mv_refs_for_new = True
                mv, ok = _assign_mv(state, r, b_mode, best_ref_mvs,
                                    best_sub8x8, is_compound, allow_hp)
                if not ok:
                    corrupted = True
                    break
                for ref in range(2):
                    bmi[j, ref, 0] = mv[ref][0]
                    bmi[j, ref, 1] = mv[ref][1]
                if num_4x4_h == 2:
                    bmi[j + 2] = bmi[j]
                if num_4x4_w == 2:
                    bmi[j + 1] = bmi[j]
            if corrupted:
                break
        g.mode[mi_row, mi_col] = b_mode
        g.mv[mi_row, mi_col] = bmi[3]
    else:
        g.mode[mi_row, mi_col] = mode
        if mode != C.ZEROMV:
            for ref in range(1 + is_compound):
                tmp, refmv_count = mvref.dec_find_mv_refs(
                    state, xd, mode, ref_frames[ref], bsize,
                    mi_row, mi_col, -1)
                best_ref_mvs[ref] = mvref.lower_mv_precision(
                    tmp[refmv_count - 1], allow_hp)
        mv, ok = _assign_mv(state, r, mode, best_ref_mvs, best_ref_mvs,
                            is_compound, allow_hp)
        corrupted |= not ok
        for ref in range(2):
            g.mv[mi_row, mi_col, ref, 0] = mv[ref][0]
            g.mv[mi_row, mi_col, ref, 1] = mv[ref][1]
    return corrupted


# ----------------------------------------------------------- entry point

def read_mode_info(state, xd, r: BoolDecoder, mi_row: int, mi_col: int,
                   x_mis: int, y_mis: int):
    g = state.mi
    if state.frame_is_intra_only:
        g.segment_id[mi_row, mi_col] = _read_intra_segment_id(
            state, mi_row, mi_col, x_mis, y_mis, r)
        g.skip[mi_row, mi_col] = _read_skip(
            state, xd, int(g.segment_id[mi_row, mi_col]), r)
        g.tx_size[mi_row, mi_col] = _read_tx_size(
            state, xd, int(g.sb_type[mi_row, mi_col]), True, r)
        g.ref[mi_row, mi_col, 0] = C.INTRA_FRAME
        g.ref[mi_row, mi_col, 1] = C.NONE_FRAME
        _read_intra_frame_mode_info(state, xd, r, mi_row, mi_col)
    else:
        g.segment_id[mi_row, mi_col] = _read_inter_segment_id(
            state, xd, mi_row, mi_col, x_mis, y_mis, r)
        g.skip[mi_row, mi_col] = _read_skip(
            state, xd, int(g.segment_id[mi_row, mi_col]), r)
        inter_block = _read_is_inter_block(
            state, xd, int(g.segment_id[mi_row, mi_col]), r)
        g.tx_size[mi_row, mi_col] = _read_tx_size(
            state, xd, int(g.sb_type[mi_row, mi_col]),
            bool(not g.skip[mi_row, mi_col] or not inter_block), r)
        if inter_block:
            state.corrupted |= _read_inter_block_mode_info(
                state, xd, r, mi_row, mi_col)
        else:
            _read_intra_block_mode_info(state, xd, r, mi_row, mi_col)
        # record per-mi motion info for next frame's temporal MV prediction
        sl = np.s_[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis]
        state.cur_ref[sl] = g.ref[mi_row, mi_col]
        state.cur_mv[sl] = g.mv[mi_row, mi_col]

    _replicate(state, mi_row, mi_col, x_mis, y_mis)


def _replicate(state, mi_row, mi_col, x_mis, y_mis):
    """Copy the decoded cell over the block extent (set_offsets parity)."""
    if x_mis == 1 and y_mis == 1:
        return
    g = state.mi
    sl = np.s_[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis]
    for arr in (g.sb_type, g.mode, g.uv_mode, g.tx_size, g.skip,
                g.segment_id, g.seg_id_predicted, g.interp_filter):
        arr[sl] = arr[mi_row, mi_col]
    g.ref[sl] = g.ref[mi_row, mi_col]
    g.mv[sl] = g.mv[mi_row, mi_col]
