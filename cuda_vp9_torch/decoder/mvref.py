"""Motion-vector reference candidate search.

Parity with `dec_find_mv_refs` (vp9/decoder/vp9_decodemv.c:482),
`append_sub8x8_mvs_for_idx` (:607), `get_mode_context` (:668) and the
helpers in vp9/common/vp9_mvref_common.h (candidate positions, sub-block
selection, sign-bias scaling, border clamping).

The port parses with the C++ parser (native/); this module is here for
the encoder (encoder/), whose symbol contexts come from the parse side.
"""

from __future__ import annotations

from .. import models as M
from . import constants as C
from .blockd import MiGrid, MiRef

MV_BORDER = 16 << 3

MODE_2_COUNTER = [9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 0, 0, 3, 1]
COUNTER_TO_CONTEXT = [2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6]

_MV_REF_BLOCKS = M.MV_REF_BLOCKS  # [13][8][2] (row, col)
_IDX_N_COLUMN_TO_SUBBLOCK = M.IDX_N_COLUMN_TO_SUBBLOCK


def _clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def clamp_mv(mv, min_col, max_col, min_row, max_row):
    return (_clamp(mv[0], min_row, max_row), _clamp(mv[1], min_col, max_col))


def clamp_mv_ref(mv, xd):
    return clamp_mv(mv, xd.mb_to_left_edge - MV_BORDER,
                    xd.mb_to_right_edge + MV_BORDER,
                    xd.mb_to_top_edge - MV_BORDER,
                    xd.mb_to_bottom_edge + MV_BORDER)


def use_mv_hp(ref) -> bool:
    return abs(ref[0]) < 64 and abs(ref[1]) < 64


def lower_mv_precision(mv, allow_hp):
    row, col = mv
    if not (allow_hp and use_mv_hp(mv)):
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


def is_inside(tile, mi_col, mi_row, mi_rows, pos) -> bool:
    return not (mi_row + pos[0] < 0
                or mi_col + pos[1] < tile.mi_col_start
                or mi_row + pos[0] >= mi_rows
                or mi_col + pos[1] >= tile.mi_col_end)


def _get_sub_block_mv(cand: MiRef, which: int, search_col: int, block_idx: int):
    if block_idx >= 0 and cand.sb_type < C.BLOCK_8X8:
        sub = int(_IDX_N_COLUMN_TO_SUBBLOCK[block_idx][1 if search_col == 0
                                                       else 0])
        return cand.bmi_mv(sub, which)
    return cand.mv(which)


def _scale_mv(cand: MiRef, ref: int, this_ref: int, sign_bias):
    mv = cand.mv(ref)
    if sign_bias[cand.ref_frame(ref)] != sign_bias[this_ref]:
        mv = (-mv[0], -mv[1])
    return mv


def dec_find_mv_refs(state, xd, mode: int, ref_frame: int, bsize: int,
                     mi_row: int, mi_col: int, block: int):
    """Returns (mv_ref_list[2], refmv_count), clamped (vp9_decodemv.c:482)."""
    g: MiGrid = state.mi
    sign_bias = state.ref_frame_sign_bias
    search = _MV_REF_BLOCKS[bsize]
    tile = xd.tile
    mi_rows = state.mi_rows
    early_break = mode != C.NEARMV
    mv_list = [(0, 0), (0, 0)]
    refmv_count = 0
    different_ref_found = False
    done = False

    prev = None
    if state.use_prev_frame_mvs:
        prev = (state.prev_ref[mi_row, mi_col], state.prev_mv[mi_row, mi_col])

    def add(mv):
        # ADD_MV_REF_LIST_EB semantics; returns True when search is done
        nonlocal refmv_count
        if refmv_count:
            if mv != mv_list[0]:
                mv_list[refmv_count] = mv
                refmv_count += 1
                return True
        else:
            mv_list[0] = mv
            refmv_count = 1
            if early_break:
                return True
        return False

    i = 0
    if block >= 0:
        while i < 2 and not done:
            pos = search[i]
            if is_inside(tile, mi_col, mi_row, mi_rows, pos):
                cand = g.at(mi_row + int(pos[0]), mi_col + int(pos[1]))
                different_ref_found = True
                if cand.ref_frame(0) == ref_frame:
                    done = add(_get_sub_block_mv(cand, 0, int(pos[1]), block))
                elif cand.ref_frame(1) == ref_frame:
                    done = add(_get_sub_block_mv(cand, 1, int(pos[1]), block))
            i += 1

    while i < C.MVREF_NEIGHBOURS and not done:
        pos = search[i]
        if is_inside(tile, mi_col, mi_row, mi_rows, pos):
            cand = g.at(mi_row + int(pos[0]), mi_col + int(pos[1]))
            different_ref_found = True
            if cand.ref_frame(0) == ref_frame:
                done = add(cand.mv(0))
            elif cand.ref_frame(1) == ref_frame:
                done = add(cand.mv(1))
        i += 1

    if prev is not None and not done:
        pref, pmv = prev
        if pref[0] == ref_frame:
            done = add((int(pmv[0, 0]), int(pmv[0, 1])))
        elif pref[1] == ref_frame:
            done = add((int(pmv[1, 0]), int(pmv[1, 1])))

    if different_ref_found and not done:
        for pos in search:
            if done:
                break
            if is_inside(tile, mi_col, mi_row, mi_rows, pos):
                cand = g.at(mi_row + int(pos[0]), mi_col + int(pos[1]))
                if cand.is_inter:
                    if cand.ref_frame(0) != ref_frame:
                        done = add(_scale_mv(cand, 0, ref_frame, sign_bias))
                        if done:
                            break
                    if (cand.has_second_ref
                            and cand.ref_frame(1) != ref_frame
                            and cand.mv(1) != cand.mv(0)):
                        done = add(_scale_mv(cand, 1, ref_frame, sign_bias))

    if prev is not None and not done:
        pref, pmv = prev
        if pref[0] != ref_frame and pref[0] > C.INTRA_FRAME:
            mv = (int(pmv[0, 0]), int(pmv[0, 1]))
            if sign_bias[pref[0]] != sign_bias[ref_frame]:
                mv = (-mv[0], -mv[1])
            done = add(mv)
        if not done and (pref[1] > C.INTRA_FRAME and pref[1] != ref_frame
                         and (int(pmv[1, 0]), int(pmv[1, 1]))
                         != (int(pmv[0, 0]), int(pmv[0, 1]))):
            mv = (int(pmv[1, 0]), int(pmv[1, 1]))
            if sign_bias[pref[1]] != sign_bias[ref_frame]:
                mv = (-mv[0], -mv[1])
            done = add(mv)

    if not done:
        refmv_count = (C.MAX_MV_REF_CANDIDATES if mode == C.NEARMV else 1)

    mv_list = [clamp_mv_ref(mv_list[i], xd) if i < refmv_count else mv_list[i]
               for i in range(2)]
    return mv_list, refmv_count


def get_mode_context(state, xd, bsize: int, mi_row: int, mi_col: int) -> int:
    g: MiGrid = state.mi
    search = _MV_REF_BLOCKS[bsize]
    counter = 0
    for i in range(2):
        pos = search[i]
        if is_inside(xd.tile, mi_col, mi_row, state.mi_rows, pos):
            cand = g.at(mi_row + int(pos[0]), mi_col + int(pos[1]))
            counter += MODE_2_COUNTER[cand.mode]
    return COUNTER_TO_CONTEXT[counter]


def append_sub8x8_mvs_for_idx(state, xd, b_mode: int, block: int, ref: int,
                              ref_frame: int, mi_row: int, mi_col: int,
                              bsize: int, bmi_mv) -> tuple:
    """Returns best_sub8x8 mv for the given sub-block (vp9_decodemv.c:607).

    `bmi_mv` is the current block's bmi mv array view [4][2][2].
    """

    def bmi(i):
        return (int(bmi_mv[i, ref, 0]), int(bmi_mv[i, ref, 1]))

    if block == 0:
        mv_list, refmv_count = dec_find_mv_refs(
            state, xd, b_mode, ref_frame, bsize, mi_row, mi_col, block)
        return mv_list[refmv_count - 1]
    if block in (1, 2):
        if b_mode == C.NEARESTMV:
            return bmi(0)
        mv_list, _ = dec_find_mv_refs(
            state, xd, b_mode, ref_frame, bsize, mi_row, mi_col, block)
        for n in range(2):
            if bmi(0) != mv_list[n]:
                return mv_list[n]
        return (0, 0)
    # block == 3
    if b_mode == C.NEARESTMV:
        return bmi(2)
    if bmi(2) != bmi(1):
        return bmi(1)
    if bmi(2) != bmi(0):
        return bmi(0)
    mv_list, _ = dec_find_mv_refs(
        state, xd, b_mode, ref_frame, bsize, mi_row, mi_col, block)
    for n in range(2):
        if bmi(2) != mv_list[n]:
            return mv_list[n]
    return (0, 0)
