"""Bit-exact deblocking loop filter oracle.

Parity with vpx_dsp/loopfilter.c (filter4:80, filter8:162, filter16:235 and
the edge mask functions) and vp9/common/vp9_loopfilter.c
(vp9_loop_filter_frame_init:252, update_sharpness, the generic
vp9_filter_block_plane_non420:1080 which computes per-8x8 masks on the fly,
and filter_selectively_vert:1014 / filter_selectively_horiz:453 application
order).  Filtering runs superblock by superblock in raster order: all
vertical edges of the SB first, then all horizontal edges (normative order).
"""

from __future__ import annotations

import numpy as np

from ... import models as M

MAX_LOOP_FILTER = 63
MODE_LF_LUT = [0] * 10 + [1, 1, 0, 1]  # intra; NEAREST, NEAR, ZERO, NEW


def make_thresholds(sharpness: int):
    """Per-level (mblim, lim, hev_thr) (update_sharpness parity)."""
    mblim = np.zeros(64, np.int64)
    lim = np.zeros(64, np.int64)
    hev = np.zeros(64, np.int64)
    for lvl in range(64):
        block_inside_limit = lvl >> ((sharpness > 0) + (sharpness > 4))
        if sharpness > 0:
            block_inside_limit = min(block_inside_limit, 9 - sharpness)
        block_inside_limit = max(block_inside_limit, 1)
        lim[lvl] = block_inside_limit
        mblim[lvl] = 2 * (lvl + 2) + block_inside_limit
        hev[lvl] = lvl >> 4
    return mblim, lim, hev


def build_lvl_table(filter_level: int, lf, seg) -> np.ndarray:
    """lvl[seg][ref_frame 0..3][mode 0..1] (vp9_loop_filter_frame_init)."""
    from ...decoder import constants as C
    lvl = np.zeros((8, 4, 2), np.int64)
    scale = 1 << (filter_level >> 5)
    for seg_id in range(8):
        lvl_seg = filter_level
        if seg.active(seg_id, C.SEG_LVL_ALT_LF):
            data = seg.data(seg_id, C.SEG_LVL_ALT_LF)
            lvl_seg = max(0, min(MAX_LOOP_FILTER,
                                 data if seg.abs_delta
                                 else filter_level + data))
        if not lf.mode_ref_delta_enabled:
            lvl[seg_id, :, :] = lvl_seg
        else:
            intra_lvl = lvl_seg + lf.ref_deltas[0] * scale
            lvl[seg_id, 0, 0] = max(0, min(MAX_LOOP_FILTER, intra_lvl))
            for ref in range(1, 4):
                for mode in range(2):
                    inter_lvl = (lvl_seg + lf.ref_deltas[ref] * scale
                                 + lf.mode_deltas[mode] * scale)
                    lvl[seg_id, ref, mode] = max(0, min(MAX_LOOP_FILTER,
                                                        inter_lvl))
    return lvl


# ------------------------------------------------------------ kernels
# All operate on integer arrays p7..q7 ("columns" across the edge), each a
# vector of 8 samples along the edge, in place on a window W[8, 16] whose
# axis 1 crosses the edge at index 8.  Generalized to any bit depth via
# threshold scaling (vpx_dsp/loopfilter.c highbd variants).

def _clamp_sc(t, bd):
    lo = -128 << (bd - 8)
    hi = (128 << (bd - 8)) - 1
    return np.clip(t, lo, hi)


def _filter_masks(W, mblim, lim, hev_thr, bd):
    p3, p2, p1, p0 = W[:, 4], W[:, 5], W[:, 6], W[:, 7]
    q0, q1, q2, q3 = W[:, 8], W[:, 9], W[:, 10], W[:, 11]
    shift = bd - 8
    limit = lim << shift
    blimit = mblim << shift
    mask = ((np.abs(p3 - p2) > limit) | (np.abs(p2 - p1) > limit)
            | (np.abs(p1 - p0) > limit) | (np.abs(q1 - q0) > limit)
            | (np.abs(q2 - q1) > limit) | (np.abs(q3 - q2) > limit)
            | (np.abs(p0 - q0) * 2 + (np.abs(p1 - q1) >> 1) > blimit))
    mask = ~mask
    hev = (np.abs(p1 - p0) > (hev_thr << shift)) | \
        (np.abs(q1 - q0) > (hev_thr << shift))
    flat_thr = 1 << shift
    flat = ((np.abs(p1 - p0) > flat_thr) | (np.abs(q1 - q0) > flat_thr)
            | (np.abs(p2 - p0) > flat_thr) | (np.abs(q2 - q0) > flat_thr)
            | (np.abs(p3 - p0) > flat_thr) | (np.abs(q3 - q0) > flat_thr))
    flat = ~flat
    return mask, hev, flat


def _flat2_mask(W, bd):
    p7, p6, p5, p4 = W[:, 0], W[:, 1], W[:, 2], W[:, 3]
    p0, q0 = W[:, 7], W[:, 8]
    q4, q5, q6, q7 = W[:, 12], W[:, 13], W[:, 14], W[:, 15]
    thr = 1 << (bd - 8)
    f = ((np.abs(p4 - p0) > thr) | (np.abs(q4 - q0) > thr)
         | (np.abs(p5 - p0) > thr) | (np.abs(q5 - q0) > thr)
         | (np.abs(p6 - p0) > thr) | (np.abs(q6 - q0) > thr)
         | (np.abs(p7 - p0) > thr) | (np.abs(q7 - q0) > thr))
    return ~f


def _filter4_apply(W, mask, hev, bd):
    offset = 0x80 << (bd - 8)
    ps1 = W[:, 6] - offset
    ps0 = W[:, 7] - offset
    qs0 = W[:, 8] - offset
    qs1 = W[:, 9] - offset
    f = _clamp_sc(ps1 - qs1, bd)
    f = np.where(hev, f, 0)
    f = np.where(mask, _clamp_sc(f + 3 * (qs0 - ps0), bd), 0)
    filter1 = _clamp_sc(f + 4, bd) >> 3
    filter2 = _clamp_sc(f + 3, bd) >> 3
    oq0 = _clamp_sc(qs0 - filter1, bd) + offset
    op0 = _clamp_sc(ps0 + filter2, bd) + offset
    f2 = (filter1 + 1) >> 1
    f2 = np.where(hev, 0, f2)
    oq1 = _clamp_sc(qs1 - f2, bd) + offset
    op1 = _clamp_sc(ps1 + f2, bd) + offset
    W[:, 6] = op1
    W[:, 7] = op0
    W[:, 8] = oq0
    W[:, 9] = oq1


def filter16_window(W, mblim, lim, hev_thr, bd):
    mask, hev, flat = _filter_masks(W, mblim, lim, hev_thr, bd)
    flat2 = _flat2_mask(W, bd)
    sel16 = flat2 & flat & mask
    # compute the 15-tap outputs on the original samples
    p = [W[:, 7 - k].copy() for k in range(8)]
    q = [W[:, 8 + k].copy() for k in range(8)]
    outs_p = []
    outs_q = []
    for i in range(7):  # op_i uses p7*(i+1) + p_i*2 + others
        s = p[7] * (i + 1) + p[i] * 2
        s += sum(p[k] for k in range(8) if k != i and k != 7)
        s += sum(q[k] for k in range(7 - i))
        outs_p.append((s + 8) >> 4)
    for i in range(7):
        s = q[7] * (i + 1) + q[i] * 2
        s += sum(q[k] for k in range(8) if k != i and k != 7)
        s += sum(p[k] for k in range(7 - i))
        outs_q.append((s + 8) >> 4)
    # non-16 samples fall through to filter8 (which falls through to filter4)
    filter8_window(W, mblim, lim, hev_thr, bd, force_masks=(mask, hev, flat))
    for i in range(7):
        W[:, 7 - i] = np.where(sel16, outs_p[i], W[:, 7 - i])
        W[:, 8 + i] = np.where(sel16, outs_q[i], W[:, 8 + i])


def filter8_window(W, mblim, lim, hev_thr, bd, force_masks=None):
    if force_masks is None:
        mask, hev, flat = _filter_masks(W, mblim, lim, hev_thr, bd)
    else:
        mask, hev, flat = force_masks
    p3, p2, p1, p0 = (W[:, k].copy() for k in (4, 5, 6, 7))
    q0, q1, q2, q3 = (W[:, k].copy() for k in (8, 9, 10, 11))
    sel = flat & mask
    op2 = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3
    op1 = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3
    op0 = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3
    oq0 = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3
    oq1 = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3
    oq2 = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3
    _filter4_apply(W, mask & ~sel, hev, bd)
    W[:, 5] = np.where(sel, op2, W[:, 5])
    W[:, 6] = np.where(sel, op1, W[:, 6])
    W[:, 7] = np.where(sel, op0, W[:, 7])
    W[:, 8] = np.where(sel, oq0, W[:, 8])
    W[:, 9] = np.where(sel, oq1, W[:, 9])
    W[:, 10] = np.where(sel, oq2, W[:, 10])


def filter4_window(W, mblim, lim, hev_thr, bd):
    mask, hev, _ = _filter_masks(W, mblim, lim, hev_thr, bd)
    _filter4_apply(W, mask, hev, bd)


def _apply_vertical(plane, y, x, kind, mblim, lim, hev, bd):
    """Filter the vertical edge at column x, rows y..y+7."""
    lo = x - 8 if kind == 16 else x - 4
    hi = x + 8 if kind == 16 else x + 4
    W = plane[y:y + 8, lo:hi].astype(np.int64)
    if kind == 16:
        filter16_window(W, mblim, lim, hev, bd)
    else:
        Wp = np.empty((8, 16), np.int64)
        Wp[:, 4:12] = W
        if kind == 8:
            filter8_window(Wp, mblim, lim, hev, bd)
        else:
            filter4_window(Wp, mblim, lim, hev, bd)
        W = Wp[:, 4:12]
        plane[y:y + 8, x - 4:x + 4] = W
        return
    plane[y:y + 8, lo:hi] = W


def _apply_horizontal(plane, y, x, kind, mblim, lim, hev, bd):
    """Filter the horizontal edge at row y, columns x..x+7."""
    lo = y - 8 if kind == 16 else y - 4
    hi = y + 8 if kind == 16 else y + 4
    W = plane[lo:hi, x:x + 8].T.astype(np.int64)
    if kind == 16:
        filter16_window(W, mblim, lim, hev, bd)
        plane[lo:hi, x:x + 8] = W.T
    else:
        Wp = np.empty((8, 16), np.int64)
        Wp[:, 4:12] = W
        if kind == 8:
            filter8_window(Wp, mblim, lim, hev, bd)
        else:
            filter4_window(Wp, mblim, lim, hev, bd)
        plane[y - 4:y + 4, x:x + 8] = Wp[:, 4:12].T


def filter_frame(planes, mi, seg_map, hdr, mi_rows, mi_cols, ss_x, ss_y, bd):
    """Apply the loop filter to all planes in place (normative SB order)."""
    lf = hdr.lf
    if lf.filter_level == 0:
        return
    lvl_tab = build_lvl_table(lf.filter_level, lf, hdr.seg)
    mblim_t, lim_t, hev_t = make_thresholds(lf.sharpness_level)

    for mi_r in range(0, mi_rows, 8):
        for mi_c in range(0, mi_cols, 8):
            for plane in range(3):
                sx = ss_x if plane else 0
                sy = ss_y if plane else 0
                _filter_plane_sb(planes[plane], mi, seg_map, lvl_tab,
                                 mblim_t, lim_t, hev_t, mi_r, mi_c,
                                 mi_rows, mi_cols, sx, sy, plane, bd)


def _filter_plane_sb(plane, mi, seg_map, lvl_tab, mblim_t, lim_t, hev_t,
                     mi_row, mi_col, mi_rows, mi_cols, ss_x, ss_y,
                     plane_idx, bd):
    """vp9_filter_block_plane_non420 parity for one superblock."""
    row_step = 1 << ss_y
    col_step = 1 << ss_x
    mask_16x16 = [0] * 8
    mask_8x8 = [0] * 8
    mask_4x4 = [0] * 8
    mask_4x4_int = [0] * 8
    lfl = np.zeros((8, 8), np.int64)

    # vertical pass, one mi row-group at a time
    r = 0
    while r < 8 and mi_row + r < mi_rows:
        mask_16x16_c = 0
        mask_8x8_c = 0
        mask_4x4_c = 0
        c = 0
        while c < 8 and mi_col + c < mi_cols:
            rr, cc = mi_row + r, mi_col + c
            sb_type = int(mi.sb_type[rr, cc])
            is_inter = mi.ref[rr, cc, 0] > 0
            skip_this = bool(mi.skip[rr, cc]) and is_inter
            n8w = int(M.NUM_8X8_W[sb_type])
            n8h = int(M.NUM_8X8_H[sb_type])
            block_edge_left = (not (c & (n8w - 1))) \
                if int(M.NUM_4X4_W[sb_type]) > 1 else True
            block_edge_above = (not (r & (n8h - 1))) \
                if int(M.NUM_4X4_H[sb_type]) > 1 else True
            skip_this_c = skip_this and not block_edge_left
            skip_this_r = skip_this and not block_edge_above
            tx_y = int(mi.tx_size[rr, cc])
            if plane_idx:
                tx_size = int(M.UV_TXSIZE_LOOKUP[sb_type][tx_y][ss_x][ss_y])
            else:
                tx_size = tx_y
            skip_border_4x4_c = bool(ss_x) and (mi_col + c == mi_cols - 1)
            skip_border_4x4_r = bool(ss_y) and (mi_row + r == mi_rows - 1)

            seg_id = int(mi.segment_id[rr, cc])
            ref0 = max(0, int(mi.ref[rr, cc, 0]))
            mode_lf = MODE_LF_LUT[int(mi.mode[rr, cc])]
            level = int(lvl_tab[seg_id, ref0, mode_lf])
            lfl[r, c >> ss_x] = level
            if not level:
                c += col_step
                continue

            bit = 1 << (c >> ss_x)
            if tx_size == 3:  # TX_32X32
                if not skip_this_c and ((c >> ss_x) & 3) == 0:
                    if not skip_border_4x4_c:
                        mask_16x16_c |= bit
                    else:
                        mask_8x8_c |= bit
                if not skip_this_r and ((r >> ss_y) & 3) == 0:
                    if not skip_border_4x4_r:
                        mask_16x16[r] |= bit
                    else:
                        mask_8x8[r] |= bit
            elif tx_size == 2:  # TX_16X16
                if not skip_this_c and ((c >> ss_x) & 1) == 0:
                    if not skip_border_4x4_c:
                        mask_16x16_c |= bit
                    else:
                        mask_8x8_c |= bit
                if not skip_this_r and ((r >> ss_y) & 1) == 0:
                    if not skip_border_4x4_r:
                        mask_16x16[r] |= bit
                    else:
                        mask_8x8[r] |= bit
            else:
                if not skip_this_c:
                    if tx_size == 1 or ((c >> ss_x) & 3) == 0:
                        mask_8x8_c |= bit
                    else:
                        mask_4x4_c |= bit
                if not skip_this_r:
                    if tx_size == 1 or ((r >> ss_y) & 3) == 0:
                        mask_8x8[r] |= bit
                    else:
                        mask_4x4[r] |= bit
                if (not skip_this) and tx_size < 1 and not skip_border_4x4_c:
                    mask_4x4_int[r] |= bit
            c += col_step

        border_mask = ~1 if mi_col == 0 else ~0
        y_px = ((mi_row * 8) >> ss_y) + ((r * 8) >> ss_y)
        _selective_vert(plane, y_px, (mi_col * 8) >> ss_x,
                        mask_16x16_c & border_mask, mask_8x8_c & border_mask,
                        mask_4x4_c & border_mask, mask_4x4_int[r],
                        lfl[r], mblim_t, lim_t, hev_t, bd)
        r += row_step

    # horizontal pass
    r = 0
    while r < 8 and mi_row + r < mi_rows:
        skip_border_4x4_r = bool(ss_y) and (mi_row + r == mi_rows - 1)
        m_int = 0 if skip_border_4x4_r else mask_4x4_int[r]
        if mi_row + r == 0:
            m16 = m8 = m4 = 0
        else:
            m16, m8, m4 = mask_16x16[r], mask_8x8[r], mask_4x4[r]
        y_px = ((mi_row * 8) >> ss_y) + ((r * 8) >> ss_y)
        _selective_horiz(plane, y_px, (mi_col * 8) >> ss_x,
                         m16, m8, m4, m_int, lfl[r],
                         mblim_t, lim_t, hev_t, bd)
        r += row_step


def _selective_vert(plane, y, x_base, m16, m8, m4, m4i, lfl,
                    mblim_t, lim_t, hev_t, bd):
    i = 0
    mask = m16 | m8 | m4 | m4i
    while mask >> i:
        if (mask >> i) & 1:
            lvl = int(lfl[i])
            args = (int(mblim_t[lvl]), int(lim_t[lvl]), int(hev_t[lvl]))
            x = x_base + 8 * i
            if (m16 >> i) & 1:
                _apply_vertical(plane, y, x, 16, *args, bd)
            elif (m8 >> i) & 1:
                _apply_vertical(plane, y, x, 8, *args, bd)
            elif (m4 >> i) & 1:
                _apply_vertical(plane, y, x, 4, *args, bd)
            if (m4i >> i) & 1:
                _apply_vertical(plane, y, x + 4, 4, *args, bd)
        i += 1


def _selective_horiz(plane, y, x_base, m16, m8, m4, m4i, lfl,
                     mblim_t, lim_t, hev_t, bd):
    i = 0
    mask = m16 | m8 | m4 | m4i
    while mask >> i:
        if (mask >> i) & 1:
            lvl = int(lfl[i])
            args = (int(mblim_t[lvl]), int(lim_t[lvl]), int(hev_t[lvl]))
            x = x_base + 8 * i
            if (m16 >> i) & 1:
                _apply_horizontal(plane, y, x, 16, *args, bd)
            elif (m8 >> i) & 1:
                _apply_horizontal(plane, y, x, 8, *args, bd)
                if (m4i >> i) & 1:
                    _apply_horizontal(plane, y + 4, x, 4, *args, bd)
            elif (m4 >> i) & 1:
                _apply_horizontal(plane, y, x, 4, *args, bd)
                if (m4i >> i) & 1:
                    _apply_horizontal(plane, y + 4, x, 4, *args, bd)
            elif (m4i >> i) & 1:
                _apply_horizontal(plane, y + 4, x, 4, *args, bd)
        i += 1
