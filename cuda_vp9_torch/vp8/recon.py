"""VP8 reconstruction primitives (RFC 6386): intra predictors, inverse
DCT/WHT, and the loop filter.  NumPy oracle, bit-exact with the
reference behavior (vpx_dsp/intrapred.c 4x4 VP8 variants,
vp8/common/idctllm.c, vp8/common/loopfilter_filters.c,
vp8/common/vp8_loopfilter.c)."""

from __future__ import annotations

import numpy as np


def _avg2(a, b):
    return (int(a) + int(b) + 1) >> 1


def _avg3(a, b, c):
    return (int(a) + 2 * int(b) + int(c) + 2) >> 2


# ----------------------------------------------------------- 4x4 intra
# vpx_dsp/intrapred.c: the VP8 4x4 family (ve/he/d45e/d63e are the
# VP8-specific edge variants; see vp8/common/reconintra4x4.c:26-37 for
# the B_PRED mode -> predictor mapping).

def b_pred_4x4(mode, above8, top_left, left4):
    """above8: 8 pixels A..H (above + above-right), left4: 4 left pixels,
    top_left: the corner pixel.  Returns [4, 4] uint8."""
    A = [int(v) for v in above8]
    L = [int(v) for v in left4]
    X = int(top_left)
    d = np.zeros((4, 4), np.int32)
    if mode == 0:                       # B_DC_PRED
        d[:, :] = (sum(A[:4]) + sum(L) + 4) >> 3
    elif mode == 1:                     # B_TM_PRED
        for r in range(4):
            for c in range(4):
                d[r, c] = min(255, max(0, L[r] + A[c] - X))
    elif mode == 2:                     # B_VE_PRED
        row = [_avg3(X, A[0], A[1]), _avg3(A[0], A[1], A[2]),
               _avg3(A[1], A[2], A[3]), _avg3(A[2], A[3], A[4])]
        d[:, :] = row
    elif mode == 3:                     # B_HE_PRED
        col = [_avg3(X, L[0], L[1]), _avg3(L[0], L[1], L[2]),
               _avg3(L[1], L[2], L[3]), _avg3(L[2], L[3], L[3])]
        for r in range(4):
            d[r, :] = col[r]
    elif mode == 4:                     # B_LD_PRED (d45e)
        v = [_avg3(A[0], A[1], A[2]), _avg3(A[1], A[2], A[3]),
             _avg3(A[2], A[3], A[4]), _avg3(A[3], A[4], A[5]),
             _avg3(A[4], A[5], A[6]), _avg3(A[5], A[6], A[7]),
             _avg3(A[6], A[7], A[7])]
        for r in range(4):
            for c in range(4):
                d[r, c] = v[r + c]
    elif mode == 5:                     # B_RD_PRED (d135)
        v = [_avg3(L[1], L[2], L[3]), _avg3(L[0], L[1], L[2]),
             _avg3(X, L[0], L[1]), _avg3(A[0], X, L[0]),
             _avg3(A[1], A[0], X), _avg3(A[2], A[1], A[0]),
             _avg3(A[3], A[2], A[1])]
        for r in range(4):
            for c in range(4):
                d[r, c] = v[3 - r + c]
    elif mode == 6:                     # B_VR_PRED (d117)
        d[0, 0] = d[2, 1] = _avg2(X, A[0])
        d[0, 1] = d[2, 2] = _avg2(A[0], A[1])
        d[0, 2] = d[2, 3] = _avg2(A[1], A[2])
        d[0, 3] = _avg2(A[2], A[3])
        d[3, 0] = _avg3(L[2], L[1], L[0])
        d[2, 0] = _avg3(L[1], L[0], X)
        d[1, 0] = d[3, 1] = _avg3(L[0], X, A[0])
        d[1, 1] = d[3, 2] = _avg3(X, A[0], A[1])
        d[1, 2] = d[3, 3] = _avg3(A[0], A[1], A[2])
        d[1, 3] = _avg3(A[1], A[2], A[3])
    elif mode == 7:                     # B_VL_PRED (d63e)
        d[0, 0] = _avg2(A[0], A[1])
        d[0, 1] = d[2, 0] = _avg2(A[1], A[2])
        d[0, 2] = d[2, 1] = _avg2(A[2], A[3])
        d[0, 3] = d[2, 2] = _avg2(A[3], A[4])
        d[2, 3] = _avg3(A[4], A[5], A[6])
        d[1, 0] = _avg3(A[0], A[1], A[2])
        d[1, 1] = d[3, 0] = _avg3(A[1], A[2], A[3])
        d[1, 2] = d[3, 1] = _avg3(A[2], A[3], A[4])
        d[1, 3] = d[3, 2] = _avg3(A[3], A[4], A[5])
        d[3, 3] = _avg3(A[5], A[6], A[7])
    elif mode == 8:                     # B_HD_PRED (d153)
        d[0, 0] = d[1, 2] = _avg2(L[0], X)
        d[1, 0] = d[2, 2] = _avg2(L[1], L[0])
        d[2, 0] = d[3, 2] = _avg2(L[2], L[1])
        d[3, 0] = _avg2(L[3], L[2])
        d[0, 3] = _avg3(A[0], A[1], A[2])
        d[0, 2] = _avg3(X, A[0], A[1])
        d[0, 1] = d[1, 3] = _avg3(L[0], X, A[0])
        d[1, 1] = d[2, 3] = _avg3(L[1], L[0], X)
        d[2, 1] = d[3, 3] = _avg3(L[2], L[1], L[0])
        d[3, 1] = _avg3(L[3], L[2], L[1])
    elif mode == 9:                     # B_HU_PRED (d207)
        d[0, 0] = _avg2(L[0], L[1])
        d[0, 2] = d[1, 0] = _avg2(L[1], L[2])
        d[1, 2] = d[2, 0] = _avg2(L[2], L[3])
        d[0, 1] = _avg3(L[0], L[1], L[2])
        d[0, 3] = d[1, 1] = _avg3(L[1], L[2], L[3])
        d[1, 3] = d[2, 1] = _avg3(L[2], L[3], L[3])
        d[2, 2] = d[2, 3] = L[3]
        d[3, :] = L[3]
    else:
        raise ValueError(f"bad b_mode {mode}")
    return d.astype(np.uint8)


def mb_pred(mode, above, left, top_left, size, up_avail, left_avail):
    """16x16 (Y) or 8x8 (chroma) whole-block prediction.

    DC uses availability-gated variants (vp8/common/reconintra.c:60);
    V/H/TM read the border-initialized rows regardless."""
    n = size
    d = np.zeros((n, n), np.int32)
    A = above.astype(np.int32)
    L = left.astype(np.int32)
    if mode == 0:      # DC_PRED
        if up_avail and left_avail:
            d[:, :] = (int(A.sum()) + int(L.sum()) + n) >> \
                (4 if n == 8 else 5)
        elif up_avail:
            d[:, :] = (int(A.sum()) + (n >> 1)) >> (3 if n == 8 else 4)
        elif left_avail:
            d[:, :] = (int(L.sum()) + (n >> 1)) >> (3 if n == 8 else 4)
        else:
            d[:, :] = 128
    elif mode == 1:    # V_PRED
        d[:, :] = A[None, :]
    elif mode == 2:    # H_PRED
        d[:, :] = L[:, None]
    elif mode == 3:    # TM_PRED
        d[:, :] = np.clip(L[:, None] + A[None, :] - int(top_left), 0, 255)
    else:
        raise ValueError(f"bad mb mode {mode}")
    return d.astype(np.uint8)


# ----------------------------------------------------------- transforms

def idct4x4(block):
    """vp8_short_idct4x4llm_c: [16] int dqcoeffs -> [4, 4] int32 residual.
    Intermediate values truncate to int16 (the reference's short[16])."""
    ip = np.asarray(block, np.int64).reshape(4, 4)
    out = np.zeros((4, 4), np.int64)
    # column pass (reference iterates i over columns of the 4-stride array)
    for i in range(4):
        a1 = ip[0, i] + ip[2, i]
        b1 = ip[0, i] - ip[2, i]
        t1 = (ip[1, i] * 35468) >> 16
        t2 = ip[3, i] + ((ip[3, i] * 20091) >> 16)
        c1 = t1 - t2
        t1 = ip[1, i] + ((ip[1, i] * 20091) >> 16)
        t2 = (ip[3, i] * 35468) >> 16
        d1 = t1 + t2
        out[0, i] = _s16(a1 + d1)
        out[3, i] = _s16(a1 - d1)
        out[1, i] = _s16(b1 + c1)
        out[2, i] = _s16(b1 - c1)
    res = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = out[i, 0] + out[i, 2]
        b1 = out[i, 0] - out[i, 2]
        t1 = (out[i, 1] * 35468) >> 16
        t2 = out[i, 3] + ((out[i, 3] * 20091) >> 16)
        c1 = t1 - t2
        t1 = out[i, 1] + ((out[i, 1] * 20091) >> 16)
        t2 = (out[i, 3] * 35468) >> 16
        d1 = t1 + t2
        res[i, 0] = _s16((a1 + d1 + 4) >> 3)
        res[i, 3] = _s16((a1 - d1 + 4) >> 3)
        res[i, 1] = _s16((b1 + c1 + 4) >> 3)
        res[i, 2] = _s16((b1 - c1 + 4) >> 3)
    return res.astype(np.int32)


def _s16(x):
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def iwalsh4x4(block):
    """vp8_short_inv_walsh4x4_c: Y2 [16] -> 16 DC values (int16)."""
    ip = np.asarray(block, np.int64).reshape(4, 4)
    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = ip[0, i] + ip[3, i]
        b1 = ip[1, i] + ip[2, i]
        c1 = ip[1, i] - ip[2, i]
        d1 = ip[0, i] - ip[3, i]
        out[0, i] = _s16(a1 + b1)
        out[1, i] = _s16(c1 + d1)
        out[2, i] = _s16(a1 - b1)
        out[3, i] = _s16(d1 - c1)
    dc = np.zeros(16, np.int32)
    for i in range(4):
        a1 = out[i, 0] + out[i, 3]
        b1 = out[i, 1] + out[i, 2]
        c1 = out[i, 1] - out[i, 2]
        d1 = out[i, 0] - out[i, 3]
        dc[i * 4 + 0] = _s16((a1 + b1 + 3) >> 3)
        dc[i * 4 + 1] = _s16((c1 + d1 + 3) >> 3)
        dc[i * 4 + 2] = _s16((a1 - b1 + 3) >> 3)
        dc[i * 4 + 3] = _s16((d1 - c1 + 3) >> 3)
    return dc


# ----------------------------------------------------------- loop filter

def _sc(t):
    return max(-128, min(127, int(t)))


def _signed(v):
    return int(v) - 128   # (signed char)v ^ 0x80


def _unsigned(s):
    return (int(s) + 128) & 0xFF


def _filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3):
    m = (abs(p3 - p2) > limit or abs(p2 - p1) > limit
         or abs(p1 - p0) > limit or abs(q1 - q0) > limit
         or abs(q2 - q1) > limit or abs(q3 - q2) > limit
         or abs(p0 - q0) * 2 + abs(p1 - q1) // 2 > blimit)
    return not m


def _hevmask(thresh, p1, p0, q0, q1):
    return abs(p1 - p0) > thresh or abs(q1 - q0) > thresh


def _filter4(mask, hev, px, i1, i0, j0, j1):
    """vp8_filter on a pixel vector px (1-D int array view); i/j are
    indices of p1 p0 q0 q1."""
    if not mask:
        return
    ps1, ps0 = _signed(px[i1]), _signed(px[i0])
    qs0, qs1 = _signed(px[j0]), _signed(px[j1])
    f = _sc(ps1 - qs1) if hev else 0
    f = _sc(f + 3 * (qs0 - ps0))
    f1 = _sc(f + 4) >> 3
    f2 = _sc(f + 3) >> 3
    px[j0] = _unsigned(_sc(qs0 - f1))
    px[i0] = _unsigned(_sc(ps0 + f2))
    if not hev:
        a = (f1 + 1) >> 1
        px[j1] = _unsigned(_sc(qs1 - a))
        px[i1] = _unsigned(_sc(ps1 + a))


def _mbfilter(mask, hev, px, i2, i1, i0, j0, j1, j2):
    if not mask:
        return
    ps2, ps1, ps0 = _signed(px[i2]), _signed(px[i1]), _signed(px[i0])
    qs0, qs1, qs2 = _signed(px[j0]), _signed(px[j1]), _signed(px[j2])
    f = _sc(ps1 - qs1)
    f = _sc(f + 3 * (qs0 - ps0))
    if not mask:
        f = 0
    f2 = f if hev else 0
    f1 = _sc(f2 + 4) >> 3
    f2 = _sc(f2 + 3) >> 3
    qs0 = _sc(qs0 - f1)
    ps0 = _sc(ps0 + f2)
    fv = 0 if hev else f
    u = _sc((63 + fv * 27) >> 7)
    px[j0] = _unsigned(_sc(qs0 - u))
    px[i0] = _unsigned(_sc(ps0 + u))
    u = _sc((63 + fv * 18) >> 7)
    px[j1] = _unsigned(_sc(qs1 - u))
    px[i1] = _unsigned(_sc(ps1 + u))
    u = _sc((63 + fv * 9) >> 7)
    px[j2] = _unsigned(_sc(qs2 - u))
    px[i2] = _unsigned(_sc(ps2 + u))


def _edge_h(plane, y, x0, n, blim, lim, thr, mb):
    """Horizontal edge at row y (filters across rows), columns x0..x0+n."""
    for x in range(x0, x0 + n):
        col = plane[:, x]
        p = [int(col[y - 4]), int(col[y - 3]), int(col[y - 2]),
             int(col[y - 1]), int(col[y]), int(col[y + 1]),
             int(col[y + 2]), int(col[y + 3])]
        mask = _filter_mask(lim, blim, *p)
        hev = _hevmask(thr, p[2], p[3], p[4], p[5])
        if mb:
            _mbfilter(mask, hev, col, y - 3, y - 2, y - 1, y, y + 1, y + 2)
        else:
            _filter4(mask, hev, col, y - 2, y - 1, y, y + 1)


def _edge_v(plane, y0, x, n, blim, lim, thr, mb):
    """Vertical edge at column x, rows y0..y0+n."""
    for y in range(y0, y0 + n):
        row = plane[y]
        p = [int(row[x - 4]), int(row[x - 3]), int(row[x - 2]),
             int(row[x - 1]), int(row[x]), int(row[x + 1]),
             int(row[x + 2]), int(row[x + 3])]
        mask = _filter_mask(lim, blim, *p)
        hev = _hevmask(thr, p[2], p[3], p[4], p[5])
        if mb:
            _mbfilter(mask, hev, row, x - 3, x - 2, x - 1, x, x + 1, x + 2)
        else:
            _filter4(mask, hev, row, x - 2, x - 1, x, x + 1)


def _simple_edge(plane, y0, x0, horiz, blim):
    for i in range(16):
        if horiz:
            col = plane[:, x0 + i]
            p1, p0, q0, q1 = (int(col[y0 - 2]), int(col[y0 - 1]),
                              int(col[y0]), int(col[y0 + 1]))
        else:
            row = plane[y0 + i]
            p1, p0, q0, q1 = (int(row[x0 - 2]), int(row[x0 - 1]),
                              int(row[x0]), int(row[x0 + 1]))
        if abs(p0 - q0) * 2 + abs(p1 - q1) // 2 > blim:
            continue
        ps1, ps0, qs0, qs1 = (_signed(p1), _signed(p0),
                              _signed(q0), _signed(q1))
        f = _sc(ps1 - qs1)
        f = _sc(f + 3 * (qs0 - ps0))
        f1 = _sc(f + 4) >> 3
        f2 = _sc(f + 3) >> 3
        nq0 = _unsigned(_sc(qs0 - f1))
        np0 = _unsigned(_sc(ps0 + f2))
        if horiz:
            plane[y0 - 1, x0 + i] = np0
            plane[y0, x0 + i] = nq0
        else:
            plane[y0 + i, x0 - 1] = np0
            plane[y0 + i, x0] = nq0


def lf_limits(sharpness):
    """Per-level (blim, mblim, lim) (vp8_loop_filter_update_sharpness)."""
    out = []
    for lvl in range(64):
        inside = lvl >> (1 if sharpness > 0 else 0)
        inside >>= (1 if sharpness > 4 else 0)
        if sharpness > 0:
            inside = min(inside, 9 - sharpness)
        inside = max(inside, 1)
        out.append((2 * lvl + inside, 2 * (lvl + 2) + inside, inside))
    return out


def hev_threshold(frame_type, lvl):
    """lf_init_lut parity (keyframe column)."""
    if lvl >= 40:
        return 2 if frame_type == 0 else 3
    if lvl >= 20:
        return 1 if frame_type == 0 else 2
    if lvl >= 15:
        return 1
    return 0
