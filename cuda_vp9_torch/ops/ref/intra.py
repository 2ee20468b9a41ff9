"""Bit-exact intra prediction oracle (single block, NumPy).

Parity with vpx_dsp/intrapred.c (d207/d63/d45/d117/d135/d153/v/h/tm/dc
predictors) and the edge construction in vp9/common/vp9_reconintra.c
(build_intra_predictors{,_high}:110-428): base-1/base+1 edge fills scaled by
bit depth, frame-edge extension, above-right availability rules.

Block sizes are always 4/8/16/32 (transform sizes).
"""

from __future__ import annotations

import numpy as np

NEED_LEFT = 1 << 1
NEED_ABOVE = 1 << 2
NEED_ABOVERIGHT = 1 << 3

EXTEND_MODES = [
    NEED_ABOVE | NEED_LEFT,   # DC
    NEED_ABOVE,               # V
    NEED_LEFT,                # H
    NEED_ABOVERIGHT,          # D45
    NEED_LEFT | NEED_ABOVE,   # D135
    NEED_LEFT | NEED_ABOVE,   # D117
    NEED_LEFT | NEED_ABOVE,   # D153
    NEED_LEFT,                # D207
    NEED_ABOVERIGHT,          # D63
    NEED_LEFT | NEED_ABOVE,   # TM
]


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def predict(mode: int, bs: int, above: np.ndarray, top_left: int,
            left: np.ndarray, have_left: bool, have_up: bool,
            bd: int) -> np.ndarray:
    """Run one predictor; above has 2*bs entries, left bs entries."""
    A = above.astype(np.int64)
    L = left.astype(np.int64)
    tl = int(top_left)
    out = np.empty((bs, bs), np.int64)
    ri = np.arange(bs)

    if mode == 0:  # DC (vpx_dc_predictor / dc_top / dc_left / dc_128)
        if have_left and have_up:
            s = int(A[:bs].sum() + L.sum())
            out[:] = (s + bs) >> (bs.bit_length())
        elif have_up:
            out[:] = (int(A[:bs].sum()) + (bs >> 1)) >> (bs.bit_length() - 1)
        elif have_left:
            out[:] = (int(L.sum()) + (bs >> 1)) >> (bs.bit_length() - 1)
        else:
            out[:] = 128 << (bd - 8)
    elif mode == 1:  # V
        out[:] = A[None, :bs]
    elif mode == 2:  # H
        out[:] = L[:, None]
    elif mode == 3:  # D45
        idx = ri[:, None] + ri[None, :]
        Ap = np.concatenate([A, A[-1:], A[-1:]])
        vals = _avg3(Ap[idx], Ap[idx + 1], Ap[idx + 2])
        if bs == 4:
            # specialized 4x4 variant (vpx_d45_predictor_4x4_c): no
            # above-right replication; corner is above[7]
            out[:] = np.where(idx < 6, vals, A[7])
        else:
            out[:] = np.where(idx < bs - 1, vals, A[bs - 1])
    elif mode == 4:  # D135
        border = np.empty(2 * bs - 1, np.int64)
        i = np.arange(bs - 2)
        border[:bs - 2] = _avg3(L[bs - 3 - i], L[bs - 2 - i], L[bs - 1 - i])
        border[bs - 2] = _avg3(tl, L[0], L[1])
        border[bs - 1] = _avg3(L[0], tl, A[0])
        border[bs] = _avg3(tl, A[0], A[1])
        border[bs + 1:] = _avg3(A[i], A[i + 1], A[i + 2])
        for r in range(bs):
            out[r] = border[bs - 1 - r:2 * bs - 1 - r]
    elif mode == 5:  # D117
        Am1 = np.concatenate([[tl], A])  # Am1[k] == above[k-1]
        out[0] = _avg2(Am1[:bs], A[:bs])
        row1 = np.empty(bs, np.int64)
        row1[0] = _avg3(L[0], tl, A[0])
        c = np.arange(1, bs)
        row1[1:] = _avg3(Am1[c - 1], Am1[c], A[c])
        out[1] = row1
        col0 = np.empty(bs, np.int64)
        col0[2] = _avg3(tl, L[0], L[1])
        for r in range(3, bs):
            col0[r] = _avg3(L[r - 3], L[r - 2], L[r - 1])
        for r in range(2, bs):
            out[r, 0] = col0[r]
            out[r, 1:] = out[r - 2, :bs - 1]
    elif mode == 6:  # D153
        out[0, 0] = _avg2(tl, L[0])
        out[1:, 0] = _avg2(L[:bs - 1], L[1:bs])
        col1 = np.empty(bs, np.int64)
        col1[0] = _avg3(L[0], tl, A[0])
        col1[1] = _avg3(tl, L[0], L[1])
        for r in range(2, bs):
            col1[r] = _avg3(L[r - 2], L[r - 1], L[r])
        out[:, 1] = col1
        Am1 = np.concatenate([[tl], A])
        j = np.arange(bs - 2)
        out[0, 2:] = _avg3(Am1[j], Am1[j + 1], Am1[j + 2])
        for r in range(1, bs):
            out[r, 2:] = out[r - 1, :bs - 2]
    elif mode == 7:  # D207
        v = ri[:, None] + (ri[None, :] >> 1)
        Lp = np.concatenate([L, np.full(bs + 2, L[bs - 1], np.int64)])
        a2 = _avg2(Lp[v], Lp[v + 1])
        a3 = _avg3(Lp[v], Lp[v + 1], Lp[v + 2])
        even = (ri[None, :] & 1) == 0
        out[:] = np.where(even,
                          np.where(v < bs - 1, a2, L[bs - 1]),
                          np.where(v < bs - 1, a3, L[bs - 1]))
    elif mode == 8:  # D63
        idx = ri[None, :] + (ri[:, None] >> 1)
        Ap = np.concatenate([A, np.full(2, A[2 * bs - 1], np.int64)])
        a2 = _avg2(Ap[idx], Ap[idx + 1])
        a3 = _avg3(Ap[idx], Ap[idx + 1], Ap[idx + 2])
        odd = (ri[:, None] & 1) == 1
        vals = np.where(odd, a3, a2)
        if bs == 4:
            # specialized 4x4 variant (vpx_d63_predictor_4x4_c): unclamped
            out[:] = vals
        else:
            fill = (ri[:, None] >= 2) & (idx > bs - 2)
            out[:] = np.where(fill, A[bs - 1], vals)
    elif mode == 9:  # TM
        maxval = (1 << bd) - 1
        out[:] = np.clip(L[:, None] + A[None, :bs] - tl, 0, maxval)
    else:
        raise ValueError(f"bad intra mode {mode}")
    return out


def build_edges(recon: np.ndarray, frame_w: int, frame_h: int, x0: int,
                y0: int, bs: int, mode: int, have_up: bool, have_left: bool,
                have_right: bool, right_clipped: bool, bottom_clipped: bool,
                bd: int):
    """Build (above[2*bs], top_left, left[bs]) for one transform block.

    `right_clipped`/`bottom_clipped` are mb_to_right_edge<0 /
    mb_to_bottom_edge<0 of the containing *prediction block*; frame_w/h are
    the plane's stored (aligned) dims (cur_buf y/uv width, reconintra:140).
    """
    base = 128 << (bd - 8)
    need = EXTEND_MODES[mode]
    above = np.full(2 * bs, base - 1, np.int64)
    left = np.full(bs, base + 1, np.int64)
    top_left = base - 1

    if need & NEED_LEFT:
        if have_left:
            if bottom_clipped and y0 + bs > frame_h:
                n = frame_h - y0
                col = recon[y0:y0 + n, x0 - 1].astype(np.int64)
                left[:n] = col
                left[n:] = col[n - 1]
            else:
                left[:] = recon[y0:y0 + bs, x0 - 1]

    if need & NEED_ABOVE and have_up:
        if right_clipped and x0 + bs > frame_w:
            r = frame_w - x0
            row = recon[y0 - 1, x0:x0 + r].astype(np.int64)
            above[:r] = row
            above[r:bs] = row[r - 1]
        else:
            above[:bs] = recon[y0 - 1, x0:x0 + bs]
        top_left = int(recon[y0 - 1, x0 - 1]) if have_left else base + 1

    if need & NEED_ABOVERIGHT and have_up:
        if right_clipped:
            if x0 + 2 * bs <= frame_w:
                avail = 2 * bs if (have_right and bs == 4) else bs
            elif x0 + bs <= frame_w:
                avail = (frame_w - x0) if (have_right and bs == 4) else bs
            else:
                avail = frame_w - x0
        else:
            avail = 2 * bs if (bs == 4 and have_right) else bs
        row = recon[y0 - 1, x0:x0 + avail].astype(np.int64)
        above[:avail] = row
        above[avail:] = row[avail - 1]
        top_left = int(recon[y0 - 1, x0 - 1]) if have_left else base + 1

    return above, top_left, left
