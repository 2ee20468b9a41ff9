"""VP8 error concealment (the reference is built with
--enable-error-concealment; vp8/decoder/error_concealment.c).

Two mechanisms, mirroring the reference:

1. `interpolate_motion` — when a macroblock's residual data is corrupt
   but its neighbors' modes/MVs are known, each of its 16 4x4 blocks
   gets a distance-weighted (weights_q7) average of the up-to-20
   surrounding 4x4 MVs that reference LAST, and the MB is rebuilt as
   SPLITMV/LAST with zero residual (error_concealment.c:346-482).

2. `estimate_missing_mvs` — when the mode/MV partition itself is lost
   from some MB onward, MVs are estimated from the PREVIOUS frame's MV
   field: every previous 4x4 block is projected by its own MV onto the
   current frame, and each current 4x4 block takes the overlap-area
   weighted average of the projected MVs landing on it
   (error_concealment.c:63-344).  The numpy implementation vectorizes
   the reference's per-block overlap lists.
"""

from __future__ import annotations

import numpy as np

# error_concealment.c:37 — Q7 weights by (row, col) block distance
WEIGHTS_Q7 = np.array([[0, 128, 64, 43, 32],
                       [128, 64, 43, 32, 26],
                       [64, 43, 32, 26, 21],
                       [43, 32, 26, 21, 18],
                       [32, 26, 21, 18, 16]], np.int64)

# find_neighboring_blocks order: positions relative to the MB's upper
# left 4x4 block (error_concealment.c neigh_pos), and for each the
# (neighbor MB offset, sub-block index) it samples
_NEIGH_POS = [(-1, -1), (-1, 0), (-1, 1), (-1, 2), (-1, 3), (-1, 4),
              (0, 4), (1, 4), (2, 4), (3, 4), (4, 4), (4, 3), (4, 2),
              (4, 1), (4, 0), (4, -1), (3, -1), (2, -1), (1, -1),
              (0, -1)]
_NEIGH_SRC = ([((-1, -1), 15)] + [((-1, 0), j) for j in range(12, 16)]
              + [((-1, 1), 12)] + [((0, 1), j) for j in (0, 4, 8, 12)]
              + [((1, 1), 0)] + [((1, 0), j) for j in range(4)]
              + [((1, -1), 4)] + [((0, -1), j) for j in (3, 7, 11, 15)])

INTRA, LAST = 0, 1
SPLITMV = 9
MAX_REF = 4  # "doesn't exist"


def _block_mv(mi, r, c, j):
    """Per-4x4 MV of MB (r, c): bmi for SPLITMV, else the MB MV
    (decodemv.c:446 propagates the MB MV into bmi under ec_enabled)."""
    if int(mi["mode"][r + 1, c + 1]) == SPLITMV:
        b = mi["bmvs"][r, c, j]
        return int(b[0]), int(b[1])
    return (int(mi["mvs"][r + 1, c + 1, 0]),
            int(mi["mvs"][r + 1, c + 1, 1]))


def interpolate_motion(mi, r, c, mb_rows, mb_cols):
    """vp8_interpolate_motion: returns bmv [16, 2] (Q3) interpolated
    from the LAST-frame-referencing neighbors, and rewrites the MB's
    mode info to SPLITMV/LAST, partitioning 3."""
    neigh = []   # (ref_frame, mv_row, mv_col) per NUM_NEIGHBORS slot
    for (dr, dc), j in _NEIGH_SRC:
        rr, cc = r + dr, c + dc
        # find_neighboring_blocks: neighbors outside the frame leave
        # their slot empty (ref = MAX_REF, never matches LAST)
        if 0 <= rr < mb_rows and 0 <= cc < mb_cols:
            neigh.append((int(mi["ref_frame"][rr + 1, cc + 1]),
                          *_block_mv(mi, rr, cc, j)))
        else:
            neigh.append((MAX_REF, 0, 0))

    bmv = np.zeros((16, 2), np.int64)
    for row in range(4):
        for col in range(4):
            w_sum = mv_r = mv_c = 0
            for k, pos in enumerate(_NEIGH_POS):
                if neigh[k][0] != LAST:
                    continue
                w = int(WEIGHTS_Q7[abs(row - pos[0]), abs(col - pos[1])])
                w_sum += w
                mv_r += w * neigh[k][1]
                mv_c += w * neigh[k][2]
            if w_sum > 0:
                # Q10 / Q7 = Q3, C integer division (truncation)
                bmv[row * 4 + col, 0] = int(mv_r / w_sum)
                bmv[row * 4 + col, 1] = int(mv_c / w_sum)
    mi["mode"][r + 1, c + 1] = SPLITMV
    mi["ref_frame"][r + 1, c + 1] = LAST
    mi["bmvs"][r, c] = bmv
    mi["mvs"][r + 1, c + 1] = bmv[15]
    mi["part"][r, c] = 3
    mi["clamp"][r, c] = 1
    return bmv


def estimate_missing_mvs(mi, prev, mb_rows, mb_cols, corrupt_from):
    """vp8_estimate_missing_mvs: for every MB at raster index >=
    corrupt_from, per-4x4 MVs are the overlap-weighted average of the
    previous frame's 4x4 blocks projected by their own MVs.

    prev: dict with "bmv" [mr, mc, 16, 2] per-4x4 MVs (Q3) and
    "ref" [mr, mc] reference ids from the previous frame, or None."""
    h8 = mb_rows * 4    # 4x4 block rows
    w8 = mb_cols * 4
    num = np.zeros((h8, w8, 2), np.int64)
    den = np.zeros((h8, w8), np.int64)
    if prev is not None:
        pb = prev["bmv"]                       # [mr, mc, 16, 2]
        pref = prev["ref"]                     # [mr, mc]
        # absolute 4x4-block grid of the previous frame
        bmv = pb.reshape(mb_rows, mb_cols, 4, 4, 2)
        bmv = bmv.transpose(0, 2, 1, 3, 4).reshape(h8, w8, 2)
        refm = np.repeat(np.repeat(pref == LAST, 4, 0), 4, 1)
        by, bx = np.mgrid[0:h8, 0:w8]
        # landing position in Q3 eighth-pel (calculate_overlaps: the
        # projected block starts at block*4*8 + mv)
        new_r = by * 32 + bmv[:, :, 0]
        new_c = bx * 32 + bmv[:, :, 1]
        # first overlapped block index and in-block offset
        fr_ = new_r >> 5
        fc_ = new_c >> 5
        or_ = new_r & 31
        oc_ = new_c & 31
        for dr in (0, 1):
            for dc in (0, 1):
                # overlap area (Q3 units^2) with block (fr_+dr, fc_+dc)
                hgt = np.where(dr == 0, 32 - or_, or_)
                wdt = np.where(dc == 0, 32 - oc_, oc_)
                area = hgt * wdt
                tr = fr_ + dr
                tc = fc_ + dc
                ok = (refm & (area > 0) & (tr >= 0) & (tr < h8)
                      & (tc >= 0) & (tc < w8))
                ti = tr[ok] * w8 + tc[ok]
                np.add.at(den.reshape(-1), ti, area[ok])
                np.add.at(num.reshape(-1, 2), ti,
                          area[ok, None] * bmv[ok])
    est = np.zeros((h8, w8, 2), np.int64)
    nz = den > 0
    # C integer division truncates toward zero (estimate_mv)
    est[nz] = np.sign(num[nz]) * (np.abs(num[nz]) // den[nz, None])
    for idx in range(corrupt_from, mb_rows * mb_cols):
        r, c = idx // mb_cols, idx % mb_cols
        blk = est[r * 4:r * 4 + 4, c * 4:c * 4 + 4].reshape(16, 2)
        mi["mode"][r + 1, c + 1] = SPLITMV
        mi["ref_frame"][r + 1, c + 1] = LAST
        mi["bmvs"][r, c] = blk
        mi["mvs"][r + 1, c + 1] = blk[15]
        mi["part"][r, c] = 3
        mi["clamp"][r, c] = 1
        mi["skips"][r, c] = True
