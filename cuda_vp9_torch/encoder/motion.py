"""Motion estimation + MV entropy writing for the VP9 encoder.

Reference counterparts: vp9/encoder/vp9_mcomp.c (diamond + subpel
search), vp9/encoder/vp9_encodemv.c (vp9_encode_mv).  Design
notes: the search runs on the host over the in-loop reconstruction
(the encoder is a capability-parity component, not the device's hot
path — decode throughput is; see SURVEY §7), uses vectorized
NumPy SAD over candidate grids instead of the reference's per-pixel C
loops, and scores candidates with the same rate model shape
(SAD + lambda * mv_bits) as vp9_mcomp.c's mvsad_err_cost.

MV writing mirrors decoder/decodemv.py's _read_mv exactly (the decode
tree IS the spec); allow_high_precision_mv is always 0 in this
encoder, so components are quarter-pel (even 1/8-pel units) and the hp
bit is never coded.
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from ..decoder import constants as C
from ..ops.ref import inter as ref_inter
from .bitwriter import tree_paths

# MV_JOINT codes (decodemv._read_mv): row-nonzero / col-nonzero flags
_JOINT_PATHS = tree_paths(M.MV_JOINT_TREE)
_CLASS_PATHS = tree_paths(M.MV_CLASS_TREE)
_FP_PATHS = tree_paths(M.MV_FP_TREE)


def _get_mv_class(z: int):
    z = int(z)
    q = z >> 3
    c = 0 if q == 0 else min(10, q.bit_length() - 1)
    base = 0 if c == 0 else C.CLASS0_SIZE << (c + 2)
    return c, z - base


def write_mv_component(w, fc, comp: int, v: int) -> None:
    """Mirror of decodemv._read_mv_component with usehp=False: the
    decoder forces hp=1, so |v| must be even (quarter-pel)."""
    assert v != 0 and v % 2 == 0, "MV component diffs are quarter-pel"
    sign = 1 if v < 0 else 0
    w.write(sign, int(fc.mv_sign[comp]))
    z = (-v if sign else v) - 1
    mv_class, offset = _get_mv_class(z)
    w.write_tree(M.MV_CLASS_TREE, fc.mv_classes[comp].tolist(),
                 _CLASS_PATHS, mv_class)
    d = offset >> 3
    fr = (offset >> 1) & 3
    if mv_class == 0:
        w.write(d, int(fc.mv_class0[comp][0]))
        fp_probs = fc.mv_class0_fp[comp][d]
    else:
        n = mv_class + C.CLASS0_BITS - 1
        for i in range(n):
            w.write((d >> i) & 1, int(fc.mv_bits[comp][i]))
        fp_probs = fc.mv_fp[comp]
    w.write_tree(M.MV_FP_TREE, fp_probs.tolist(), _FP_PATHS, fr)
    # usehp=False: no hp bit; decoder reconstructs hp=1 (z is odd)


def write_mv(w, fc, mv, ref) -> None:
    """Mirror of decodemv._read_mv: joint tree then nonzero components."""
    dr = mv[0] - ref[0]
    dc = mv[1] - ref[1]
    joint = ((C.MV_JOINT_HNZVNZ if dc else C.MV_JOINT_HZVNZ) if dr
             else (C.MV_JOINT_HNZVZ if dc else C.MV_JOINT_ZERO))
    w.write_tree(M.MV_JOINT_TREE, fc.mv_joints.tolist(), _JOINT_PATHS,
                 joint)
    if dr:
        write_mv_component(w, fc, 0, dr)
    if dc:
        write_mv_component(w, fc, 1, dc)


def mv_bits_estimate(mv, ref) -> int:
    """Cheap bit-count model for rate-weighted search (the reference
    precomputes exact table costs in vp9_build_nmv_cost_table; a
    class-based estimate is enough to steer the search)."""
    bits = 2
    for d in (mv[0] - ref[0], mv[1] - ref[1]):
        if d:
            z = abs(d) - 1
            c, _ = _get_mv_class(z)
            bits += 5 + (1 if c == 0 else c + C.CLASS0_BITS - 1) + 2
    return bits


# ------------------------------------------------------------- search


def _fullpel_sad_grid(src, ref, crop_w, crop_h, x0, y0, drs, dcs):
    """SAD of src [h, w] vs edge-clamped ref windows at full-pel offsets
    (y0+dr, x0+dc) for every (dr, dc) pair — vectorized gather."""
    h, w = src.shape
    rows = np.clip(y0 + drs[:, None] + np.arange(h)[None, :], 0,
                   crop_h - 1)                        # [n, h]
    cols = np.clip(x0 + dcs[:, None] + np.arange(w)[None, :], 0,
                   crop_w - 1)                        # [n, w]
    wins = ref[rows[:, :, None], cols[:, None, :]].astype(np.int64)
    return np.abs(wins - src[None].astype(np.int64)).sum(axis=(1, 2))


def full_pel_search(src, ref, crop_w, crop_h, x0, y0, starts,
                    sad_range: int = 16, lam: int = 4,
                    pred_mv=(0, 0)):
    """Coarse-to-fine full-pel search from each start MV (units: pixels).

    Returns (best_dr, best_dc, best_cost).  Grid step halves from 4 to 1
    around the running best (the reference's diamond pattern serves the
    same purpose; a shrinking square is equivalent here and vectorizes)."""
    cands = set()
    for sr, sc in starts:
        cands.add((int(sr), int(sc)))
    best = None
    for step in (4, 2, 1):
        grid = set()
        for (br, bc) in cands:
            for dr in (-step, 0, step):
                for dc in (-step, 0, step):
                    r, c = br + dr, bc + dc
                    if abs(r) <= sad_range and abs(c) <= sad_range:
                        grid.add((r, c))
        arr = np.array(sorted(grid), np.int64)
        sads = _fullpel_sad_grid(src, ref, crop_w, crop_h, x0, y0,
                                 arr[:, 0], arr[:, 1])
        costs = sads + lam * np.array(
            [mv_bits_estimate((r * 8, c * 8), pred_mv)
             for r, c in arr], np.int64)
        i = int(np.argmin(costs))
        best = (int(arr[i, 0]), int(arr[i, 1]), int(costs[i]),
                int(sads[i]))
        cands = {(best[0], best[1])}
    return best


def subpel_refine(src, ref, crop_w, crop_h, x0, y0, mv_fullpel,
                  kernel, bd, lam: int = 4, pred_mv=(0, 0)):
    """Quarter-pel refinement (allow_hp=0): two halving rounds from the
    full-pel winner, scoring the 8-neighborhood at each precision via
    the normative 8-tap convolve.  MV units: 1/8 pel, always even."""
    h, w = src.shape
    s64 = src.astype(np.int64)
    best_mv = (mv_fullpel[0] * 8, mv_fullpel[1] * 8)

    def cost_of(mv):
        # convolve_block wants q4 (1/16-pel) positions; mv is q3
        # (1/8 pel) -- same doubling as recon._mc_unit's unscaled branch
        srow_q4 = mv[0] * 2
        scol_q4 = mv[1] * 2
        p = ref_inter.convolve_block(
            ref, crop_w, crop_h, x0 + (scol_q4 >> 4), y0 + (srow_q4 >> 4),
            scol_q4 & 15, srow_q4 & 15, 16, 16, w, h, kernel, bd, None)
        sad = int(np.abs(p - s64).sum())
        return sad + lam * mv_bits_estimate(mv, pred_mv), sad

    best_cost, best_sad = cost_of(best_mv)
    for step in (4, 2):     # half-pel then quarter-pel (1/8-units)
        improved = True
        while improved:
            improved = False
            for dr, dc in ((-step, 0), (step, 0), (0, -step), (0, step),
                           (-step, -step), (-step, step), (step, -step),
                           (step, step)):
                mv = (best_mv[0] + dr, best_mv[1] + dc)
                if not (C.MV_LOW < mv[0] < C.MV_UPP
                        and C.MV_LOW < mv[1] < C.MV_UPP):
                    continue
                cst, sad = cost_of(mv)
                if cst < best_cost:
                    best_cost, best_sad, best_mv = cst, sad, mv
                    improved = True
    return best_mv, best_cost, best_sad
