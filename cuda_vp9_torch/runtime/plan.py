"""Device plan: dense, bucketed, padded tensors for the TPU frame step.

This is the TPU-native replacement for the reference's per-frame work
buffers (vpx-master/buffers_struct.h frameBuf/ModeInfoBuf and the host
flattening in createBuffers/createBuffersTr,
inter_cuda_kernel.cu:897/intra_cuda_kernel.cu:1252) — re-designed as
fixed-shape tensor buckets so the whole reconstruction compiles once per
frame-geometry bucket:

  * coefficient buckets per tx size (+ tx type) for the batched inverse
    transforms, scattered into per-plane residual planes
  * motion-compensation unit buckets per block shape
  * an intra wavefront schedule (computed here, once, on the host — unlike
    the reference's per-wave frame re-scan frameAnalyz,
    intra_cuda_kernel.cu:1123)
  * loop-filter metadata per superblock

All arrays are padded to power-of-two batch sizes so jit caches stay small.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import models as M
from ..decoder import constants as C
from ..decoder.blockd import FramePlan

_INTRA_MODE_TO_TX_TYPE = np.array(
    [C.DCT_DCT, C.ADST_DCT, C.DCT_ADST, C.DCT_DCT, C.ADST_ADST, C.ADST_DCT,
     C.DCT_ADST, C.DCT_ADST, C.ADST_DCT, C.ADST_ADST], np.int32)


def _pad_pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass
class CoeffBucket:
    """All coded tx blocks of one (tx_size, tx_type) for one plane set."""
    tx_size: int
    tx_type: int       # 0..3 (forced 0 for 32x32 / lossless-WHT bucket -1)
    lossless: bool
    coeffs: np.ndarray  # [N, n*n] int32 (padded rows zero)
    plane: np.ndarray   # [N] int32
    y4: np.ndarray      # [N] top-left in plane 4x4 units
    x4: np.ndarray
    count: int


@dataclass
class McUnit:
    plane: int
    dx: int
    dy: int
    w: int
    h: int
    ref_slot: int      # 0..2 (index into the frame's 3 active refs)
    x0: int
    y0: int
    subpel_x: int
    subpel_y: int
    xs: int
    ys: int
    filter: int
    is_avg: int


@dataclass
class IntraUnit:
    plane: int
    x0: int            # pixel position in plane
    y0: int
    bs: int            # 4/8/16/32
    mode: int
    have_up: int
    have_left: int
    have_right: int
    right_clipped: int
    bottom_clipped: int
    wave: int


@dataclass
class DevicePlan:
    hdr: object
    coeff_buckets: List[CoeffBucket]
    mc_buckets: Dict[Tuple[int, int], dict]       # (w, h) -> padded arrays
    intra_buckets: List[dict]                     # per wave x bs group
    num_waves: int
    mi: object
    seg_map: np.ndarray
    any_inter: bool


def build_coeff_buckets(plan: FramePlan) -> List[CoeffBucket]:
    """Group every coded tx block by (tx_size, tx_type)."""
    hdr = plan.hdr
    mi = plan.mi
    lossless = bool(hdr.lossless)
    groups: Dict[Tuple[int, int], list] = {}
    for plane in range(3):
        eob = plan.eob_maps[plane]
        off = plan.coeff_off_maps[plane]
        ys, xs = np.nonzero(eob > 0)
        for y4, x4 in zip(ys.tolist(), xs.tolist()):
            mi_row = (y4 << (1 if plane else 0)) >> 1
            mi_col = (x4 << (1 if plane else 0)) >> 1
            mi_row = min(mi_row, mi.mi_rows - 1)
            mi_col = min(mi_col, mi.mi_cols - 1)
            bsize = int(mi.sb_type[mi_row, mi_col])
            tx_y = int(mi.tx_size[mi_row, mi_col])
            if plane:
                tx = int(M.UV_TXSIZE_LOOKUP[bsize][tx_y][1][1])
                tt = C.DCT_DCT
            else:
                tx = tx_y
                if lossless or mi.ref[mi_row, mi_col, 0] > C.INTRA_FRAME:
                    tt = C.DCT_DCT
                else:
                    if bsize < C.BLOCK_8X8:
                        sub = ((y4 & 1) << 1) | (x4 & 1)
                        mode = int(mi.bmi_mode[mi_row, mi_col, sub])
                    else:
                        mode = int(mi.mode[mi_row, mi_col])
                    tt = int(_INTRA_MODE_TO_TX_TYPE[mode])
            if tx == 3:
                tt = 0
            groups.setdefault((tx, tt), []).append((plane, y4, x4))

    buckets = []
    for (tx, tt), items in sorted(groups.items()):
        n = 4 << tx
        count = len(items)
        cap = _pad_pow2(count)
        coeffs = np.zeros((cap, n * n), np.int32)
        pl = np.zeros(cap, np.int32)
        yy = np.zeros(cap, np.int32)
        xx = np.zeros(cap, np.int32)
        for i, (plane, y4, x4) in enumerate(items):
            o = int(plan.coeff_off_maps[plane][y4, x4])
            coeffs[i] = plan.coeffs[plane][o:o + n * n]
            pl[i] = plane
            yy[i] = y4
            xx[i] = x4
        buckets.append(CoeffBucket(tx, tt, lossless, coeffs, pl, yy, xx,
                                   count))
    return buckets


def build_mc_units(plan: FramePlan, ref_sizes) -> List[McUnit]:
    """Flatten every inter prediction unit (dec_build_inter_predictors_sb
    parity; one unit per 4x4 for sub-8x8 blocks, one per plane otherwise).

    `ref_sizes` maps LAST/GOLDEN/ALTREF -> (width, height) of the reference
    (for scale factors), or None.
    """
    from ..ops.ref import inter as ref_inter
    hdr = plan.hdr
    mi = plan.mi
    units: List[McUnit] = []
    if hdr.frame_is_intra_only:
        return units
    ss_x, ss_y = hdr.subsampling_x, hdr.subsampling_y

    sfs = {}
    for k in (1, 2, 3):
        if ref_sizes.get(k):
            rw, rh = ref_sizes[k]
            sfs[k] = ref_inter.ScaleFactors(rw, rh, hdr.width, hdr.height)

    for blk in plan.blocks:
        mi_row, mi_col = blk.mi_row, blk.mi_col
        if mi.ref[mi_row, mi_col, 0] <= C.INTRA_FRAME:
            continue
        bsize = blk.bsize
        bwl, bhl = blk.bwl, blk.bhl
        bw_mi = 1 << (bwl - 1)
        bh_mi = 1 << (bhl - 1)
        mi_x, mi_y = mi_col * 8, mi_row * 8
        mb_to_left = -mi_x * 8
        mb_to_top = -mi_y * 8
        mb_to_right = (hdr.mi_cols - bw_mi - mi_col) * 64
        mb_to_bottom = (hdr.mi_rows - bh_mi - mi_row) * 64
        is_compound = mi.ref[mi_row, mi_col, 1] > C.INTRA_FRAME
        filt = int(mi.interp_filter[mi_row, mi_col])
        for ref_i in range(1 + int(is_compound)):
            ref_frame = int(mi.ref[mi_row, mi_col, ref_i])
            sf = sfs.get(ref_frame)
            if sf is None:
                continue
            is_scaled = sf.is_scaled()
            for plane in range(3):
                sx = ss_x if plane else 0
                sy = ss_y if plane else 0
                n4_w = (1 << bwl) >> sx
                n4_h = (1 << bhl) >> sy
                if bsize < C.BLOCK_8X8:
                    bmi_mv = mi.bmi_mv[mi_row, mi_col]
                    for y in range(n4_h):
                        for x in range(n4_w):
                            mv = ref_inter.average_split_mv(
                                bmi_mv, ref_i, y * 2 + x, sx, sy)
                            units.append(_mc_unit(
                                plane, mv, 4 * x, 4 * y, 4, 4, mi_x, mi_y,
                                mb_to_left, mb_to_top, mb_to_right,
                                mb_to_bottom, sx, sy, sf, is_scaled, filt,
                                ref_frame - 1, ref_i))
                else:
                    mv = (int(mi.mv[mi_row, mi_col, ref_i, 0]),
                          int(mi.mv[mi_row, mi_col, ref_i, 1]))
                    units.append(_mc_unit(
                        plane, mv, 0, 0, 4 * n4_w, 4 * n4_h, mi_x, mi_y,
                        mb_to_left, mb_to_top, mb_to_right, mb_to_bottom,
                        sx, sy, sf, is_scaled, filt, ref_frame - 1, ref_i))
    return units


def _mc_unit(plane, mv, x, y, w, h, mi_x, mi_y, mb_to_left, mb_to_top,
             mb_to_right, mb_to_bottom, sx, sy, sf, is_scaled, filt,
             ref_slot, ref_i) -> McUnit:
    SP = 4
    if is_scaled:
        spel_left = (4 + w) << SP
        spel_right = spel_left - 16
        spel_top = (4 + h) << SP
        spel_bottom = spel_top - 16
        r4 = mv[0] * (1 << (1 - sy))
        c4 = mv[1] * (1 << (1 - sx))
        r4 = max(mb_to_top * (1 << (1 - sy)) - spel_top,
                 min(mb_to_bottom * (1 << (1 - sy)) + spel_bottom, r4))
        c4 = max(mb_to_left * (1 << (1 - sx)) - spel_left,
                 min(mb_to_right * (1 << (1 - sx)) + spel_right, c4))
        x_start = (-mb_to_left >> (3 + sx))
        y_start = (-mb_to_top >> (3 + sy))
        x0 = sf.scaled_x(x_start + x)
        y0 = sf.scaled_y(y_start + y)
        srow, scol = sf.scale_mv(r4, c4, mi_x + x, mi_y + y)
        xs, ys = sf.x_step_q4, sf.y_step_q4
    else:
        x0 = (-mb_to_left >> (3 + sx)) + x
        y0 = (-mb_to_top >> (3 + sy)) + y
        srow = mv[0] * (1 << (1 - sy))
        scol = mv[1] * (1 << (1 - sx))
        xs = ys = 16
    subpel_x = scol & 15
    subpel_y = srow & 15
    x0 += scol >> SP
    y0 += srow >> SP
    return McUnit(plane, (mi_x >> sx) + x, (mi_y >> sy) + y, w, h, ref_slot,
                  x0, y0, subpel_x, subpel_y, xs, ys, filt, ref_i)


def build_intra_units(plan: FramePlan) -> Tuple[List[IntraUnit], int]:
    """Emit every intra tx block with its wavefront number.

    Waves are computed in one pass over the parse-order block list (the
    reference re-scans the frame per wave, intra_cuda_kernel.cu:1123; here
    the schedule falls out of z-order): a unit's wave is 1 + the max wave of
    the already-scheduled cells its prediction edges touch (inter/residual
    content is wave 0).
    """
    hdr = plan.hdr
    mi = plan.mi
    ss_x, ss_y = hdr.subsampling_x, hdr.subsampling_y
    units: List[IntraUnit] = []
    if not np.any(mi.ref[:, :, 0] <= C.INTRA_FRAME):
        return units, 0  # no intra blocks: skip the per-block scan
    # per-plane wave map in 4x4 units (plain lists: the per-unit reads
    # and writes are tiny, where numpy call overhead dominates)
    wave_maps = []
    for p in range(3):
        h = (hdr.mi_rows * 2) >> (ss_y if p else 0)
        w = (hdr.mi_cols * 2) >> (ss_x if p else 0)
        wave_maps.append([[0] * w for _ in range(h)])
    num_waves = 0
    tile_starts = _tile_col_starts(hdr)

    blocks = plan.blocks
    arr = getattr(plan, "blocks_arr", None)
    if arr is not None and len(arr):
        # iterate only intra-coded blocks (inter blocks never touch the
        # wave maps): big win on inter frames with sparse intra content
        keep = mi.ref[arr[:, 0], arr[:, 1], 0] <= C.INTRA_FRAME
        from ..decoder.blockd import BlockRecord
        blocks = [BlockRecord(*row) for row in arr[keep].tolist()]

    for blk in blocks:
        mi_row, mi_col = blk.mi_row, blk.mi_col
        if mi.ref[mi_row, mi_col, 0] > C.INTRA_FRAME:
            continue
        bsize = blk.bsize
        bwl, bhl = blk.bwl, blk.bhl
        bw_mi = 1 << (bwl - 1)
        bh_mi = 1 << (bhl - 1)
        mb_to_right = (hdr.mi_cols - bw_mi - mi_col) * 64
        mb_to_bottom = (hdr.mi_rows - bh_mi - mi_row) * 64
        tile_start = 0
        for t in tile_starts:
            if t <= mi_col:
                tile_start = t
        have_up_blk = mi_row > 0
        have_left_blk = mi_col > tile_start
        tx_y = int(mi.tx_size[mi_row, mi_col])
        for plane in range(3):
            sx = ss_x if plane else 0
            sy = ss_y if plane else 0
            wmap = wave_maps[plane]
            H4, W4 = len(wmap), len(wmap[0])
            tx = int(M.UV_TXSIZE_LOOKUP[bsize][tx_y][sx][sy]) if plane \
                else tx_y
            n4_w = (1 << bwl) >> sx
            n4_h = (1 << bhl) >> sy
            n4_wl = bwl - sx
            step = 1 << tx
            max_bw = n4_w + (mb_to_right >> (5 + sx) if mb_to_right < 0
                             else 0)
            max_bh = n4_h + (mb_to_bottom >> (5 + sy) if mb_to_bottom < 0
                             else 0)
            bx4 = (mi_col * 2) >> sx
            by4 = (mi_row * 2) >> sy
            mode_blk = int(mi.mode[mi_row, mi_col]) if plane == 0 else \
                int(mi.uv_mode[mi_row, mi_col])
            for row in range(0, max_bh, step):
                for col in range(0, max_bw, step):
                    mode = mode_blk
                    if bsize < C.BLOCK_8X8 and plane == 0:
                        mode = int(mi.bmi_mode[mi_row, mi_col,
                                               (row << 1) + col])
                    x4 = bx4 + col
                    y4 = by4 + row
                    have_up = (row > 0) or have_up_blk
                    have_left = (col > 0) or have_left_blk
                    have_right = (col + step) < (1 << n4_wl)
                    # dependency cells: above row (incl. above-right reach),
                    # left column, above-left
                    w = 0
                    if have_up and y4 > 0:
                        xr = min(W4, x4 + 2 * step + 1)
                        xl = max(0, x4 - 1)
                        w = max(wmap[y4 - 1][xl:xr])
                    if have_left and x4 > 0:
                        yl = min(H4, y4 + step)
                        xm = x4 - 1
                        for yy in range(y4, yl):
                            v = wmap[yy][xm]
                            if v > w:
                                w = v
                    wave = w + 1
                    if wave > num_waves:
                        num_waves = wave
                    # clip to the frame's 4x4 extent: a straddling tx
                    # block's OOB cells are never read (reads clip),
                    # and writing them walks off the map
                    fill = [wave] * min(step, W4 - x4)
                    for yy in range(y4, min(y4 + step, H4)):
                        wmap[yy][x4:x4 + step] = fill
                    units.append(IntraUnit(
                        plane, x4 * 4, y4 * 4, 4 << tx, mode,
                        int(have_up), int(have_left), int(have_right),
                        int(mb_to_right < 0), int(mb_to_bottom < 0), wave))
    return units, num_waves


def _tile_col_starts(hdr):
    cols = 1 << hdr.log2_tile_cols
    starts = []
    sb_cols = ((hdr.mi_cols + 7) & ~7) >> 3
    for tc in range(cols):
        starts.append(min(((tc * sb_cols) >> hdr.log2_tile_cols) << 3,
                          hdr.mi_cols))
    return starts
