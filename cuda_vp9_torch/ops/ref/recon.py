"""NumPy frame reconstruction oracle: consumes a FramePlan + reference
frames, produces the reconstructed planes.

This is the CPU mirror of the TPU reconstruction pipeline and the oracle
every Pallas kernel is validated against.  Traversal parity with the
reference's per-block reconstruction (vp9/decoder/vp9_decodeframe.c
predict_and_reconstruct_intra_block / reconstruct_inter_block /
dec_build_inter_predictors_sb) in parse (z-)order.
"""

from __future__ import annotations

import numpy as np

from ... import models as M
from ...decoder import constants as C
from ...decoder.blockd import FramePlan
from . import inter, intra, loopfilter, transforms

_INTRA_MODE_TO_TX_TYPE = [C.DCT_DCT, C.ADST_DCT, C.DCT_ADST, C.DCT_DCT,
                          C.ADST_ADST, C.ADST_DCT, C.DCT_ADST, C.DCT_ADST,
                          C.ADST_DCT, C.ADST_ADST]


class RefBuffer:
    """One reference-slot frame: planes + geometry."""

    def __init__(self, planes, width, height, bit_depth, ss_x=1, ss_y=1):
        self.planes = planes  # list of 3 2-D arrays (aligned dims)
        self.width = width    # crop dims
        self.height = height
        self.bit_depth = bit_depth
        self.ss_x = ss_x
        self.ss_y = ss_y


def _tile_col_starts(hdr):
    cols = 1 << hdr.log2_tile_cols
    starts = []
    for tc in range(cols + 1):
        sb_cols = ((hdr.mi_cols + 7) & ~7) >> 3
        off = ((tc * sb_cols) >> hdr.log2_tile_cols) << 3
        starts.append(min(off, hdr.mi_cols))
    return starts


def reconstruct_frame(plan: FramePlan, refs, prev_recon=None) -> list:
    """Decode one frame's pixels.  `refs` maps LAST/GOLDEN/ALTREF (1..3) to
    RefBuffer or None.  Returns [y, u, v] planes (aligned dims, uint16)."""
    hdr = plan.hdr
    bd = hdr.bit_depth
    mi = plan.mi
    ss_x = hdr.subsampling_x
    ss_y = hdr.subsampling_y
    # stored (aligned) dims equal the mi grid extent; allocate SB-aligned so
    # edge blocks can overhang like the reference's bordered buffers
    w = hdr.mi_cols * 8
    h = hdr.mi_rows * 8
    wa = ((hdr.mi_cols + 7) & ~7) * 8
    ha = ((hdr.mi_rows + 7) & ~7) * 8
    planes = [np.zeros((ha, wa), np.uint16),
              np.zeros((ha >> ss_y, wa >> ss_x), np.uint16),
              np.zeros((ha >> ss_y, wa >> ss_x), np.uint16)]
    aligned_dims = [(w, h), (w >> ss_x, h >> ss_y), (w >> ss_x, h >> ss_y)]

    tile_starts = _tile_col_starts(hdr)

    def tile_col_start(mi_col):
        for i in range(len(tile_starts) - 1, -1, -1):
            if tile_starts[i] <= mi_col:
                return tile_starts[i]
        return 0

    # scale factors per used ref
    sfs = {}
    for k in (1, 2, 3):
        rb = refs.get(k)
        if rb is not None:
            sfs[k] = inter.ScaleFactors(rb.width, rb.height,
                                        hdr.width, hdr.height)

    kernels = M.FILTER_KERNELS

    coeff_off = plan.coeff_off_maps
    eob_maps = plan.eob_maps
    coeffs = plan.coeffs

    for blk in plan.blocks:
        mi_row, mi_col, bsize = blk.mi_row, blk.mi_col, blk.bsize
        bwl, bhl = blk.bwl, blk.bhl
        bw_mi = 1 << (bwl - 1)
        bh_mi = 1 << (bhl - 1)
        mb_to_right = (hdr.mi_cols - bw_mi - mi_col) * 64
        mb_to_bottom = (hdr.mi_rows - bh_mi - mi_row) * 64
        right_clipped = mb_to_right < 0
        bottom_clipped = mb_to_bottom < 0
        is_inter = mi.ref[mi_row, mi_col, 0] > C.INTRA_FRAME
        skip = bool(mi.skip[mi_row, mi_col])
        tx_size_y = int(mi.tx_size[mi_row, mi_col])
        lossless = bool(hdr.lossless)

        if not is_inter:
            _recon_intra_block(planes, aligned_dims, mi, mi_row, mi_col,
                               bsize, bwl, bhl, tx_size_y, skip, lossless,
                               mb_to_right, mb_to_bottom,
                               tile_col_start(mi_col), ss_x, ss_y, bd,
                               coeff_off, eob_maps, coeffs)
        else:
            _predict_inter_block(planes, mi, mi_row, mi_col, bsize, bwl, bhl,
                                 refs, sfs, kernels, hdr, ss_x, ss_y, bd)
            if not skip:
                _add_inter_residuals(planes, mi_row, mi_col, bsize, bwl, bhl,
                                     tx_size_y, lossless, mb_to_right,
                                     mb_to_bottom, ss_x, ss_y, bd,
                                     coeff_off, eob_maps, coeffs)

    # loop filter (in place)
    loopfilter.filter_frame(planes, mi, plan.seg_map, hdr,
                            hdr.mi_rows, hdr.mi_cols, ss_x, ss_y, bd)
    return planes


def _residual(coeff_vec, tx_size, tx_type, lossless, bd):
    if lossless:
        return transforms.inv_wht2d(coeff_vec[None], bd)[0]
    return transforms.inv_txfm2d(coeff_vec[None], tx_size, tx_type, bd)[0]


def _add_residual(plane, y, x, res, bd):
    h, w = res.shape
    maxval = (1 << bd) - 1
    region = plane[y:y + h, x:x + w]
    region[:] = np.clip(region.astype(np.int64) + res, 0, maxval)


def _recon_intra_block(planes, aligned_dims, mi, mi_row, mi_col, bsize,
                       bwl, bhl, tx_size_y, skip, lossless, mb_to_right,
                       mb_to_bottom, tile_start, ss_x, ss_y, bd, coeff_off,
                       eob_maps, coeffs):
    have_up_blk = mi_row > 0
    have_left_blk = mi_col > tile_start
    for plane in range(3):
        sx = ss_x if plane else 0
        sy = ss_y if plane else 0
        recon = planes[plane]
        fw, fh = aligned_dims[plane]
        if plane:
            tx_size = int(M.UV_TXSIZE_LOOKUP[bsize][tx_size_y][sx][sy])
        else:
            tx_size = tx_size_y
        n4_w = (1 << bwl) >> sx
        n4_h = (1 << bhl) >> sy
        n4_wl = bwl - sx
        step = 1 << tx_size
        max_bw = n4_w + (mb_to_right >> (5 + sx) if mb_to_right < 0 else 0)
        max_bh = n4_h + (mb_to_bottom >> (5 + sy) if mb_to_bottom < 0 else 0)
        bx4 = (mi_col * 2) >> sx
        by4 = (mi_row * 2) >> sy
        mode_blk = int(mi.mode[mi_row, mi_col]) if plane == 0 else \
            int(mi.uv_mode[mi_row, mi_col])
        bs = 4 << tx_size
        for row in range(0, max_bh, step):
            for col in range(0, max_bw, step):
                mode = mode_blk
                if bsize < C.BLOCK_8X8 and plane == 0:
                    mode = int(mi.bmi_mode[mi_row, mi_col, (row << 1) + col])
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
                recon[y0:y0 + bs, x0:x0 + bs] = pred
                if not skip:
                    eob = int(eob_maps[plane][by4 + row, bx4 + col])
                    if eob > 0:
                        off = int(coeff_off[plane][by4 + row, bx4 + col])
                        cv = coeffs[plane][off:off + bs * bs]
                        tx_type = (C.DCT_DCT if (plane or lossless)
                                   else _INTRA_MODE_TO_TX_TYPE[mode])
                        res = _residual(cv, tx_size, tx_type, lossless, bd)
                        _add_residual(recon, y0, x0, res, bd)


def _predict_inter_block(planes, mi, mi_row, mi_col, bsize, bwl, bhl,
                         refs, sfs, kernels, hdr, ss_x, ss_y, bd):
    is_compound = mi.ref[mi_row, mi_col, 1] > C.INTRA_FRAME
    kernel = kernels[int(mi.interp_filter[mi_row, mi_col])]
    mi_x = mi_col * 8
    mi_y = mi_row * 8
    mb_to_left = -mi_x * 8
    mb_to_top = -mi_y * 8
    bw_mi = 1 << (bwl - 1)
    bh_mi = 1 << (bhl - 1)
    mb_to_right = (hdr.mi_cols - bw_mi - mi_col) * 64
    mb_to_bottom = (hdr.mi_rows - bh_mi - mi_row) * 64

    for ref_i in range(1 + int(is_compound)):
        ref_frame = int(mi.ref[mi_row, mi_col, ref_i])
        rb = refs.get(ref_frame)
        if rb is None:
            continue  # missing reference: prediction undefined; leave as-is
        sf = sfs[ref_frame]
        is_scaled = sf.is_scaled()
        for plane in range(3):
            sx = ss_x if plane else 0
            sy = ss_y if plane else 0
            dst = planes[plane]
            ref_plane = rb.planes[plane]
            crop_w = (rb.width + sx) >> sx if plane else rb.width
            crop_h = (rb.height + sy) >> sy if plane else rb.height
            n4_w = (1 << bwl) >> sx
            n4_h = (1 << bhl) >> sy
            if bsize < C.BLOCK_8X8:
                bmi_mv = mi.bmi_mv[mi_row, mi_col]
                for y in range(n4_h):
                    for x in range(n4_w):
                        # the block index is the PLANE-raster 4x4 index
                        # (vp9_reconinter.c build_inter_predictors is
                        # called per plane block i = y*n4_w + x); for
                        # 4:2:2 this makes chroma block 1 average luma
                        # blocks 1 and 2 -- a reference quirk that is
                        # normative
                        mv = inter.average_split_mv(bmi_mv, ref_i,
                                                    y * n4_w + x, sx, sy)
                        _mc_unit(dst, ref_plane, crop_w, crop_h, mv,
                                 4 * x, 4 * y, 4, 4, mi_x, mi_y,
                                 mb_to_left, mb_to_top, mb_to_right,
                                 mb_to_bottom, sx, sy, sf, is_scaled,
                                 kernel, bd, ref_i)
            else:
                mv = (int(mi.mv[mi_row, mi_col, ref_i, 0]),
                      int(mi.mv[mi_row, mi_col, ref_i, 1]))
                _mc_unit(dst, ref_plane, crop_w, crop_h, mv, 0, 0,
                         4 * n4_w, 4 * n4_h, mi_x, mi_y, mb_to_left,
                         mb_to_top, mb_to_right, mb_to_bottom, sx, sy,
                         sf, is_scaled, kernel, bd, ref_i)


def _mc_unit(dst, ref_plane, crop_w, crop_h, mv, x, y, w, h, mi_x, mi_y,
             mb_to_left, mb_to_top, mb_to_right, mb_to_bottom, sx, sy,
             sf, is_scaled, kernel, bd, ref_i):
    """One prediction unit (dec_build_inter_predictors parity)."""
    SP = inter.SUBPEL_BITS
    if is_scaled:
        spel_left = (inter.INTERP_EXTEND + w) << SP
        spel_right = spel_left - inter.SUBPEL_SHIFTS
        spel_top = (inter.INTERP_EXTEND + h) << SP
        spel_bottom = spel_top - inter.SUBPEL_SHIFTS
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
    subpel_x = scol & inter.SUBPEL_MASK
    subpel_y = srow & inter.SUBPEL_MASK
    x0 += scol >> SP
    y0 += srow >> SP
    dx = (mi_x >> sx) + x
    dy = (mi_y >> sy) + y
    avg_into = dst[dy:dy + h, dx:dx + w] if ref_i else None
    out = inter.convolve_block(ref_plane, crop_w, crop_h, x0, y0,
                               subpel_x, subpel_y, xs, ys, w, h,
                               kernel, bd, avg_into)
    dst[dy:dy + h, dx:dx + w] = out


def _add_inter_residuals(planes, mi_row, mi_col, bsize, bwl, bhl, tx_size_y,
                         lossless, mb_to_right, mb_to_bottom, ss_x, ss_y, bd,
                         coeff_off, eob_maps, coeffs):
    for plane in range(3):
        sx = ss_x if plane else 0
        sy = ss_y if plane else 0
        recon = planes[plane]
        if plane:
            tx_size = int(M.UV_TXSIZE_LOOKUP[bsize][tx_size_y][sx][sy])
        else:
            tx_size = tx_size_y
        n4_w = (1 << bwl) >> sx
        n4_h = (1 << bhl) >> sy
        step = 1 << tx_size
        max_bw = n4_w + (mb_to_right >> (5 + sx) if mb_to_right < 0 else 0)
        max_bh = n4_h + (mb_to_bottom >> (5 + sy) if mb_to_bottom < 0 else 0)
        bx4 = (mi_col * 2) >> sx
        by4 = (mi_row * 2) >> sy
        bs = 4 << tx_size
        for row in range(0, max_bh, step):
            for col in range(0, max_bw, step):
                eob = int(eob_maps[plane][by4 + row, bx4 + col])
                if eob > 0:
                    off = int(coeff_off[plane][by4 + row, bx4 + col])
                    cv = coeffs[plane][off:off + bs * bs]
                    res = _residual(cv, tx_size, C.DCT_DCT, lossless, bd)
                    _add_residual(recon, (by4 + row) * 4, (bx4 + col) * 4,
                                  res, bd)
