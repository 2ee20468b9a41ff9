"""Host-side loop-filter metadata: per-cell filter levels and edge masks.

Vectorized numpy port of the mask construction in
vp9_filter_block_plane_non420 (vp9/common/vp9_loopfilter.c:1080) — the
device loop filter consumes these dense mask planes directly, so the whole
deblocking pass runs as one jitted computation.

Outputs per plane set:
  y:  lfl [R, C]  level per 8x8 cell
      vert (m16, m8, m4, m4i) and horz (h16, h8, h4, h4i): bool [R, C]
  uv: same at [R2, C2] (R2 = ceil(R/2)) for each of U/V (identical masks,
      one copy).

`pack_lfm_fields` and `pack_lf_thresholds` pack these for the loop-filter
kernel (ops/cuda/loopfilter.py): the wire layout of the JAX package's
`ops/pallas/loopfilter.py`, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from ..decoder import constants as C
from ..ops.ref.loopfilter import MODE_LF_LUT, build_lvl_table


def build_lf_metadata(mi, seg_map, hdr):
    lf = hdr.lf
    R, Cc = hdr.mi_rows, hdr.mi_cols
    lvl_tab = build_lvl_table(lf.filter_level, lf, hdr.seg)

    sb_type = mi.sb_type.astype(np.int32)
    skip = mi.skip.astype(bool)
    ref0 = mi.ref[:, :, 0].astype(np.int32)
    is_inter = ref0 > C.INTRA_FRAME
    tx_y = mi.tx_size.astype(np.int32)
    seg_id = mi.segment_id.astype(np.int32)
    mode_lf = np.asarray(MODE_LF_LUT, np.int32)[mi.mode.astype(np.int32)]

    lvl = lvl_tab[seg_id, np.maximum(ref0, 0), mode_lf].astype(np.int32)

    n4w = M.NUM_4X4_W[sb_type]
    n4h = M.NUM_4X4_H[sb_type]
    n8w = M.NUM_8X8_W[sb_type]
    n8h = M.NUM_8X8_H[sb_type]
    skip_this = skip & is_inter

    cgrid = np.arange(Cc)[None, :] & 7          # c within SB
    rgrid = np.arange(R)[:, None] & 7
    block_edge_left = np.where(n4w > 1, (cgrid & (n8w - 1)) == 0, True)
    block_edge_above = np.where(n4h > 1, (rgrid & (n8h - 1)) == 0, True)
    skip_c = skip_this & ~block_edge_left
    skip_r = skip_this & ~block_edge_above

    def plane_masks(ssx, ssy=None, luma=None):
        """Cell masks for one plane at (ssx, ssy) subsampling (cells on
        the plane's own 8x8 grid; asymmetric ss covers 4:2:2)."""
        if ssy is None:
            ssy = ssx          # legacy symmetric call
        if luma is None:
            luma = not (ssx or ssy)
        if ssx or ssy or not luma:
            sl = np.s_[::1 << ssy, ::1 << ssx]
            tx = M.UV_TXSIZE_LOOKUP[sb_type[sl], tx_y[sl], ssx, ssy]
            sc = skip_c[sl]
            sr = skip_r[sl]
            st = skip_this[sl]
            lv = lvl[sl]
            rows = np.arange(0, R, 1 << ssy)
            cols = np.arange(0, Cc, 1 << ssx)
            cpos = (cols[None, :] & 7) >> ssx   # c within SB, plane units
            rpos = (rows[:, None] & 7) >> ssy
            last_col = (cols[None, :] == (Cc - 1)) if ssx \
                else np.zeros((1, len(cols)), bool)
            last_row = (rows[:, None] == (R - 1)) if ssy \
                else np.zeros((len(rows), 1), bool)
        else:
            tx = tx_y
            sc, sr, st, lv = skip_c, skip_r, skip_this, lvl
            cpos = cgrid
            rpos = rgrid
            last_col = np.zeros_like(sc)
            last_row = np.zeros_like(sc)
        nz = lv > 0
        m16 = np.zeros_like(nz)
        m8 = np.zeros_like(nz)
        m4 = np.zeros_like(nz)
        m4i = np.zeros_like(nz)
        h16 = np.zeros_like(nz)
        h8 = np.zeros_like(nz)
        h4 = np.zeros_like(nz)
        # vertical
        c32 = (tx == 3) & ~sc & ((cpos & 3) == 0)
        m16 |= c32 & ~last_col
        m8 |= c32 & last_col
        c16 = (tx == 2) & ~sc & ((cpos & 1) == 0)
        m16 |= c16 & ~last_col
        m8 |= c16 & last_col
        low = tx <= 1
        c8 = low & ~sc & ((tx == 1) | ((cpos & 3) == 0))
        m8 |= c8
        m4 |= low & ~sc & ~((tx == 1) | ((cpos & 3) == 0))
        m4i |= low & (tx < 1) & ~st & ~last_col
        # horizontal
        r32 = (tx == 3) & ~sr & ((rpos & 3) == 0)
        h16 |= r32 & ~last_row
        h8 |= r32 & last_row
        r16 = (tx == 2) & ~sr & ((rpos & 1) == 0)
        h16 |= r16 & ~last_row
        h8 |= r16 & last_row
        r8 = low & ~sr & ((tx == 1) | ((rpos & 3) == 0))
        h8 |= r8
        h4 |= low & ~sr & ~((tx == 1) | ((rpos & 3) == 0))
        h4i = m4i & ~last_row   # skip_border_4x4_r kills interior horz
        for m in (m16, m8, m4, m4i, h16, h8, h4, h4i):
            m &= nz
        # frame edges
        m16[:, 0] = m8[:, 0] = m4[:, 0] = False
        h16[0, :] = h8[0, :] = h4[0, :] = False
        return lv, (m16, m8, m4, m4i), (h16, h8, h4, h4i)

    y = plane_masks(0, 0, luma=True)
    uv = plane_masks(hdr.subsampling_x, hdr.subsampling_y, luma=False)
    return y, uv


K = 4          # superblock rows per lfm row group (pads the lfm row count)


def cdiv(a, b):
    return (a + b - 1) // b


def pack_lfm_fields(lvl_y, masks_vy, masks_hy, lvl_uv, masks_vuv, masks_huv,
                    mi_rows, mi_cols):
    """Per-cell LF metadata -> [n_sbs_pad, 2, 128] int16.

    One int16 per cell per direction, bits | level << 4 (bits = m16 | m8<<1
    | m4<<2 | m4i<<3).  Row = direction d, lanes = plane*64 + chain*8 +
    cell; v-dir grids are stored per SB transposed ([chain=cellcol,
    along=cellrow]), h-dir as [chain=cellrow, along=cellcol]."""
    sb_rows, sb_cols = cdiv(mi_rows, 8), cdiv(mi_cols, 8)
    g_rows = cdiv(sb_rows, K) * K
    n_sbs = g_rows * sb_cols
    out = np.zeros((n_sbs, 2, 128), np.int16)

    def sb_grids(cells, g):
        """[R, C] cell grid -> [n_sbs, 8, 8] per-SB grids (zero padded)."""
        R, C = cells.shape
        full = np.zeros((g_rows * g, sb_cols * g), cells.dtype)
        full[:R, :C] = cells
        return (full.reshape(g_rows, g, sb_cols, g)
                .transpose(0, 2, 1, 3).reshape(n_sbs, g, g))

    for p, (lvl, mv, mh, g) in enumerate((
            (lvl_y, masks_vy, masks_hy, 8),
            (lvl_uv, masks_vuv, masks_huv, 4))):
        bits = {0: sum((m.astype(np.int16) << k) for k, m in enumerate(mv)),
                1: sum((m.astype(np.int16) << k) for k, m in enumerate(mh))}
        lv = np.clip(lvl, 0, 63).astype(np.int16)
        for d in range(2):
            b = bits[d]
            lvb = np.broadcast_to(lv, b.shape) if lv.shape != b.shape \
                else lv
            cells = np.where(b != 0, b | (lvb << 4), 0).astype(np.int16)
            grids = sb_grids(cells, g)            # [n, g, g]
            if d == 0:                            # v: chain = cellcol
                grids = grids.transpose(0, 2, 1)
            n = grids.shape[0]
            tmp = np.zeros((n, 8, 8), np.int16)
            tmp[:, :g, :g] = grids
            out[:, d, p * 64:p * 64 + 64] = tmp.reshape(n, 64)
    return out


def pack_lf_thresholds(thr):
    """(mblim, lim, hev) 64-entry level tables -> [64, 4] int16 (column
    f = 1, 2, 3; column 0 unused)."""
    mb_t, lm_t, hv_t = thr
    out = np.zeros((64, 4), np.int16)
    out[:, 1] = mb_t
    out[:, 2] = lm_t
    out[:, 3] = hv_t
    return out
