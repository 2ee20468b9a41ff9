"""NumPy-only copies of the three loop-filter pack names the shared host
packer imports from `cuda_vp9_tpu.ops.pallas.loopfilter`.

`runtime/pack.py` (build_layout, _pack_lf) and `native/__init__.py`
(NativeParser._packin) import `K`, `pack_lfm_fields` and
`pack_lf_thresholds` from the Pallas module, which imports JAX when it
loads.  Those three names are pure NumPy, so on a machine without JAX
`cuda_vp9_torch/__init__.py` registers this module under the Pallas
module's name and the host packer runs unchanged.  Where JAX is installed
nothing is registered and both packages see the real module.

This shim goes away when the ROADMAP refactor moves the three names into
`cuda_vp9_tpu/runtime/lfmeta.py`.  The copies must stay byte-equal with
`ops/pallas/loopfilter.py:46, 81-130` (tests/test_torch_loopfilter.py
checks that).
"""

from __future__ import annotations

import numpy as np

K = 4          # superblock rows per lfm row group (pads the lfm row count)


def cdiv(a, b):
    return (a + b - 1) // b


def pack_lfm_fields(lvl_y, masks_vy, masks_hy, lvl_uv, masks_vuv, masks_huv,
                    mi_rows, mi_cols):
    """Host packer: per-cell LF metadata -> [n_sbs_pad, 2, 128] int16.

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
