"""Sequential-tile loop filter for 4:2:2 and 4:4:0 chroma planes, in
plain torch.

Counterpart of `cuda_vp9_tpu/ops/device/lf_wave.py` (`lf_plane_tiles`,
`_tile_pass_v`, `_tile_pass_h`, `_filter_window`).  VP9 deblocks in LUMA
superblock raster order: all vertical edges of the SB, then its
horizontal edges (`vp9_filter_block_plane_non420`).  In a 4:2:2 chroma
plane each luma SB covers a tile 32 pixels wide and 64 tall (gx, gy = 4,
8 cells), in a 4:4:0 one a tile 64 wide and 32 tall (8, 4), so
neighbouring tiles' V and H filters interleave.  This module replays that
order: one tile at a time, in raster order, each tile's vertical windows
left to right and then its horizontal windows top to bottom.

Each window is the loop filter's edge chain (`_edge_chain` of
`ops/cuda/loopfilter.py`, the same math as the reference's
`_filter_window` followed by its interior `_filter_window4`).  The masks
and thresholds are per-cell maps packed by `runtime/pack._pack_lf`
(bit 0 = 16-wide, 1 = 8-wide, 2 = 4-wide, 3 = interior 4x4).

This is the plain twin of the hand-written kernel (`ops/cuda/lf422.py`,
`vp9_lf_plane_tiles` of `csrc/loopfilter.cu`): tile (r, c) needs only
(r, c-1) and (r-1, c+1), as a superblock of the whole-frame filter does,
so the kernel walks the tiles on that filter's row walker, one
persistent launch per frame.  The frame step runs this version only on
the CPU; the tests hold the kernel against it.  Planes that share the
maps (a frame's U and V) may come stacked, [n, Hp, Wp]: every window then
runs as one chain over the lanes of all n planes.
"""

from __future__ import annotations

import torch

from ..cuda.loopfilter import _edge_chain


def _cells(a, i):
    """Per-cell values [n] -> per-pixel-lane values [8 n]."""
    return a[i].repeat_interleave(8)


def _chain(win, maps, sel, bd):
    """One edge chain on the windows win [n, L, 16] of n planes, in place;
    maps (bits, mb, lm, hv) at the cells `sel` give the L lanes' values."""
    n, lanes = win.shape[:2]
    m = [_cells(a, sel).repeat(n) for a in maps]
    win.copy_(_edge_chain(win.reshape(n * lanes, 16), *m, bd)
              .view(n, lanes, 16))


def _tile_pass_v(tile, bits, mb, lm, hv, gx: int, gy: int, bd: int):
    """The tile's vertical edges, window column i at pixel column 8 i."""
    for i in range(gx):
        win = tile[:, 8:8 + gy * 8, i * 8:i * 8 + 16]     # [n, gy*8, 16]
        _chain(win, (bits, mb, lm, hv), (slice(None), i), bd)


def _tile_pass_h(tile, bits, mb, lm, hv, gx: int, gy: int, bd: int):
    """The tile's horizontal edges, window row j at pixel row 8 j."""
    for j in range(gy):
        win = tile[:, j * 8:j * 8 + 16, 8:8 + gx * 8].transpose(1, 2)
        _chain(win, (bits, mb, lm, hv), (j, slice(None)), bd)


def lf_plane_tiles(P, vbits, hbits, mb, lm, hv, lf_on: int, *,
                   gx: int, gy: int, bd: int):
    """Deblock one plane in (gy*8) x (gx*8)-pixel tile raster order.

    P [Hp, Wp] int32, or [n, Hp, Wp] for n planes that share the maps (Hp,
    Wp multiples of the tile size); vbits, hbits, mb, lm, hv [Hp/8, Wp/8]
    int32 per-cell mask bitfields and threshold values (not yet scaled by
    bit depth; zero cells do nothing).  lf_on is
    a host int.  Returns the filtered plane (a new tensor).  As in the
    reference, the plane sits in a canvas with an 8-pixel zero apron
    above and to the left, and each tile is read with its 8 pixels of
    apron (the previous tiles' pixels)."""
    Hp, Wp = P.shape[-2:]
    th, tw = gy * 8, gx * 8
    Pp = torch.zeros(P.shape[:-2] + (Hp + 8, Wp + 8), dtype=P.dtype,
                     device=P.device)
    Pp[..., 8:, 8:] = P
    tiles = Pp.view(-1, Hp + 8, Wp + 8)
    if lf_on:
        sh = bd - 8
        for r in range(Hp // th):
            for c in range(Wp // tw):
                tile = tiles[:, r * th:r * th + th + 8,
                             c * tw:c * tw + tw + 8]
                cells = (slice(r * gy, (r + 1) * gy),
                         slice(c * gx, (c + 1) * gx))
                thr = [t[cells] << sh for t in (mb, lm, hv)]
                _tile_pass_v(tile, vbits[cells], *thr, gx, gy, bd)
                _tile_pass_h(tile, hbits[cells], *thr, gx, gy, bd)
    return Pp[..., 8:, 8:]
