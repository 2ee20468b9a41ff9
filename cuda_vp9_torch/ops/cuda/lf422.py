"""Chroma loop filter of 4:2:2 and 4:4:0 frames: the CUDA kernel and its
plain torch twin.

`lf_chroma_tiles` deblocks both chroma planes of such a frame in place:
the [ha >> ss_y, wa >> ss_x] top-left of planes 1 and 2 of an int32
[3, ha, wa] frame, in tiles that hold the chroma of one luma superblock
(`TILES`: 64 rows and 32 columns at 4:2:2, 32 rows and 64 columns at
4:4:0), in the order of `cuda_vp9_tpu/ops/device/lf_wave.py`
`lf_plane_tiles`: tile (r, c) after (r, c-1) and (r-1, c+1), per tile the
vertical windows left to right, then the horizontal ones top to bottom.
The five per-cell maps (vbits, hbits, mb, lm, hv: int16 [ha >> ss_y >> 3,
wa >> ss_x >> 3], `runtime/pack._pack_lf`) come straight from the wire;
the thresholds are scaled by bd - 8 inside.

On a CUDA frame it launches `vp9_lf_plane_tiles` of `csrc/loopfilter.cu`
(one persistent launch, a block a tile row, each tile fetched a step
early; the kernel is templated on the tile shape) or raises; on a CPU
frame it runs `lf_chroma_tiles_plain`, which filters each plane with
`ops/device/lf_wave.lf_plane_tiles`.  `launches` counts the kernel
launches (`format_launches` splits them by chroma format) and
`plain_calls` the calls of the plain version, apart from the counts of
`ops/cuda/loopfilter.py`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..device.lf_wave import lf_plane_tiles
from .loopfilter import workspace

# chroma subsampling (ss_x, ss_y) -> (gx, gy): a tile is gy x gx chroma
# cells of 8x8 pixels
TILES = {(1, 0): (4, 8), (0, 1): (8, 4)}

launches = 0
plain_calls = 0
format_launches = dict.fromkeys(TILES, 0)


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    for ss in format_launches:
        format_launches[ss] = 0


def _check(F, maps, ss):
    if tuple(ss) not in TILES:
        raise ValueError(f"no chroma tile filter for subsampling {ss}")
    if F.dtype != torch.int32 or F.dim() != 3 or F.shape[0] != 3 \
            or not F.is_contiguous() or F.shape[1] % 64 or F.shape[2] % 64:
        raise ValueError("F must be a contiguous int32 [3, ha, wa] tensor, "
                         "ha and wa multiples of 64")
    _, ha, wa = F.shape
    shape = (ha >> ss[1] >> 3, wa >> ss[0] >> 3)
    for m in maps:
        if m.dtype != torch.int16 or tuple(m.shape) != shape \
                or not m.is_contiguous() or m.device != F.device:
            raise ValueError(f"each map must be a contiguous int16 "
                             f"[{shape[0]}, {shape[1]}] tensor on F's device")


def lf_chroma_tiles_plain(F, vbits, hbits, mb, lm, hv, lf_on: int, *,
                          bd: int, ss):
    """Both chroma planes through lf_plane_tiles, written back in place.
    Returns F."""
    maps = (vbits, hbits, mb, lm, hv)
    _check(F, maps, ss)
    global plain_calls
    plain_calls += 1
    if lf_on:
        hc, wc = F.shape[1] >> ss[1], F.shape[2] >> ss[0]
        gx, gy = TILES[tuple(ss)]
        # U and V share the maps: one stacked call
        F[1:, :hc, :wc] = lf_plane_tiles(
            F[1:, :hc, :wc], *(m.to(torch.int32) for m in maps), 1, gx=gx,
            gy=gy, bd=bd)
    return F


def _lib():
    """The bound C entry point; builds csrc/loopfilter.cu at first use."""
    fn = _build.load("loopfilter").vp9_lf_plane_tiles
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return fn


def lf_chroma_tiles(F, vbits, hbits, mb, lm, hv, lf_on: int, *, bd: int,
                    ss):
    """Deblock the chroma planes of a 4:2:2 (ss (1, 0)) or 4:4:0 (ss
    (0, 1)) frame F [3, ha, wa] int32 in place; returns F.  lf_on is a host
    int (0 skips all work).  CUDA tensors go to the kernel, CPU tensors to
    lf_chroma_tiles_plain."""
    if F.device.type == "cpu":
        return lf_chroma_tiles_plain(F, vbits, hbits, mb, lm, hv, lf_on,
                                     bd=bd, ss=ss)
    if F.device.type != "cuda":
        raise ValueError(f"lf_chroma_tiles: unsupported device {F.device}")
    ss = tuple(ss)
    _check(F, (vbits, hbits, mb, lm, hv), ss)
    if not lf_on:
        return F
    global launches
    ws = workspace(F)
    n = _build.call(
        _lib(), F.device, F.data_ptr(), vbits.data_ptr(), hbits.data_ptr(),
        mb.data_ptr(), lm.data_ptr(), hv.data_ptr(), ws.data_ptr(),
        F.shape[1], F.shape[2], bd, *ss)
    launches += n
    format_launches[ss] += n
    return F
