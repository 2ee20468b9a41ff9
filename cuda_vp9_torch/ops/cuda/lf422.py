"""4:2:2 chroma loop filter: the CUDA kernel and its plain torch twin.

`lf_chroma_422` deblocks both chroma planes of a 4:2:2 frame in place:
the left [ha, wa/2] of planes 1 and 2 of an int32 [3, ha, wa] frame, in
tiles of 64 rows and 32 columns (the chroma of one luma superblock), in
the order of `cuda_vp9_tpu/ops/device/lf_wave.py` `lf_plane_tiles`: tile
(r, c) after (r, c-1) and (r-1, c+1), per tile the vertical windows left
to right, then the horizontal ones top to bottom.  The five per-cell maps
(vbits, hbits, mb, lm, hv: int16 [ha/8, wa/16], `runtime/pack._pack_lf`)
come straight from the wire; the thresholds are scaled by bd - 8 inside.

On a CUDA frame it launches `vp9_lf_plane_tiles` of `csrc/loopfilter.cu`
(one persistent launch, a block a tile row, each tile fetched a step
early) or raises; on a CPU frame it runs `lf_chroma_422_plain`, which filters each
plane with `ops/device/lf_wave.lf_plane_tiles`.  `launches` counts the
kernel launches and `plain_calls` the calls of the plain version, apart
from the counts of `ops/cuda/loopfilter.py`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..device.lf_wave import lf_plane_tiles
from .loopfilter import workspace

GX, GY = 4, 8       # a tile is GY x GX chroma cells of 8x8 pixels

launches = 0
plain_calls = 0


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _check(F, maps):
    if F.dtype != torch.int32 or F.dim() != 3 or F.shape[0] != 3 \
            or not F.is_contiguous() or F.shape[1] % 64 or F.shape[2] % 64:
        raise ValueError("F must be a contiguous int32 [3, ha, wa] tensor, "
                         "ha and wa multiples of 64")
    _, ha, wa = F.shape
    for m in maps:
        if m.dtype != torch.int16 or tuple(m.shape) != (ha // 8, wa // 16) \
                or not m.is_contiguous() or m.device != F.device:
            raise ValueError(f"each map must be a contiguous int16 "
                             f"[{ha // 8}, {wa // 16}] tensor on F's device")


def lf_chroma_422_plain(F, vbits, hbits, mb, lm, hv, lf_on: int, *,
                        bd: int):
    """Each chroma plane through lf_plane_tiles, written back in place.
    Returns F."""
    maps = (vbits, hbits, mb, lm, hv)
    _check(F, maps)
    global plain_calls
    plain_calls += 1
    if lf_on:
        wc = F.shape[2] // 2
        m32 = [m.to(torch.int32) for m in maps]
        for p in (1, 2):
            F[p, :, :wc] = lf_plane_tiles(F[p, :, :wc], *m32, 1, gx=GX,
                                          gy=GY, bd=bd)
    return F


def _lib():
    """The bound C entry point; builds csrc/loopfilter.cu at first use."""
    fn = _build.load("loopfilter").vp9_lf_plane_tiles
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return fn


def lf_chroma_422(F, vbits, hbits, mb, lm, hv, lf_on: int, *, bd: int):
    """Deblock the chroma planes of a 4:2:2 frame F [3, ha, wa] int32 in
    place; returns F.  lf_on is a host int (0 skips all work).  CUDA
    tensors go to the kernel, CPU tensors to lf_chroma_422_plain."""
    if F.device.type == "cpu":
        return lf_chroma_422_plain(F, vbits, hbits, mb, lm, hv, lf_on,
                                   bd=bd)
    if F.device.type != "cuda":
        raise ValueError(f"lf_chroma_422: unsupported device {F.device}")
    _check(F, (vbits, hbits, mb, lm, hv))
    if not lf_on:
        return F
    global launches
    ws = workspace(F)
    launches += _build.call(
        _lib(), F.device, F.data_ptr(), vbits.data_ptr(), hbits.data_ptr(),
        mb.data_ptr(), lm.data_ptr(), hv.data_ptr(), ws.data_ptr(),
        F.shape[1], F.shape[2], bd)
    return F
