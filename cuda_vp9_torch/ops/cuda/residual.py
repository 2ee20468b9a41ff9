"""Residual transforms (K2): the CUDA kernel and its plain torch twin.

`residual_bucket` inverse-transforms one coefficient bucket into the
residual frame buffer (`runtime/fused.frame_buffer`: int32 [P*ha*wa + 1]):
the counterpart of `cuda_vp9_tpu/runtime/fused.py` `_residual_pass`
(:44) with the step's expansion of a scan-prefix bucket (:540-580).
`residual_coo` does the same for the 32x32 coo buckets tx3c and tx3cs,
whose units ship (raster index, value) pairs (:582-602).  Both take A
streams' records at once, the batched step's stream axis: stream k's
units land in planes 3k + cpos[0]; the single-frame step passes A = 1.

Records are the wire's int16 segments: coefficients [A, n, ncoef] (above
8 bits a second [A, n, ncoef] of high words, v = (hi << 15) + lo), cpos
[A, n, 4] = (plane, y + 1, x, tx_type), y + 1 == 0 marking a padded
record.  On a CUDA tensor each call is one launch of `vp9_residual` of
`csrc/residual.cu`, or raises; on a CPU tensor it runs the plain twin,
`ops/transforms.py` over torch expansions.

`launches` counts the kernel launches and `plain_calls` the calls of a
plain twin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .. import transforms as T
from ... import models as M
from ..device.blocks import put_blocks

I32 = torch.int32

launches = 0
plain_calls = 0

_scans = {}


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def scan_table(tx: int, ncoef: int, device, dtype=torch.int64):
    """[4, ncoef] first-ncoef raster positions of each tx_type's scan,
    built from models.SCAN_ORDERS and uploaded once per (tx, ncoef,
    device, dtype)."""
    key = (tx, ncoef, str(device), dtype)
    t = _scans.get(key)
    if t is None:
        t = _scans[key] = torch.as_tensor(np.stack(
            [np.asarray(M.SCAN_ORDERS[tx][k].scan[:ncoef], np.int64)
             for k in range(4)]), device=device).to(dtype)
    return t


# ----------------------------------------------------------------- plain


def residual_units(Rbuf, coeffs, pos, tx: int, ha: int, wa: int,
                   bd: int = 8, lossless: bool = False):
    """Inverse-transform N units and write them into the residual frame.

    coeffs [N, n*n] raster order, int16 at bd 8 and int32 above; pos
    [N, 4] int32 = (plane, y + 1, x, tx_type), y + 1 == 0 marking a padded
    record (fused.py:44-63).  Lossless units (tx 0) take the WHT."""
    if lossless:
        resid = T.inv_wht2d(coeffs, bd)
    elif tx == 3:
        resid = T.inv_txfm2d(coeffs, 3, 0, bd)
    else:
        resid = T.inv_txfm2d_select(coeffs, tx, pos[:, 3] & 3, bd)
    put_blocks(Rbuf, pos[:, 0], pos[:, 1] - 1, pos[:, 2], pos[:, 1] != 0,
               resid, ha, wa)


def expand_prefix(cm, tt, scan, n2: int):
    """First-ncoef scan coefficients [N, ncoef] -> raster [N, n2]."""
    full = torch.zeros(cm.shape[0], n2, dtype=cm.dtype, device=cm.device)
    return full.scatter_(1, scan[(tt & 3).long()], cm)


def expand_pairs(cm):
    """Interleaved (raster_idx, value) int16 pairs [N, 2P] -> raster
    [N, 1024].  Pad pairs are (0, 0); they go to index 1024, which is
    dropped (fused.py:593-599)."""
    idx = cm[:, 0::2].long()
    val = cm[:, 1::2]
    idx = torch.where((idx == 0) & (val == 0), 1024, idx.clamp(0, 1024))
    full = torch.zeros(cm.shape[0], 1025, dtype=cm.dtype, device=cm.device)
    return full.scatter_(1, idx, val)[:, :1024]


def _stream_pos(pos):
    """cpos [A, n, 4] -> int32 [A*n, 4] with stream k's planes offset by
    3k."""
    p = pos.to(I32, copy=True)
    p[:, :, 0] += 3 * torch.arange(p.shape[0], device=p.device,
                                   dtype=I32)[:, None]
    return p.reshape(-1, 4)


def residual_bucket_plain(Rbuf, coef, coefh, pos, tx: int, ha: int,
                          wa: int, bd: int = 8, lossless: bool = False):
    """One bucket through the torch transforms (see residual_bucket)."""
    global plain_calls
    plain_calls += 1
    A, n, ncoef = coef.shape
    if coefh is None:
        cm = coef
    else:
        # hi/lo words: v = (hi << 15) + lo (fused.py:557-561)
        cm = (coefh.to(I32) << 15) + coef.to(I32)
    cm = cm.reshape(A * n, ncoef)
    p = _stream_pos(pos)
    n2 = (4 << tx) ** 2
    if ncoef < n2:
        cm = expand_prefix(cm, p[:, 3], scan_table(tx, ncoef, cm.device), n2)
    residual_units(Rbuf, cm, p, tx, ha, wa, bd, lossless)


def residual_coo_plain(Rbuf, pairs, pos, ha: int, wa: int):
    """One coo bucket through the torch transforms (see residual_coo)."""
    global plain_calls
    plain_calls += 1
    A, n, npair2 = pairs.shape
    residual_units(Rbuf, expand_pairs(pairs.reshape(A * n, npair2)),
                   _stream_pos(pos), 3, ha, wa)


# ----------------------------------------------------------------- kernel


def _check(Rbuf, coef, coefh, pos, ha, wa, bd):
    """Rbuf int32 [P*ha*wa + 1] contiguous; coef (and coefh, with coef's
    strides) int16 [A, n, ncoef], pos int16 [A, n, 4], each stream's rows
    contiguous; coefh present exactly above 8 bits.  Returns P."""
    if Rbuf.dtype != torch.int32 or Rbuf.dim() != 1 \
            or not Rbuf.is_contiguous() or (Rbuf.numel() - 1) % (ha * wa):
        raise ValueError("Rbuf must be a contiguous int32 frame buffer")
    if (coefh is None) != (bd == 8):
        raise ValueError("coefh is the high words above 8 bits, and only "
                         "there")
    arrs = [coef, pos] + ([] if coefh is None else [coefh])
    A, n = coef.shape[:2]
    for a in arrs:
        if a.dtype != torch.int16 or a.dim() != 3 or a.shape[:2] != (A, n) \
                or a.stride()[1:] != (a.shape[2], 1) \
                or a.device != Rbuf.device:
            raise ValueError("coefficients and cpos must be int16 [A, n, k] "
                             "on Rbuf's device, each stream's rows "
                             "contiguous")
    if pos.shape[2] != 4 or (coefh is not None and (
            coefh.shape != coef.shape or coefh.stride() != coef.stride())):
        raise ValueError("cpos must be [A, n, 4], coefh of coef's shape and "
                         "strides")
    return (Rbuf.numel() - 1) // (ha * wa)


def _lib():
    """The bound C entry point; builds csrc/residual.cu at first use."""
    fn = _build.load("residual").vp9_residual
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        ll = ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, ll, ll, i, i, i, i, vp, i, i, i, i, i,
                       vp, ctypes.POINTER(i)]
    return fn


def _launch(Rbuf, coef, coefh, pos, tx, scan, kind, ha, wa, bd):
    global launches
    P = _check(Rbuf, coef, coefh, pos, ha, wa, bd)
    A, n, ncoef = coef.shape
    if not n:
        return
    launches += _build.call(
        _lib(), Rbuf.device, Rbuf.data_ptr(), coef.data_ptr(),
        None if coefh is None else coefh.data_ptr(), pos.data_ptr(),
        coef.stride(0), pos.stride(0), n, A, tx, ncoef, None if scan is None else scan.data_ptr(),
        kind, P, ha, wa, bd)


def residual_bucket(Rbuf, coef, coefh, pos, tx: int, ha: int, wa: int,
                    bd: int = 8, lossless: bool = False):
    """Inverse-transform a coefficient bucket of tx size tx (0..3) into
    the residual frame buffer Rbuf [P*ha*wa + 1] int32.  coef: int16
    [A, n, ncoef], the first ncoef coefficients in scan order (raster
    order when ncoef == (4 << tx)^2); coefh: the int16 high words above
    8 bits, else None; pos: int16 cpos [A, n, 4]; lossless: the WHT (tx
    0).  CUDA tensors go to the kernel (one launch), CPU tensors to
    residual_bucket_plain."""
    if Rbuf.device.type == "cpu":
        return residual_bucket_plain(Rbuf, coef, coefh, pos, tx, ha, wa, bd,
                                     lossless)
    if Rbuf.device.type != "cuda":
        raise ValueError(f"residual_bucket: unsupported device {Rbuf.device}")
    if lossless and tx != 0:
        raise ValueError("a lossless frame has bucket tx0 only")
    ncoef = coef.shape[-1]
    scan = (scan_table(tx, ncoef, Rbuf.device, torch.int16)
            if ncoef < (4 << tx) ** 2 else None)
    _launch(Rbuf, coef, coefh, pos, tx, scan, 1 if lossless else 0, ha, wa,
            bd)


def residual_coo(Rbuf, pairs, pos, ha: int, wa: int):
    """Inverse-transform a 32x32 coo bucket (8-bit only) into Rbuf: pairs
    int16 [A, n, 2P] interleaved (raster index, value), (0, 0) a padding
    pair; pos int16 cpos [A, n, 4].  CUDA tensors go to the kernel (one
    launch), CPU tensors to residual_coo_plain."""
    if Rbuf.device.type == "cpu":
        return residual_coo_plain(Rbuf, pairs, pos, ha, wa)
    if Rbuf.device.type != "cuda":
        raise ValueError(f"residual_coo: unsupported device {Rbuf.device}")
    _launch(Rbuf, pairs, None, pos, 3, None, 2, ha, wa, 8)
