"""Residual transforms (K2): the CUDA kernel and its plain torch twins.

`residual_frame` inverse-transforms a frame's coefficient buckets into
the residual frame buffer (`runtime/fused.frame_buffer`: int32 [P*ha*wa
+ 1]): the counterpart of `cuda_vp9_tpu/runtime/fused.py`
`_residual_pass` (:44) with the step's expansion of a scan-prefix bucket
(:540-580) and of the 32x32 coo buckets tx3c and tx3cs, whose units ship
(raster index, value) pairs (:582-602).  Each `Bucket` takes A streams'
records at once, the batched step's stream axis: stream k's units land
in planes 3k + cpos[0]; the single-frame step passes A = 1.

Records are the wire's int16 segments, which a `Bucket` names by their
offsets in each stream's flat (src [A, L]): coefficients [n, ncoef]
(above 8 bits a second [n, ncoef] of high words, v = (hi << 15) + lo),
cpos [n, 4] = (plane, y + 1, x, tx_type), y + 1 == 0 marking a padded
record.  On a CUDA tensor `residual_frame` is one call into
`vp9_residual_frame` of `csrc/residual.cu` with a table of the buckets
built from those offsets in host ints, which makes one launch for all of
them, or raises; on a CPU tensor it runs `residual_frame_plain`, the
plain twins `residual_bucket_plain` and `residual_coo_plain` bucket by
bucket over views of src (`ops/transforms.py` over torch expansions).

`launches` counts the kernel launches (one per frame or round),
`buckets` the buckets those launches ran and `plain_calls` the calls of
a plain twin (one per bucket).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .. import transforms as T
from ... import models as M
from ..device.blocks import put_blocks

I32 = torch.int32

launches = 0
buckets = 0
plain_calls = 0

_scans = {}

# words of one bucket descriptor of vp9_residual_frame (csrc/residual.cu
# kDescWords; a call takes at most kMaxBuckets = 16 buckets, a frame has
# at most 14)
DESC_WORDS = 12


class Bucket(NamedTuple):
    """One coefficient bucket of A streams, as segments of each stream's
    row of an int16 source [A, L] (the wire's flats): element offsets of
    coef [n, ncoef] (the first ncoef coefficients in scan order, raster
    order when ncoef == (4 << tx)^2; kind 2: interleaved (raster index,
    value) pairs, (0, 0) a padding pair), of coefh (the high words above
    8 bits, of coef's shape) or None, and of pos (cpos [n, 4]); n units a
    stream; tx 0..3; kind 0 (DCT/ADST), 1 (the lossless WHT, tx 0) or 2
    (coo pairs, tx 3, 8 bits)."""
    coef: int
    coefh: int | None
    pos: int
    n: int
    ncoef: int
    tx: int
    kind: int


def reset_counts():
    global launches, buckets, plain_calls
    launches = 0
    buckets = 0
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


def bucket_views(src, b: Bucket):
    """(coef, coefh or None, pos): bucket b's int16 views [A, n, ...] of
    the source src [A, L]."""
    A = src.shape[0]

    def view(off, k):
        return src[:, off:off + b.n * k].view(A, b.n, k)

    return (view(b.coef, b.ncoef),
            None if b.coefh is None else view(b.coefh, b.ncoef),
            view(b.pos, 4))


def residual_frame_plain(Rbuf, src, bucket_set, ha: int, wa: int,
                         bd: int = 8):
    """The buckets in order, each through its plain twin."""
    for b in bucket_set:
        coef, coefh, pos = bucket_views(src, b)
        if b.kind == 2:
            residual_coo_plain(Rbuf, coef, pos, ha, wa)
        else:
            residual_bucket_plain(Rbuf, coef, coefh, pos, b.tx, ha, wa, bd,
                                  b.kind == 1)


# ----------------------------------------------------------------- kernel


def _lib():
    """The bound C entry point; builds csrc/residual.cu at first use."""
    fn = _build.load("residual").vp9_residual_frame
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [vp, vp, i, i, i, i, i, vp, ctypes.POINTER(i)]
    return fn


def bucket_table(Rbuf, src, bucket_set, ha: int, wa: int, bd: int):
    """(table int64 [nb, DESC_WORDS], P, scans): the descriptor of each
    bucket with units, in order, with its first block (a block serves
    128 / n units, so the blocks of the buckets follow each other from
    0), and the scan tables it points at (kept alive by the caller).
    Checks Rbuf (int32 [P*ha*wa + 1], contiguous), src (int16 [A, L],
    each row contiguous, on Rbuf's device) and that every segment lies
    in a row; host ints only, no tensor per bucket."""
    if Rbuf.dtype != torch.int32 or Rbuf.dim() != 1 \
            or not Rbuf.is_contiguous() or (Rbuf.numel() - 1) % (ha * wa):
        raise ValueError("Rbuf must be a contiguous int32 frame buffer")
    if src.dtype != torch.int16 or src.dim() != 2 or src.stride(1) != 1 \
            or src.device != Rbuf.device:
        raise ValueError("src must be int16 [A, L] on Rbuf's device, each "
                         "row contiguous")
    A, L = src.shape
    base, stride = src.data_ptr(), src.stride(0)
    rows, scans, first = [], [], 0
    for b in bucket_set:
        if b.kind not in (0, 1, 2) or not 0 <= b.tx <= 3 \
                or (b.kind == 1 and b.tx != 0) \
                or (b.kind == 2 and (b.tx != 3 or bd != 8)):
            raise ValueError(f"no residual bucket of tx {b.tx}, kind "
                             f"{b.kind} at bd {bd}")
        if (b.coefh is None) != (bd == 8):
            raise ValueError("coefh is the high words above 8 bits, and "
                             "only there")
        segs = [(b.coef, b.ncoef), (b.pos, 4)] + (
            [] if b.coefh is None else [(b.coefh, b.ncoef)])
        if any(off < 0 or off + b.n * k > L for off, k in segs) \
                or b.n < 0 or b.ncoef <= 0:
            raise ValueError("a bucket's segments must lie in src's rows")
        if not b.n or not A:
            continue
        scan = None
        if b.kind != 2 and b.ncoef < (4 << b.tx) ** 2:
            scan = scan_table(b.tx, b.ncoef, Rbuf.device, torch.int16)
            scans.append(scan)
        rows.append([base + 2 * b.coef,
                     0 if b.coefh is None else base + 2 * b.coefh,
                     base + 2 * b.pos, 0 if scan is None else scan.data_ptr(),
                     stride, stride, b.n, A, b.tx, b.kind, b.ncoef, first])
        first += -(-b.n * A // (128 // (4 << b.tx)))
    P = (Rbuf.numel() - 1) // (ha * wa)
    return np.asarray(rows, np.int64).reshape(-1, DESC_WORDS), P, scans


def residual_frame(Rbuf, src, bucket_set, ha: int, wa: int, bd: int = 8):
    """Inverse-transform bucket_set (a list of `Bucket`: a frame's, or a
    batched round's, segments of src int16 [A, L]) into the residual
    frame buffer Rbuf [P*ha*wa + 1] int32, stream k's units in planes 3k
    + cpos[0].  CUDA tensors go to the kernel (one host call and one
    launch for every bucket), CPU tensors to residual_frame_plain."""
    global launches, buckets
    if Rbuf.device.type == "cpu":
        return residual_frame_plain(Rbuf, src, bucket_set, ha, wa, bd)
    if Rbuf.device.type != "cuda":
        raise ValueError(f"residual_frame: unsupported device {Rbuf.device}")
    table, P, _scans = bucket_table(Rbuf, src, bucket_set, ha, wa, bd)
    if not len(table):
        return
    launches += _build.call(_lib(), Rbuf.device, Rbuf.data_ptr(),
                            table.ctypes.data, len(table), P, ha, wa, bd)
    buckets += len(table)
