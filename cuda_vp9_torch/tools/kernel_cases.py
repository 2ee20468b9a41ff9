"""Seeded inputs that drive the intra and residual kernels down every
path, for holding each kernel against its plain twin bit for bit
(`chip_smoke.py`, the `cuda`-marked tests).  numpy only; each case is
host arrays that the caller moves to the device it tests.

Intra (`intra_frame`, `intra_streams`): random frames and residuals with
units of every block size 4..32 on a block grid, one chunk list per
plane in wave order (wave 2y + x, so no unit reads a pixel another unit
of its chunk writes, as the packer guarantees), all 10 modes, random
availability (n_above < 2 bs and n_left < bs replicate the last valid
pixel; have_up and have_left drawn apart from them), the three tl_modes,
units on the canvas' right and bottom edges and straddling them, and
padded records (chunks are zero-filled to ich records).

Residual (`residual_bucket_case`, `residual_coo_case`): random units of
one bucket at distinct block positions of A streams' planes, random
tx_types, some padded records (cpos all zero), coefficients sparse and
moderate or extreme (the full int16 range at 8 bits; up to the bd +
8-bit WRAPLOW range above, and raw random high and low words), and for
the coo buckets (index, value) pairs with (0, 0) padding pairs.
"""

from __future__ import annotations

import numpy as np


def _record(x0, y0, plane, mode, n_above, n_left, tl_mode, have_up,
            have_left):
    """The 4 int16 words of one intra record (fused.py:433-446)."""
    w = [(x0 >> 2) | plane << 14, ((y0 >> 2) + 1) | have_up << 15,
         mode | n_above << 4 | n_left << 10, tl_mode | have_left << 2]
    return np.asarray(w, np.uint16).astype(np.int16)


def _unit(rng, bs, x0, y0, plane, mode):
    """A record with random availability fields."""
    have_up = int(rng.integers(0, 2))
    have_left = int(rng.integers(0, 2))
    n_above = int(rng.integers(0, min(2 * bs, 63) + 1))
    n_left = int(rng.integers(0, bs + 1))
    return _record(x0, y0, plane, mode, n_above, n_left,
                   int(rng.integers(0, 3)), have_up, have_left)


def _plane_chunks(rng, plane, code, ha, wa, ich):
    """One plane's chunk list: the block grid of size 4 << code in wave
    order, at most ich units a chunk, then (bs >= 8) one chunk of units
    straddling the right and the bottom edges."""
    bs = 4 << code
    rows, cols = ha // bs, wa // bs
    chunks = []
    mode = int(rng.integers(0, 10))
    for w in range(cols + 2 * (rows - 1)):
        units = []
        for y in range(rows):
            x = w - 2 * y
            if 0 <= x < cols:
                units.append(_unit(rng, bs, x * bs, y * bs, plane,
                                   mode % 10))
                mode += 1
        for i in range(0, len(units), ich):
            chunks.append(units[i:i + ich])
    if bs >= 8:
        half = bs // 2
        chunks.append([_unit(rng, bs, wa - half, 0, plane, 9),
                       _unit(rng, bs, 0, ha - half, plane, 3)])
    return [(code, c) for c in chunks]


def intra_chunks(rng, codes, ha, wa, ich):
    """(records int16 [n, ich, 4], chunk_bs int16 [n]): plane p's grid of
    block size code codes[p], the planes' chunk lists interleaved (each
    in its own wave order)."""
    lists = [_plane_chunks(rng, p, c, ha, wa, ich)
             for p, c in enumerate(codes)]
    order = []
    while any(lists):
        for lst in lists:
            if lst:
                order.append(lst.pop(0))
    rec = np.zeros((len(order), ich, 4), np.int16)
    for i, (_, units) in enumerate(order):
        rec[i, :len(units)] = units
    return rec, np.asarray([c for c, _ in order], np.int16)


def intra_frame(rng, ha, wa, bd, ich, codes=(0, 1, 2), planes=3):
    """(F [planes, ha, wa], R [planes, ha, wa], records, chunk_bs): random
    pixels and residuals, and the chunks of intra_chunks."""
    F = rng.integers(0, 1 << bd, (planes, ha, wa)).astype(np.int32)
    R = rng.integers(1 - (1 << bd), 1 << bd, (planes, ha, wa)).astype(
        np.int32)
    rec, cbs = intra_chunks(rng, codes, ha, wa, ich)
    return F, R, rec, cbs


def intra_streams(rng, n, ha, wa, bd, ich, cap=None):
    """A streams' frames for the batched form: (F [3n, ha, wa], R, flats
    int16 [n, nflat], (off_misc, off_cbs, off_rec, cap)).  Each stream's
    flat holds its chunk count at misc[3], its chunk_bs and its records
    [cap, ich, 4], zero past its count; the streams' block sizes differ
    (stream k plane p: code (k + p) % 4), so chunk index i mixes sizes."""
    F, R, lists = [], [], []
    for k in range(n):
        f, r, rec, cbs = intra_frame(rng, ha, wa, bd, ich,
                                     codes=[(k + p) % 4 for p in range(3)])
        F.append(f)
        R.append(r)
        lists.append((rec, cbs))
    cap = cap or max(len(c) for _, c in lists)
    off_misc, off_cbs = 0, 48
    off_rec = off_cbs + cap
    nflat = off_rec + cap * ich * 4 + 256
    flats = np.zeros((n, nflat), np.int16)
    for k, (rec, cbs) in enumerate(lists):
        flats[k, off_misc + 3] = len(cbs)
        flats[k, off_cbs:off_cbs + len(cbs)] = cbs
        flats[k, off_rec:off_rec + rec.size] = rec.reshape(-1)
    return (np.concatenate(F), np.concatenate(R), flats,
            (off_misc, off_cbs, off_rec, cap))


def _positions(rng, n_units, n, planes, ha, wa):
    """cpos int16 [n_units, 4] = (plane, y + 1, x, tx_type) at distinct
    n x n block positions of `planes` planes, about 1 in 8 and the last
    one padded (all zero)."""
    slots = planes * (ha // n) * (wa // n)
    if n_units > slots:
        raise ValueError("more units than block positions")
    pick = rng.choice(slots, n_units, replace=False)
    p, rest = np.divmod(pick, (ha // n) * (wa // n))
    y, x = np.divmod(rest, wa // n)
    pos = np.stack([p, y * n + 1, x * n, rng.integers(0, 4, n_units)], 1)
    pos[rng.random(n_units) < 0.125] = 0
    pos[-1] = 0
    return pos.astype(np.int16)


def _values(rng, shape, bd, extreme):
    """int64 coefficients: sparse and moderate, or dense and extreme."""
    if extreme:
        lim = 1 << (15 if bd == 8 else bd + 7)
        return rng.integers(-lim, lim, shape)
    c = rng.integers(-(1 << (bd + 2)), (1 << (bd + 2)) + 1, shape)
    return c * (rng.random(shape) < 0.3)


def residual_bucket_case(rng, A, n_units, tx, ncoef, bd, ha, wa,
                         extreme=False):
    """(coef, coefh or None, pos): int16 [A, n_units, ncoef] coefficient
    words (the first ncoef in scan order), their high words above 8 bits
    (v = (hi << 15) + lo; for extreme inputs a quarter of the units carry
    raw random words), and cpos int16 [A, n_units, 4] (stream k's planes
    are its own 0..2)."""
    n = 4 << tx
    v = _values(rng, (A, n_units, ncoef), bd, extreme)
    pos = np.stack([_positions(rng, n_units, n, 3, ha, wa)
                    for _ in range(A)])
    if bd == 8:
        return v.astype(np.int16), None, pos
    hi = (v >> 15).astype(np.int16)
    lo = (v & 0x7FFF).astype(np.int16)
    if extreme:
        raw = rng.random((A, n_units)) < 0.25
        hi[raw] = rng.integers(-32768, 32768, hi[raw].shape)
        lo[raw] = rng.integers(-32768, 32768, lo[raw].shape)
    return lo, hi, pos


def residual_coo_case(rng, A, n_units, npairs, ha, wa, extreme=False):
    """(pairs, pos): int16 [A, n_units, 2 npairs] interleaved (raster
    index, value) pairs of 32x32 units, distinct indices per unit, some
    (0, 0) padding pairs (a DC pair (0, v != 0) is real), and cpos int16
    [A, n_units, 4]."""
    pairs = np.zeros((A, n_units, 2 * npairs), np.int64)
    for k in range(A):
        for u in range(n_units):
            m = int(rng.integers(0, npairs + 1))
            idx = rng.choice(1024, m, replace=False)
            val = _values(rng, m, 8, extreme)
            val[val == 0] = 1
            pairs[k, u, 0:2 * m:2] = idx
            pairs[k, u, 1:2 * m:2] = val
    pos = np.stack([_positions(rng, n_units, 32, 3, ha, wa)
                    for _ in range(A)])
    return pairs.astype(np.int16), pos
