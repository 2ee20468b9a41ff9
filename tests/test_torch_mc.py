"""The port's motion compensation (cuda_vp9_torch/runtime/fused.py) against
the JAX step's MC (`cuda_vp9_tpu/runtime/fused.py`).

Per tile: `mc_predict` against `_mc_chunk_compute` for the 4, 8, 16 and
32 classes, and `mcs_predict` against `_mcs_chunk_compute` for the
scaled-reference class, on seeded random pools with tiles that reach
past the reference crop on every side (the normative edge clamp).  Per
class: `mc_pass` against `_mc_pass`, first-reference tiles, padded tiles
and compound tiles that average into them.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

import jax

from cuda_vp9_torch.runtime import fused as TF
from cuda_vp9_tpu import models as M
from cuda_vp9_tpu.runtime import fused as JF

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

KERNELS = np.asarray(M.FILTER_KERNELS, np.int32)
PHA, PWA = 64, 96


def _pool(rng):
    return rng.integers(0, 256, (8, 3, PHA, PWA)).astype(np.int32)


def _records(rng, n, w, dxy, cw, chh):
    """n wire records (dx | filt << 13, dy + 1, sr, sc) landing at the
    destinations dxy [n, 2] with sources around the crop."""
    x0 = rng.integers(-12 - w, cw + 12, n)
    y0 = rng.integers(-12 - w, chh + 12, n)
    dx, dy = dxy[:, 0], dxy[:, 1]
    u = np.zeros((n, 4), np.int32)
    u[:, 0] = dx | (rng.integers(0, 4, n) << 13)
    u[:, 1] = dy + 1
    u[:, 2] = ((y0 - dy) << 4) | rng.integers(0, 16, n)
    u[:, 3] = ((x0 - dx) << 4) | rng.integers(0, 16, n)
    return u


def _grid(w, ha, wa):
    """Every w-aligned destination of a [ha, wa] plane, as (dx, dy)."""
    ys, xs = np.meshgrid(np.arange(0, ha, w), np.arange(0, wa, w),
                         indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], 1)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_mc_predict_matches_jax(w):
    rng = np.random.default_rng(400 + w)
    pool = _pool(rng)
    n = 48
    cw, chh = int(rng.integers(PWA - 7, PWA + 1)), \
        int(rng.integers(PHA - 7, PHA + 1))
    dxy = _grid(w, PHA, PWA)[rng.integers(0, (PHA // w) * (PWA // w), n)]
    u = _records(rng, n, w, dxy, cw, chh)
    hd = np.array([5, 1, 0, cw, chh, 0, 0, 0], np.int32)
    fn = jax.jit(lambda p, k, hd, u: JF._mc_chunk_compute(
        p, k, hd, u, w, w, min(160, PHA), 8))
    want = np.asarray(fn(pool, KERNELS, hd, u))
    got = TF.mc_predict(torch.from_numpy(pool), torch.from_numpy(KERNELS),
                        torch.from_numpy(np.tile(hd, (n, 1))),
                        torch.from_numpy(u), w, 8)
    assert np.array_equal(got.numpy(), want)


def test_mcs_predict_matches_jax():
    rng = np.random.default_rng(77)
    pool = _pool(rng)
    n = 96
    cw, chh = int(rng.integers(PWA - 7, PWA + 1)), \
        int(rng.integers(PHA - 7, PHA + 1))
    u = np.zeros((n, 16), np.int32)
    u[:, 2] = 1                                    # dy + 1: a real record
    u[:, 4] = rng.integers(-12, cw + 12, n)        # x0
    u[:, 5] = rng.integers(-12, chh + 12, n)       # y0
    u[:, 6] = rng.integers(0, 16, n)               # phase x
    u[:, 7] = rng.integers(0, 16, n)               # phase y
    u[:, 8] = rng.integers(0, 4, n)                # filter
    u[:, 9], u[:, 10] = cw, chh
    u[:, 12] = rng.integers(8, 33, n)              # x step q4 (<= 2x down)
    u[:, 13] = rng.integers(8, 33, n)              # y step q4
    hd = np.array([2, 0, 0, 0], np.int32)
    fn = jax.jit(lambda p, k, hd, u: JF._mcs_chunk_compute(
        p, k, hd, u, min(160, PHA), 8))
    want = np.asarray(fn(pool, KERNELS, hd, u))
    got = TF.mcs_predict(torch.from_numpy(pool), torch.from_numpy(KERNELS),
                         torch.from_numpy(np.tile(hd, (n, 1))),
                         torch.from_numpy(u), 8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_mc_pass_matches_jax(w):
    """One class landed into a frame: chunks [0, n_ref0) hold distinct
    first-reference destinations (the last one padded out), chunks
    [n_ref0, n_chunks) compound tiles over some of them."""
    rng = np.random.default_rng(500 + w)
    pool = _pool(rng)
    ha, wa = 2 * PHA, 2 * PWA
    CH, n_ref0, n_avg = 8, 3, 2
    dest = _grid(w, ha, wa)
    dest = dest[rng.permutation(len(dest))[:n_ref0 * CH]]
    # compound tiles: distinct destinations among the first-reference ones
    dest = np.concatenate([dest, dest[rng.permutation(len(dest))]])
    units = np.zeros((n_ref0 + n_avg + 1, CH, 4), np.int32)
    hdrs = np.zeros((n_ref0 + n_avg + 1, 8), np.int32)
    for c in range(n_ref0 + n_avg):
        d = dest[c * CH:(c + 1) * CH]
        units[c] = _records(rng, CH, w, d, PWA, PHA)
        hdrs[c] = [rng.integers(0, 8), rng.integers(0, 3), 0,
                   PWA - rng.integers(0, 8), PHA - rng.integers(0, 8),
                   0, 0, 0]
    units[n_ref0 - 1, CH - 3:] = 0                 # padded tail records
    n_chunks = n_ref0 + n_avg
    F0 = rng.integers(0, 256, (3, ha, wa)).astype(np.int32)

    fn = jax.jit(lambda F, p, k, u, h: JF._mc_pass(
        F, p, k, u, h, n_chunks, n_ref0, w, w, min(160, PHA), 8))
    want = np.asarray(fn(F0, pool, KERNELS, units, hdrs))

    Fbuf = torch.zeros(F0.size + 1, dtype=torch.int32)
    Fbuf[:-1] = torch.from_numpy(F0).reshape(-1)
    TF.mc_pass(Fbuf, torch.from_numpy(pool), torch.from_numpy(KERNELS),
               torch.from_numpy(units), torch.from_numpy(hdrs), n_chunks,
               n_ref0, w, 8, ha, wa)
    got = Fbuf[:-1].reshape(3, ha, wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
