"""The port's intra wavefront stage (cuda_vp9_torch/ops/device/stages.py)
against the JAX stage `cuda_vp9_tpu/ops/device/stages.intra_wave`, and its
predictors at 10 and 12 bits against the NumPy oracle
`cuda_vp9_tpu/ops/ref/intra.predict`.

Seeded random frames, residuals and units — all 10 modes, bs 4..32,
partial availability (n_above / n_left), the three top-left modes, units
at the frame's right and bottom edges, and padded units (y0 = -32768)
that must write nothing — go through both.  Above 8 bits the edge fills
(base - 1, base + 1) and the clip scale with the bit depth.  Tolerance
0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.device import stages as TS
from cuda_vp9_tpu.ops.device import stages as JS
from cuda_vp9_tpu.ops.ref import intra as ref_intra

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

PAD = -32768


def _units(rng, bs, ha, wa, n_pad):
    """One wave of disjoint bs x bs units on a grid that reaches the
    frame's last row and column, modes in turn, plus n_pad padded
    units."""
    units = []
    for y0 in range(0, ha - bs + 1, bs):
        for x0 in range(0, wa - bs + 1, bs):
            have_up = int(y0 > 0 and rng.integers(0, 4) > 0)
            have_left = int(x0 > 0 and rng.integers(0, 4) > 0)
            n_above = int(rng.integers(1, 2 * bs + 1)) if have_up else 0
            n_above = min(n_above, wa - x0)
            n_left = int(rng.integers(1, bs + 1)) if have_left else 0
            tl_mode = 0 if (have_up and have_left) else \
                1 if have_left else 2
            units.append((int(rng.integers(0, 3)), x0, y0,
                          len(units) % 10, n_above, n_left,
                          tl_mode, have_up, have_left))
    units += [(0, 0, PAD, 0, 0, 0, 0, 0, 0)] * n_pad
    return np.asarray(units, np.int32)


def _check_intra_wave(seed, bs, bd):
    rng = np.random.default_rng(seed)
    ha, wa = 3 * bs, 4 * bs
    F = rng.integers(0, 1 << bd, (3, ha, wa)).astype(np.int32)
    R = rng.integers(1 - (1 << bd), 1 << bd, (3, ha, wa)).astype(np.int32)
    u = _units(rng, bs, ha, wa, n_pad=5)
    assert set(u[:-5, 3]) == set(range(10))
    cols = [u[:, k] for k in range(9)]

    want = np.asarray(JS.intra_wave(F, R, *cols, bs=bs, bd=bd))

    Fbuf = torch.zeros(3 * ha * wa + 1, dtype=torch.int32)
    Fbuf[:-1] = torch.from_numpy(F).reshape(-1)
    TS.intra_wave(Fbuf, torch.from_numpy(R),
                  *(torch.from_numpy(c) for c in cols), bs=bs, bd=bd)
    got = Fbuf[:-1].reshape(3, ha, wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
    assert (want != F).any()


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_intra_wave_matches_jax(bs):
    _check_intra_wave(300 + bs, bs, 8)


def test_intra_wave_matches_jax_10bit():
    _check_intra_wave(310, 8, 10)


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [10, 12])
def test_predictors_high_bitdepth_match_oracle(bd, bs):
    """All 10 predictors at bd 10/12 against ops/ref/intra.predict, with
    edges of the full bd range, every availability case and the bd-scaled
    fills the edge builder would give (base - 1 above, base + 1 left)."""
    rng = np.random.default_rng(600 + bd + bs)
    N = 12
    base = 128 << (bd - 8)
    have_up = np.arange(N) % 4 < 2
    have_left = np.arange(N) % 2 == 0
    A = rng.integers(0, 1 << bd, (N, 2 * bs))
    L = rng.integers(0, 1 << bd, (N, bs))
    tl = rng.integers(0, 1 << bd, N)
    A[~have_up] = base - 1
    L[~have_left] = base + 1
    tl[~have_up] = base - 1
    tl[have_up & ~have_left] = base + 1
    preds = TS._predictors(
        bs, torch.from_numpy(A.astype(np.int32)),
        torch.from_numpy(tl.astype(np.int32)),
        torch.from_numpy(L.astype(np.int32)), torch.from_numpy(have_up),
        torch.from_numpy(have_left), bd).numpy()
    for n in range(N):
        for mode in range(10):
            want = ref_intra.predict(mode, bs, A[n], tl[n], L[n],
                                     bool(have_left[n]), bool(have_up[n]),
                                     bd)
            assert np.array_equal(preds[n, mode], want), (n, mode)


def test_intra_wave_padded_units_write_nothing():
    rng = np.random.default_rng(7)
    F = rng.integers(0, 256, (3, 40, 40)).astype(np.int32)
    Fbuf = torch.zeros(F.size + 1, dtype=torch.int32)
    Fbuf[:-1] = torch.from_numpy(F).reshape(-1)
    z = torch.zeros(8, dtype=torch.int32)
    TS.intra_wave(Fbuf, torch.zeros(3, 40, 40, dtype=torch.int32), z + 1,
                  z + 4, z + PAD, z, z + 5, z + 5, z, z + 1, z + 1,
                  bs=4, bd=8)
    assert np.array_equal(Fbuf[:-1].reshape(3, 40, 40).numpy(), F)
