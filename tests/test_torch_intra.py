"""The port's intra wavefront stage (cuda_vp9_torch/ops/device/stages.py)
against the JAX stage `cuda_vp9_tpu/ops/device/stages.intra_wave`.

Seeded random frames, residuals and units — all 10 modes, bs 4..32,
partial availability (n_above / n_left), the three top-left modes, units
at the frame's right and bottom edges, and padded units (y0 = -32768)
that must write nothing — go through both.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.device import stages as TS
from cuda_vp9_tpu.ops.device import stages as JS

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


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_intra_wave_matches_jax(bs):
    rng = np.random.default_rng(300 + bs)
    ha, wa = 3 * bs, 4 * bs
    F = rng.integers(0, 256, (3, ha, wa)).astype(np.int32)
    R = rng.integers(-255, 256, (3, ha, wa)).astype(np.int32)
    u = _units(rng, bs, ha, wa, n_pad=5)
    assert set(u[:-5, 3]) == set(range(10))
    cols = [u[:, k] for k in range(9)]

    want = np.asarray(JS.intra_wave(F, R, *cols, bs=bs, bd=8))

    Fbuf = torch.zeros(3 * ha * wa + 1, dtype=torch.int32)
    Fbuf[:-1] = torch.from_numpy(F).reshape(-1)
    TS.intra_wave(Fbuf, torch.from_numpy(R),
                  *(torch.from_numpy(c) for c in cols), bs=bs, bd=8)
    got = Fbuf[:-1].reshape(3, ha, wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
    assert (want != F).any()


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
