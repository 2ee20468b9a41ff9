"""The port's inverse transforms (cuda_vp9_torch/ops/transforms.py) against
the JAX step's own calls of the shared reference, bit for bit.

The lossless WHT (`inv_wht2d`) is held against the reference twice: in
NumPy (int64) and as the JAX step calls it (`xp=jnp`,
`work_dtype=jnp.int32`), at bit depths 8, 10 and 12.

runtime/fused._residual_pass runs `T.inv_txfm2d` (32x32) and
`T.inv_txfm2d_select` (4..16, per-unit tx_type) with xp=jnp and
work_dtype=jnp.int16 at bd 8 (the int16 WRAPLOW domain) and
work_dtype=jnp.int32 at bd 10 and 12 (the emulated WRAPLOW domain in
int32).  The same seeded coefficients go through both; full-range
coefficients drive the butterflies through their wrap points (and, above
8 bits, the int32 products through theirs).  Tolerance 0: integer
math."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_vp9_torch.ops import transforms as TT
from cuda_vp9_tpu.ops.ref import transforms as T


# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)


def _coeffs(rng, n_units, n, extreme):
    if extreme:
        return rng.integers(-32768, 32768, (n_units, n * n)).astype(np.int16)
    c = rng.integers(-1024, 1025, (n_units, n * n))
    return (c * (rng.random(c.shape) < 0.25)).astype(np.int16)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("tx_size", [0, 1, 2, 3])
def test_inv_txfm2d_matches_jax(tx_size, extreme):
    rng = np.random.default_rng(100 + tx_size + 10 * extreme)
    n = 4 << tx_size
    for tt in ([0] if tx_size == 3 else [0, 1, 2, 3]):
        c = _coeffs(rng, 48, n, extreme)
        want = np.asarray(T.inv_txfm2d(jnp.asarray(c), tx_size, tt, 8,
                                       xp=jnp, work_dtype=jnp.int16))
        got = TT.inv_txfm2d(torch.from_numpy(c), tx_size, tt)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), \
            f"tx_size={tx_size} tx_type={tt} extreme={extreme}"


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("tx_size", [0, 1, 2])
def test_inv_txfm2d_select_matches_jax(tx_size, extreme):
    rng = np.random.default_rng(200 + tx_size + 10 * extreme)
    n = 4 << tx_size
    c = _coeffs(rng, 64, n, extreme)
    tt = rng.integers(0, 4, 64).astype(np.int32)
    want = np.asarray(T.inv_txfm2d_select(jnp.asarray(c), tx_size,
                                          jnp.asarray(tt), 8, xp=jnp,
                                          work_dtype=jnp.int16))
    got = TT.inv_txfm2d_select(torch.from_numpy(c), tx_size,
                               torch.from_numpy(tt))
    assert np.array_equal(got.numpy(), want)


def _coeffs32(rng, n_units, n, bd, extreme):
    """int32 coefficients of a high-bit-depth stream: sparse and moderate,
    or dense and up to the bd + 8-bit WRAPLOW range."""
    lim = 1 << (bd + (7 if extreme else 4))
    c = rng.integers(-lim, lim, (n_units, n * n))
    if not extreme:
        c = c * (rng.random(c.shape) < 0.25)
    return c.astype(np.int32)


@pytest.mark.parametrize("tx_size", [0, 1, 2, 3])
@pytest.mark.parametrize("bd", [10, 12])
def test_inv_txfm2d_int32_matches_jax(bd, tx_size):
    rng = np.random.default_rng(400 + bd + tx_size)
    n = 4 << tx_size
    for extreme in (False, True):
        for tt in ([0] if tx_size == 3 else [0, 1, 2, 3]):
            c = _coeffs32(rng, 16, n, bd, extreme)
            want = np.asarray(T.inv_txfm2d(jnp.asarray(c), tx_size, tt, bd,
                                           xp=jnp, work_dtype=jnp.int32))
            got = TT.inv_txfm2d(torch.from_numpy(c), tx_size, tt, bd)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), \
                f"bd={bd} tx_size={tx_size} tx_type={tt} extreme={extreme}"


@pytest.mark.parametrize("tx_size", [0, 1, 2])
@pytest.mark.parametrize("bd", [10, 12])
def test_inv_txfm2d_select_int32_matches_jax(bd, tx_size):
    rng = np.random.default_rng(500 + bd + tx_size)
    n = 4 << tx_size
    for extreme in (False, True):
        c = _coeffs32(rng, 32, n, bd, extreme)
        tt = rng.integers(0, 4, 32).astype(np.int32)
        want = np.asarray(T.inv_txfm2d_select(
            jnp.asarray(c), tx_size, jnp.asarray(tt), bd, xp=jnp,
            work_dtype=jnp.int32))
        got = TT.inv_txfm2d_select(torch.from_numpy(c), tx_size,
                                   torch.from_numpy(tt), bd)
        assert np.array_equal(got.numpy(), want), f"extreme={extreme}"


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_inv_wht2d_matches_reference(bd):
    """Lossless units: coefficients up to the bd + 8-bit range (int16 at
    bd 8, as the wire ships them), dense and sparse."""
    rng = np.random.default_rng(600 + bd)
    lim = 1 << (bd + 7)
    c = rng.integers(-lim, lim, (256, 16))
    c[128:] *= rng.random((128, 16)) < 0.3
    c = c.astype(np.int16 if bd == 8 else np.int32)
    got = TT.inv_wht2d(torch.from_numpy(c), bd)
    assert got.dtype == torch.int32 and got.shape == (256, 4, 4)
    want_np = T.inv_wht2d(c, bd)
    want_jnp = np.asarray(T.inv_wht2d(jnp.asarray(c), bd, xp=jnp,
                                      work_dtype=jnp.int32))
    assert np.array_equal(got.numpy(), want_np)
    assert np.array_equal(got.numpy(), want_jnp)
