"""The residual wrappers (cuda_vp9_torch/ops/cuda/residual.py) and their
kernel (csrc/residual.cu).

  * `residual_bucket` on the CPU (the plain twin) against JAX
    `cuda_vp9_tpu.runtime.fused._residual_pass` fed the JAX step's own
    expansion (a scan-prefix bucket scattered to raster order through
    the scan of each unit's tx_type), for every bucket of
    `pack.COEFF_BUCKETS` at bit depths 8 and 10 (above 8 bits from hi/lo
    words), the lossless WHT on bucket tx0, and `residual_coo` for tx3c
    and tx3cs ((index, value) pairs with (0, 0) padding), each with padded
    records; the residual frame starts random, so untouched pixels count;
  * three streams in one call (stream k's units in planes 3k + plane)
    against one call per stream;
  * a CUDA tensor never reaches a plain twin: with the kernel's loader
    and the C call stubbed, each call is one launch and `plain_calls`
    stays;
  * on the card (marked `cuda`; skips without a device): the kernel
    against the twin, bit for bit, on every bucket, both coo buckets and
    the WHT at bit depths 8, 10 and 12, with moderate and extreme inputs
    (`tools/kernel_cases.py`), for one stream and for three.

This file imports JAX only inside the tests that need it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_residual_kernel.py`.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch import models as M
from cuda_vp9_torch.ops.cuda import _build
from cuda_vp9_torch.ops.cuda import residual as K
from cuda_vp9_torch.runtime import pack
from cuda_vp9_torch.tools import kernel_cases as KC

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them.
torch.set_num_threads(1)

HA, WA = 64, 64
N_UNITS = 6


def _rbuf(rng, planes, ha=HA, wa=WA):
    """A random residual frame buffer of `planes` planes."""
    return torch.from_numpy(
        rng.integers(-999, 1000, planes * ha * wa + 1).astype(np.int32))


def _jax_bucket(R0, coef, coefh, pos, tx, ncoef, bd, lossless=False):
    """JAX's residual pass on one stream's bucket, expanded as the JAX
    step expands it (fused.py:555-577)."""
    import jax.numpy as jnp
    from cuda_vp9_tpu.runtime import fused as JF

    n2 = (4 << tx) ** 2
    cm = coef.astype(np.int32) if coefh is None else \
        (coefh.astype(np.int32) << 15) + coef
    p = pos.astype(np.int32)
    if ncoef < n2:
        scan = np.stack([np.asarray(M.SCAN_ORDERS[tx][t].scan[:ncoef])
                         for t in range(4)])
        full = np.zeros((len(cm), n2), np.int64)
        full[np.arange(len(cm))[:, None], scan[p[:, 3] & 3]] = cm
        cm = full
    cm = cm.astype(np.int16 if bd == 8 else np.int32)
    return np.asarray(JF._residual_pass(jnp.asarray(R0), jnp.asarray(cm),
                                        jnp.asarray(p), tx, lossless, bd))


@pytest.mark.parametrize("tx", [0, 1, 2, 3])
@pytest.mark.parametrize("bd", [8, 10])
def test_bucket_matches_jax(bd, tx):
    rng = np.random.default_rng(10 * bd + tx)
    buckets = [(nc, False) for _, t, nc in pack.COEFF_BUCKETS if t == tx]
    if tx == 0:
        buckets.append((16, True))          # the lossless WHT
    for ncoef, lossless in buckets:
        coef, coefh, pos = KC.residual_bucket_case(
            rng, 1, N_UNITS, tx, ncoef, bd, HA, WA, extreme=lossless)
        assert (pos[0, :, 1] == 0).any() or lossless
        Rb = _rbuf(rng, 3)
        want = _jax_bucket(Rb[:-1].view(3, HA, WA).numpy().copy(), coef[0],
                           None if coefh is None else coefh[0], pos[0], tx,
                           ncoef, bd, lossless)
        K.residual_bucket(Rb, torch.from_numpy(coef),
                          None if coefh is None else torch.from_numpy(coefh),
                          torch.from_numpy(pos), tx, HA, WA, bd, lossless)
        got = Rb[:-1].view(3, HA, WA).numpy()
        bad = np.argwhere(got != want)
        assert bad.size == 0, \
            f"ncoef {ncoef}: {len(bad)} pixels differ, first at {bad[0]}"


def test_coo_matches_jax():
    import jax.numpy as jnp
    from cuda_vp9_tpu.runtime import fused as JF

    rng = np.random.default_rng(33)
    for npairs in (pack.COO_PAIRS, pack.COO16_PAIRS):
        pairs, pos = KC.residual_coo_case(rng, 1, N_UNITS, npairs, HA, WA)
        Rb = _rbuf(rng, 3)
        # the JAX step's expansion (fused.py:590-600)
        idx = pairs[0, :, 0::2].astype(np.int64)
        val = pairs[0, :, 1::2]
        idx = np.where((idx == 0) & (val == 0), 1024, idx)
        full = np.zeros((N_UNITS, 1025), np.int16)
        full[np.arange(N_UNITS)[:, None], idx] = val
        want = np.asarray(JF._residual_pass(
            jnp.asarray(Rb[:-1].view(3, HA, WA).numpy().copy()),
            jnp.asarray(full[:, :1024]), jnp.asarray(pos[0].astype(np.int32)),
            3, False, 8))
        K.residual_coo(Rb, torch.from_numpy(pairs), torch.from_numpy(pos),
                       HA, WA)
        assert np.array_equal(Rb[:-1].view(3, HA, WA).numpy(), want), npairs


def test_streams_match_per_stream_calls():
    rng = np.random.default_rng(44)
    for tx, ncoef, bd in ((1, 24, 10), (2, 256, 8)):
        coef, coefh, pos = KC.residual_bucket_case(rng, 3, N_UNITS, tx, ncoef,
                                                   bd, HA, WA)
        Rb = _rbuf(rng, 9)
        Rs = Rb.clone()
        hi = None if coefh is None else torch.from_numpy(coefh)
        K.residual_bucket(Rb, torch.from_numpy(coef), hi,
                          torch.from_numpy(pos), tx, HA, WA, bd)
        for k in range(3):
            part = Rs[k * 3 * HA * WA:(k + 1) * 3 * HA * WA + 1].clone()
            K.residual_bucket(part, torch.from_numpy(coef[k:k + 1]),
                              None if hi is None else hi[k:k + 1],
                              torch.from_numpy(pos[k:k + 1]), tx, HA, WA, bd)
            assert torch.equal(Rb[k * 3 * HA * WA:(k + 1) * 3 * HA * WA],
                               part[:-1]), f"stream {k}"


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees of
    a tensor on the card, for its dispatch."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    calls = []

    def fake_call(fn, device, *args):
        calls.append(args)
        return 1

    monkeypatch.setattr(K, "_lib", lambda: "vp9_residual")
    monkeypatch.setattr(_build, "call", fake_call)
    rng = np.random.default_rng(55)
    counts = (K.launches, K.plain_calls)
    coef, coefh, pos = KC.residual_bucket_case(rng, 2, N_UNITS, 0, 16, 10,
                                               HA, WA)
    K.residual_bucket(_OnCuda(_rbuf(rng, 6)),
                      *(_OnCuda(torch.from_numpy(a)) for a in (coef, coefh,
                                                               pos)),
                      0, HA, WA, 10, True)
    assert calls[-1][11] == 1 and calls[-1][7] == 2       # WHT, 2 streams
    pairs, pos = KC.residual_coo_case(rng, 1, N_UNITS, 16, HA, WA)
    K.residual_coo(_OnCuda(_rbuf(rng, 3)), _OnCuda(torch.from_numpy(pairs)),
                   _OnCuda(torch.from_numpy(pos)), HA, WA)
    assert calls[-1][11] == 2 and calls[-1][8] == 3       # pairs, 32x32
    assert (K.launches, K.plain_calls) == (counts[0] + 2, counts[1])
    with pytest.raises(ValueError):    # high words above 8 bits only
        K.residual_bucket(_OnCuda(_rbuf(rng, 3)),
                          *(_OnCuda(torch.from_numpy(a)) for a in (
                              coef[:1], coefh[:1], pos[:1])), 0, HA, WA, 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernel_matches_plain_on_card(bd, streams):
    dev = _card()
    rng = np.random.default_rng(bd * 10 + streams)
    cases = [(tx, nc, False) for _, tx, nc in pack.COEFF_BUCKETS]
    cases.append((0, 16, True))
    for extreme in (False, True):
        for tx, ncoef, lossless in cases:
            coef, coefh, pos = KC.residual_bucket_case(
                rng, streams, 40, tx, ncoef, bd, 128, 128, extreme)
            args = [None if a is None else torch.from_numpy(a).to(dev)
                    for a in (coef, coefh, pos)]
            Rk = _rbuf(rng, 3 * streams, 128, 128).to(dev)
            Rp = Rk.clone()
            launches = K.launches
            K.residual_bucket(Rk, *args, tx, 128, 128, bd, lossless)
            K.residual_bucket_plain(Rp, *args, tx, 128, 128, bd, lossless)
            assert K.launches == launches + 1
            assert torch.equal(Rk[:-1], Rp[:-1]), \
                f"tx {tx} ncoef {ncoef} lossless {lossless} extreme {extreme}"
        if bd == 8:
            for npairs in (pack.COO_PAIRS, pack.COO16_PAIRS):
                pairs, pos = KC.residual_coo_case(rng, streams, 20, npairs,
                                                  128, 128, extreme)
                pt, qt = (torch.from_numpy(a).to(dev) for a in (pairs, pos))
                Rk = _rbuf(rng, 3 * streams, 128, 128).to(dev)
                Rp = Rk.clone()
                K.residual_coo(Rk, pt, qt, 128, 128)
                K.residual_coo_plain(Rp, pt, qt, 128, 128)
                assert torch.equal(Rk[:-1], Rp[:-1]), f"coo {npairs}"
