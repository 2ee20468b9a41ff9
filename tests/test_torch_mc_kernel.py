"""The MC wrapper (cuda_vp9_torch/ops/cuda/mc.py) and its kernel
(csrc/mc.cu).

  * `mc_frame` on the CPU (the plain twins) against JAX
    `cuda_vp9_tpu.runtime.fused._mc_pass` for mc4, mc8, mc16 and mc32 in
    that order, then `_mcs_pass`, applied to the same frame, pool,
    records, headers and counts: the inputs of `tools/kernel_cases.py`
    (8-bit 4:2:0 on a 64x64 canvas, 12-bit 4:2:2 with a pool canvas
    larger than the frame), with compound chunks, padded records, an
    all-zero chunk and sources past the crop on every side;
  * `mc_frame` on several streams (3 streams with different chunk counts
    and n_ref0, the active streams a subset of the pool's) against one
    `mc_frame` per stream;
  * a CUDA tensor never reaches a plain twin: with the kernel's loader
    and the C call stubbed, one stream and several make one host call
    each, count the grids the C side reports and leave `plain_calls`
    alone;
  * on the card (marked `cuda`; skips without a device): the kernel
    against the twins, bit for bit, on every case of
    `kernel_cases.MC_CASES` (bit depths 8, 10 and 12; 4:2:0, 4:4:4 and
    4:2:2; the packer's chunk lengths and short ones; 1, 3 and 4
    streams), one host call a frame or round and one grid per class and
    landing phase with chunks.

This file imports JAX only inside the test that needs it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_mc_kernel.py`.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch import models as M
from cuda_vp9_torch.ops.cuda import _build
from cuda_vp9_torch.ops.cuda import mc as K
from cuda_vp9_torch.tools import kernel_cases as KC

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them.
torch.set_num_threads(1)

KERNELS = np.asarray(M.FILTER_KERNELS, np.int32)


def frame_buffer(F):
    buf = torch.zeros(F.size + 1, dtype=torch.int32)
    buf[:-1] = torch.from_numpy(F).reshape(-1)
    return buf


def case(i, seed):
    bd, ss, ha, wa, pad, n, chunks, scaled = KC.MC_CASES[i]
    return KC.mc_case(np.random.default_rng(seed), bd, ss, ha, wa, pad, n,
                      chunks, scaled)


def pool_of(c, k):
    """Stream k's 8 pool slots."""
    s = 8 * int(c.active[k])
    return c.pool[s:s + 8]


@pytest.mark.parametrize("i", [0, 2])
def test_mc_frame_matches_jax(i):
    import jax
    from cuda_vp9_tpu.runtime import fused as JF

    c = case(i, 600 + i)
    # the JAX kernel reads the row band at the header's srow; the port
    # ignores that field, so both get srow 0 here
    for name in ("mc4h", "mc8h", "mc16h", "mc32h", "mcsh"):
        KC.mc_seg(c.flats, c.segs, name, c.segs[name][1][0])[:, :, 2] = 0
    pool = pool_of(c, 0)
    pha = pool.shape[2]
    classes, scaled = KC.mc_args(c, c.flats, 0)
    assert scaled is not None and scaled[3][0] < scaled[2]
    assert all(r0[0] < n for _, _, _, n, r0, _ in classes)
    mc = jax.jit(JF._mc_pass, static_argnums=(5, 6, 7, 8, 9, 10))
    mcs = jax.jit(JF._mcs_pass, static_argnums=(5, 6, 7, 8))
    want = c.F[:3]
    for w, units, hdrs, n, r0, _ in classes:
        want = mc(want, pool, KERNELS, units[0].astype(np.int32),
                  hdrs[0].astype(np.int32), n, int(r0[0]), w, w, pha, c.bd)
    units, hdrs, n, r0, _ = scaled
    want = np.asarray(mcs(want, pool, KERNELS, units[0].astype(np.int32),
                          hdrs[0].astype(np.int32), n, int(r0[0]), pha,
                          c.bd))

    fl = torch.from_numpy(c.flats)
    Fb = frame_buffer(c.F[:3])
    plain = K.plain_calls
    K.mc_frame(Fb, torch.from_numpy(pool), torch.from_numpy(KERNELS),
               *KC.mc_args(c, fl, 0), None, c.bd, c.ha, c.wa)
    assert K.plain_calls == plain + 1
    got = Fb[:-1].reshape(3, c.ha, c.wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
    assert (want != c.F[:3]).sum() > 1000


def test_batched_matches_per_stream():
    c = case(4, 77)
    A = len(c.flats)
    assert len(set(c.misc[:, 0].tolist())) > 1
    assert len(set(c.misc[:, 23].tolist())) > 1
    fl = torch.from_numpy(c.flats)
    pool = torch.from_numpy(c.pool)
    kern = torch.from_numpy(KERNELS)
    Fb = frame_buffer(c.F)
    classes, _ = KC.mc_args(c, fl)
    K.mc_frame(Fb, pool, kern, classes, None, torch.from_numpy(c.active),
               c.bd, c.ha, c.wa)
    for k in range(A):
        Fk = frame_buffer(c.F[3 * k:3 * k + 3])
        K.mc_frame(Fk, torch.from_numpy(pool_of(c, k)), kern,
                   *KC.mc_args(c, fl, k), None, c.bd, c.ha, c.wa)
        assert torch.equal(Fb[:-1].view(A, 3, c.ha, c.wa)[k],
                           Fk[:-1].view(3, c.ha, c.wa)), f"stream {k}"
    assert (Fb[:-1].numpy() != c.F.reshape(-1)).sum() > 3000


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees of
    a tensor on the card, for its dispatch."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _dress(x):
    """Every tensor of a (nested) argument tuple as an _OnCuda."""
    if isinstance(x, torch.Tensor):
        return _OnCuda(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_dress(y) for y in x)
    return x


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    calls = []

    def fake_call(fn, device, *args):
        calls.append(args)
        return 2 * args[12]         # two grids a class, as the C side says

    monkeypatch.setattr(K, "_lib", lambda: "vp9_mc_pass")
    monkeypatch.setattr(_build, "call", fake_call)
    counts = (K.launches, K.host_calls, K.plain_calls)
    c = case(0, 9)
    fl = torch.from_numpy(c.flats)
    args = (torch.from_numpy(pool_of(c, 0).copy()),
            torch.from_numpy(KERNELS))
    classes, scaled = KC.mc_args(c, fl, 0)
    K.mc_frame(_OnCuda(frame_buffer(c.F[:3])), *_dress(args),
               _dress(classes), _dress(scaled), None, c.bd, c.ha, c.wa)
    assert (K.launches, K.host_calls, K.plain_calls) == (
        counts[0] + 2 * (len(classes) + 1), counts[1] + 1, counts[2])
    assert calls[-1][9] is None and calls[-1][10] == 1   # one stream
    c = case(4, 10)
    fl = torch.from_numpy(c.flats)
    classes, _ = KC.mc_args(c, fl)
    K.mc_frame(_OnCuda(frame_buffer(c.F)), _OnCuda(torch.from_numpy(c.pool)),
               _OnCuda(torch.from_numpy(KERNELS)), _dress(classes), None,
               _OnCuda(torch.from_numpy(c.active)), c.bd, c.ha, c.wa)
    assert K.host_calls == counts[1] + 2 and K.plain_calls == counts[2]
    assert calls[-1][10] == 3 and calls[-1][9] is not None
    w, units, hdrs, n, r0, bounds = KC.mc_args(c, fl, 0)[0][0]
    with pytest.raises(ValueError):       # records must be the int16 wire
        K.mc_frame(_OnCuda(frame_buffer(c.F[:3])), *_dress(args),
                   [(w, _OnCuda(units.to(torch.int32)), _OnCuda(hdrs), n,
                     _OnCuda(r0), bounds)], None, None, c.bd, c.ha, c.wa)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(KC.MC_CASES)))
def test_kernel_matches_plain_on_card(i):
    dev = _card()
    c = case(i, 700 + i)
    fl = torch.from_numpy(c.flats).to(dev)
    kern = torch.from_numpy(KERNELS).to(dev)
    if len(c.flats) == 1:
        pool, active = pool_of(c, 0), None
        classes, scaled = KC.mc_args(c, fl, 0)
    else:
        pool, active = c.pool, torch.from_numpy(c.active).to(dev)
        classes, scaled = KC.mc_args(c, fl)
    args = (torch.from_numpy(pool).to(dev), kern, classes, scaled, active,
            c.bd, c.ha, c.wa)
    F0 = frame_buffer(c.F).to(dev)
    Fk, Fp = F0.clone(), F0.clone()
    counts = (K.launches, K.scaled_launches, K.host_calls)
    K.mc_frame(Fk, *args)
    assert (K.launches - counts[0], K.scaled_launches - counts[1],
            K.host_calls - counts[2]) == (*KC.mc_grids(c), 1)
    K.mc_frame_plain(Fp, *args)
    assert torch.equal(Fk[:-1], Fp[:-1])
    assert (Fp[:-1] != F0[:-1]).sum() > 1000
