"""The residual wrapper (cuda_vp9_torch/ops/cuda/residual.py) and its
kernel (csrc/residual.cu).

  * `residual_frame` on the CPU (the plain twins) against JAX
    `cuda_vp9_tpu.runtime.fused._residual_pass` fed the JAX step's own
    expansion (a scan-prefix bucket scattered to raster order through
    the scan of each unit's tx_type), for every bucket of
    `pack.COEFF_BUCKETS` at bit depths 8 and 10 (above 8 bits from hi/lo
    words), the lossless WHT on bucket tx0, and the coo buckets tx3c and
    tx3cs ((index, value) pairs with (0, 0) padding), each with padded
    records; the residual frame starts random, so untouched pixels count;
  * three streams in one call (stream k's units in planes 3k + plane)
    against one call per stream;
  * a CUDA tensor never reaches a plain twin: with the kernel's loader
    and the C call stubbed, each call is one launch of a bucket table
    and `plain_calls` stays; `fused.residual_stage` on kf01's keyframe
    passes one table that holds every bucket it has, in the step's
    order, with block ranges that partition the units;
  * on the card (marked `cuda`; skips without a device): the kernel
    against the twins, bit for bit, one launch for a whole bucket set
    (every bucket, the WHT and, at 8 bits, both coo buckets) at bit
    depths 8, 10 and 12, with moderate and extreme inputs
    (`tools/kernel_cases.py`), for one stream and for three.

This file imports JAX only inside the tests that need it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_residual_kernel.py`.  Tolerance 0: integer math."""

import ctypes

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


def _frame(Rb, cases, bd):
    """residual_frame on bucket cases laid out as a flat's segments."""
    src, bks = KC.pack_buckets(cases)
    K.residual_frame(Rb, torch.from_numpy(src), bks, HA, WA, bd)


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
        _frame(Rb, [(coef, coefh, pos, tx, int(lossless))], bd)
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
        _frame(Rb, [(pairs, None, pos, 3, 2)], 8)
        assert np.array_equal(Rb[:-1].view(3, HA, WA).numpy(), want), npairs


def test_streams_match_per_stream_calls():
    rng = np.random.default_rng(44)
    for tx, ncoef, bd in ((1, 24, 10), (2, 256, 8)):
        coef, coefh, pos = KC.residual_bucket_case(rng, 3, N_UNITS, tx, ncoef,
                                                   bd, HA, WA)
        Rb = _rbuf(rng, 9)
        Rs = Rb.clone()
        _frame(Rb, [(coef, coefh, pos, tx, 0)], bd)
        for k in range(3):
            part = Rs[k * 3 * HA * WA:(k + 1) * 3 * HA * WA + 1].clone()
            _frame(part, [(coef[k:k + 1],
                           None if coefh is None else coefh[k:k + 1],
                           pos[k:k + 1], tx, 0)], bd)
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


def _table(ptr, n):
    """The [n, DESC_WORDS] descriptor table the fake C call was given."""
    words = (ctypes.c_int64 * (n * K.DESC_WORDS)).from_address(ptr)
    return np.ctypeslib.as_array(words).reshape(n, K.DESC_WORDS).copy()


@pytest.fixture
def fake_card(monkeypatch):
    """Stub the kernel's loader, the C call (recording each call with its
    table) and the scan tables' upload; returns the calls."""
    calls = []

    def fake_call(fn, device, *args):
        calls.append((args, _table(args[1], args[2])))
        return 1

    scan_table = K.scan_table
    monkeypatch.setattr(K, "_lib", lambda: "vp9_residual_frame")
    monkeypatch.setattr(_build, "call", fake_call)
    monkeypatch.setattr(K, "scan_table", lambda tx, nc, device, dtype: (
        scan_table(tx, nc, "cpu", dtype)))
    return calls


def test_cuda_tensor_never_takes_the_twin(fake_card):
    calls = fake_card
    rng = np.random.default_rng(55)
    counts = (K.launches, K.buckets, K.plain_calls)
    coef, coefh, pos = KC.residual_bucket_case(rng, 2, N_UNITS, 0, 16, 10,
                                               HA, WA)
    src, bks = KC.pack_buckets([(coef, coefh, pos, 0, 1)])
    src = _OnCuda(torch.from_numpy(src))
    K.residual_frame(_OnCuda(_rbuf(rng, 6)), src, bks, HA, WA, 10)
    (args, table), = calls
    assert args[2:] == (1, 6, HA, WA, 10)               # 1 bucket, 6 planes
    assert table[0, 4:].tolist() == [src.stride(0)] * 2 + [
        N_UNITS, 2, 0, 1, 16, 0]                         # WHT, 2 streams
    assert table[0, :3].tolist() == [src.data_ptr() + 2 * o for o in (
        bks[0].coef, bks[0].coefh, bks[0].pos)]
    pairs, pos = KC.residual_coo_case(rng, 1, N_UNITS, 16, HA, WA)
    coef, _, cpos = KC.residual_bucket_case(rng, 1, N_UNITS, 1, 10, 8, HA,
                                            WA)
    src, bks = KC.pack_buckets([(coef, None, cpos, 1, 0),
                                (pairs, None, pos, 3, 2)])
    K.residual_frame(_OnCuda(_rbuf(rng, 3)), _OnCuda(torch.from_numpy(src)),
                     bks, HA, WA, 8)
    table = calls[-1][1]
    # a scan-prefix 8x8 bucket (16 units a block), then the coo pairs
    assert table[:, 8:].tolist() == [[1, 0, 10, 0], [3, 2, 32, 1]]
    assert table[0, 3] != 0 and table[1, 3] == 0         # scan, none
    assert (K.launches, K.buckets, K.plain_calls) == (
        counts[0] + 2, counts[1] + 3, counts[2])
    with pytest.raises(ValueError):    # high words above 8 bits only
        K.residual_frame(_OnCuda(_rbuf(rng, 3)),
                         _OnCuda(torch.from_numpy(src)),
                         [bks[0]._replace(coefh=bks[0].coef)], HA, WA, 8)
    with pytest.raises(ValueError):    # a segment past the flat's end
        K.residual_frame(_OnCuda(_rbuf(rng, 3)),
                         _OnCuda(torch.from_numpy(src)),
                         [bks[1]._replace(n=N_UNITS + 1)], HA, WA, 8)


def test_residual_stage_builds_one_table(fake_card):
    """fused.residual_stage on the card path (kf01's keyframe, 64x64):
    one call whose table holds every bucket the frame has, in the step's
    order, with its records, and whose block ranges partition the
    units."""
    from cuda_vp9_torch.runtime import fused as TF
    from test_torch_intra_pass import keyframe_flat

    calls = fake_card
    flat, layout, mi_rows, mi_cols = keyframe_flat("kf01_64x64")
    misc = layout.view(flat, "misc").astype(np.int64)
    flat_t = torch.from_numpy(flat)
    TF.residual_stage(_OnCuda(TF.frame_buffer(64, 64, "cpu")),
                      _OnCuda(flat_t[None]), lambda slot: int(misc[slot]),
                      layout.segs, 64, 64, 8, False)
    (args, table), = calls
    want = [(name, tx, int(misc[pack.MISC_TRIP[name]])
             * pack.COEFF_CHUNK[name]) for name, tx, _ in pack.COEFF_BUCKETS]
    want += [(name, 3, int(misc[slot]) * chunk) for name, slot, chunk in (
        ("tx3c", pack.MISC_TRIP_TX3C, pack.CHUNK_TX3C),
        ("tx3cs", pack.MISC_TRIP_TX3CS, pack.CHUNK_TX3CS))]
    want = [w for w in want if w[2] and f"coeff_{w[0]}" in layout.segs]
    assert len(want) > 1 and args[2] == len(table) == len(want)
    first = 0
    for (name, tx, n), row in zip(want, table):
        off = layout.segs[f"coeff_{name}"][0]
        assert row[0] == flat_t.data_ptr() + 2 * off      # its records
        assert row[6:9].tolist() == [n, 1, tx] and row[11] == first
        first += -(-n // (128 // (4 << tx)))
    # each block in exactly one range, each range's blocks hold its units
    blocks = [-(-r[6] * r[7] // (128 // (4 << r[8]))) for r in table]
    assert [int(r[11]) for r in table] == np.cumsum([0] + blocks[:-1]
                                                     ).tolist()


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
    for extreme in (False, True):
        src, bset = KC.pack_buckets(KC.residual_frame_case(
            rng, streams, bd, 128, 128, 40, extreme))
        src = torch.from_numpy(src).to(dev)
        Rk = _rbuf(rng, 3 * streams, 128, 128).to(dev)
        Rp = Rk.clone()
        counts = (K.launches, K.buckets)
        K.residual_frame(Rk, src, bset, 128, 128, bd)
        assert (K.launches, K.buckets) == (counts[0] + 1,
                                           counts[1] + len(bset))
        K.residual_frame_plain(Rp, src, bset, 128, 128, bd)
        assert torch.equal(Rk[:-1], Rp[:-1]), f"extreme {extreme}"
        assert len(bset) == 13 + 2 * (bd == 8)
