"""The port's loop filter (cuda_vp9_torch/ops/cuda/loopfilter.py).

  * `lf_frame_plain` against the Pallas `lf_frame` in interpret mode at
    one superblock, and against the NumPy oracle's window filters applied
    in the normative order (tests/test_pallas_lf._ref_filter) at 2x3;
  * `lf_on = 0` is the identity, and a CPU tensor takes the plain path;
  * `_hostshim` against the Pallas module's three pack names, byte for
    byte;
  * the CUDA kernel against `lf_frame_plain` on the card (marked `cuda`;
    skips without a device).  This file imports JAX only inside the tests
    that compare with it, so on a machine without JAX the kernel test
    runs with `python -m pytest --noconftest -m cuda
    tests/test_torch_loopfilter.py`.

Inputs are seeded: 8x8 blocks of random level and noise amplitude, so
every filter width engages, and edge metadata as test_pallas_lf builds
it.  Tolerance 0: integer math."""

import sys

import numpy as np
import pytest
import torch

from cuda_vp9_torch import _hostshim
from cuda_vp9_torch.ops.cuda import loopfilter as LF
from cuda_vp9_tpu.ops.ref.loopfilter import make_thresholds


# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)


def _pixels(rng, h, w):
    lvl = rng.integers(0, 256, (h // 8, w // 8))
    amp = rng.choice([1, 3, 9, 40], (h // 8, w // 8))
    noise = rng.integers(-64, 65, (h, w)) % np.repeat(
        np.repeat(amp, 8, 0), 8, 1)
    return np.clip(np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0, 255)


def _cells(rng, R, C, top_off):
    kind = rng.integers(0, 4, (R, C))
    m16, m8, m4 = kind == 1, kind == 2, kind == 3
    m4i = (rng.random((R, C)) < 0.4) & ~m16
    for m in (m16, m8, m4):
        if top_off:
            m[0, :] = False              # no edge on the frame's top border
        else:
            m[:, 0] = False              # ... nor on its left border
    if top_off:
        m4i &= ~m16                      # h4i never with h16
    return rng.integers(0, 64, (R, C)), (m16, m8, m4, m4i)


def _inputs(rng, mi_rows, mi_cols):
    """(F [3, ha, wa] int32, meta_y, meta_uv, thr tables, lfm, thr_t)."""
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    F = np.zeros((3, ha, wa), np.int32)
    F[0] = _pixels(rng, ha, wa)
    for p in (1, 2):
        F[p, :ha // 2, :wa // 2] = _pixels(rng, ha // 2, wa // 2)
    R2, C2 = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    lvl_y, vy = _cells(rng, mi_rows, mi_cols, False)
    _, hy = _cells(rng, mi_rows, mi_cols, True)
    lvl_uv, vuv = _cells(rng, R2, C2, False)
    _, huv = _cells(rng, R2, C2, True)
    thr = make_thresholds(int(rng.integers(0, 8)))
    lfm = _hostshim.pack_lfm_fields(lvl_y, vy, hy, lvl_uv, vuv, huv,
                                    mi_rows, mi_cols)
    return (F, (lvl_y, vy, hy), (lvl_uv, vuv, huv), thr, lfm,
            _hostshim.pack_lf_thresholds(thr))


def _plain(F, lfm, thr_t, lf_on, mi_rows, mi_cols):
    Ft = torch.from_numpy(F.copy())
    LF.lf_frame_plain(Ft, torch.from_numpy(lfm), torch.from_numpy(thr_t),
                      lf_on, mi_rows=mi_rows, mi_cols=mi_cols, bd=8)
    return Ft.numpy()


def test_plain_matches_pallas_interpret():
    import jax.numpy as jnp
    from cuda_vp9_tpu.ops.pallas import loopfilter as plf
    mi_rows, mi_cols = 8, 8
    rng = np.random.default_rng(600)
    F, _, _, _, lfm, thr_t = _inputs(rng, mi_rows, mi_cols)
    want = np.asarray(plf.lf_frame(
        jnp.asarray(F), jnp.asarray(lfm), jnp.asarray(thr_t), jnp.int32(1),
        mi_rows=mi_rows, mi_cols=mi_cols, bd=8, interpret=True))
    got = _plain(F, lfm, thr_t, 1, mi_rows, mi_cols)
    assert (got != F).any()
    assert np.array_equal(got, want)


def test_plain_matches_oracle_order():
    from test_pallas_lf import _ref_filter
    rng = np.random.default_rng(11)
    mi_rows, mi_cols = 15, 23                   # 2x3 SBs, ragged mi grid
    F, meta_y, meta_uv, thr, lfm, thr_t = _inputs(rng, mi_rows, mi_cols)
    ha, wa = F.shape[1:]
    planes = [F[0].astype(np.int64), F[1, :ha // 2, :wa // 2].astype(
        np.int64), F[2, :ha // 2, :wa // 2].astype(np.int64)]
    _ref_filter(planes, meta_y, meta_uv, thr, 8)
    got = _plain(F, lfm, thr_t, 1, mi_rows, mi_cols)
    assert np.array_equal(got[0], planes[0]), "luma"
    assert np.array_equal(got[1, :ha // 2, :wa // 2], planes[1]), "U"
    assert np.array_equal(got[2, :ha // 2, :wa // 2], planes[2]), "V"


def test_lf_off_is_identity_and_cpu_takes_plain():
    rng = np.random.default_rng(3)
    F, _, _, _, lfm, thr_t = _inputs(rng, 8, 16)
    launches, plain = LF.launches, LF.plain_calls
    Ft = torch.from_numpy(F.copy())
    LF.lf_frame(Ft, torch.from_numpy(lfm), torch.from_numpy(thr_t), 0,
                mi_rows=8, mi_cols=16, bd=8)
    assert np.array_equal(Ft.numpy(), F)
    assert (LF.launches, LF.plain_calls) == (launches, plain + 1)


def test_hostshim_matches_pallas_pack_names():
    from cuda_vp9_tpu.ops.pallas import loopfilter as plf
    assert sys.modules["cuda_vp9_tpu.ops.pallas.loopfilter"] is plf
    assert plf is not _hostshim and _hostshim.K == plf.K
    rng = np.random.default_rng(5)
    for mi_rows, mi_cols in ((8, 8), (15, 23), (37, 5)):
        F, my, muv, thr, lfm, thr_t = _inputs(rng, mi_rows, mi_cols)
        want = plf.pack_lfm_fields(*my, *muv, mi_rows, mi_cols)
        assert lfm.dtype == want.dtype and lfm.tobytes() == want.tobytes()
        want_t = plf.pack_lf_thresholds(thr)
        assert thr_t.dtype == want_t.dtype
        assert thr_t.tobytes() == want_t.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("mi_rows,mi_cols", [(8, 8), (45, 80), (135, 240)])
def test_kernel_matches_plain_on_card(mi_rows, mi_cols):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(mi_rows * 1000 + mi_cols)
    F, _, _, _, lfm, thr_t = _inputs(rng, mi_rows, mi_cols)
    dev = torch.device("cuda")
    args = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr_t).to(dev))
    kw = dict(mi_rows=mi_rows, mi_cols=mi_cols, bd=8)
    Fk = torch.from_numpy(F).to(dev)
    Fp = Fk.clone()
    launches = LF.launches
    LF.lf_frame(Fk, *args, 1, **kw)
    LF.lf_frame_plain(Fp, *args, 1, **kw)
    assert LF.launches == launches + 1
    assert torch.equal(Fk, Fp)
    assert not torch.equal(Fk.cpu(), torch.from_numpy(F))
    Fo = torch.from_numpy(F).to(dev)
    LF.lf_frame(Fo, *args, 0, **kw)
    assert torch.equal(Fo.cpu(), torch.from_numpy(F))
