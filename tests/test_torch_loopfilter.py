"""The port's loop filter (cuda_vp9_torch/ops/cuda/loopfilter.py).

  * `lf_frame_plain` against the Pallas `lf_frame` in interpret mode at
    one superblock, and against the NumPy oracle's window filters applied
    in the normative order (tests/test_pallas_lf._ref_filter) at 2x3, at
    bit depths 8, 10 and 12, and on the 4:4:4 chroma-plane call (one
    chroma plane as plane 0 of a [3, hac, wac] canvas, zero chroma
    fields);
  * `lf_on = 0` is the identity, and a CPU tensor takes the plain path;
  * the port's `runtime/lfmeta` pack names against the Pallas module's,
    byte for byte;
  * the CUDA kernel against `lf_frame_plain` on the card at bit depths 8,
    10 and 12 and on the 4:4:4 chroma canvas, one launch per call, ten
    runs of one input and two calls that reuse one workspace (marked
    `cuda`; skips without a device).  This file imports JAX only inside the tests that
    compare with it, and the oracle (`cuda_vp9_tpu.ops.ref`, NumPy) only
    where it is needed, so on a machine without JAX the kernel tests run
    with `python -m pytest --noconftest -m cuda
    tests/test_torch_loopfilter.py`.

Inputs are seeded: 8x8 blocks of random level and noise amplitude (both
scaled to the bit depth), so every filter width engages, and edge
metadata as test_pallas_lf builds it.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.cuda import loopfilter as LF
from cuda_vp9_torch.ops.ref.loopfilter import make_thresholds
from cuda_vp9_torch.runtime import lfmeta


# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)


def _pixels(rng, h, w, bd=8):
    s = bd - 8
    lvl = rng.integers(0, 256 << s, (h // 8, w // 8))
    amp = rng.choice([1, 3, 9, 40], (h // 8, w // 8)) << s
    noise = rng.integers(-64 << s, (64 << s) + 1, (h, w)) % np.repeat(
        np.repeat(amp, 8, 0), 8, 1)
    return np.clip(np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0,
                   (1 << bd) - 1)


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


def _inputs(rng, mi_rows, mi_cols, bd=8):
    """(F [3, ha, wa] int32, meta_y, meta_uv, thr tables, lfm, thr_t)."""
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    F = np.zeros((3, ha, wa), np.int32)
    F[0] = _pixels(rng, ha, wa, bd)
    for p in (1, 2):
        F[p, :ha // 2, :wa // 2] = _pixels(rng, ha // 2, wa // 2, bd)
    R2, C2 = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    lvl_y, vy = _cells(rng, mi_rows, mi_cols, False)
    _, hy = _cells(rng, mi_rows, mi_cols, True)
    lvl_uv, vuv = _cells(rng, R2, C2, False)
    _, huv = _cells(rng, R2, C2, True)
    thr = make_thresholds(int(rng.integers(0, 8)))
    lfm = lfmeta.pack_lfm_fields(lvl_y, vy, hy, lvl_uv, vuv, huv,
                                 mi_rows, mi_cols)
    return (F, (lvl_y, vy, hy), (lvl_uv, vuv, huv), thr, lfm,
            lfmeta.pack_lf_thresholds(thr))


def _inputs_444_chroma(rng, rc, cc, bd):
    """The 4:4:4 chroma-plane call of the frame step: a chroma plane as
    plane 0 of a [3, hac, wac] canvas, its cells in luma format and zero
    chroma fields (runtime/pack._pack_lf).  Returns (canvas, meta, thr
    tables, lfm, thr_t)."""
    hac, wac = ((rc + 7) & ~7) * 8, ((cc + 7) & ~7) * 8
    C = np.zeros((3, hac, wac), np.int32)
    C[0] = _pixels(rng, hac, wac, bd)
    lvl, v = _cells(rng, rc, cc, False)
    _, h = _cells(rng, rc, cc, True)
    thr = make_thresholds(int(rng.integers(0, 8)))
    z1 = np.zeros((1, 1), lvl.dtype)
    zm = (np.zeros((1, 1), bool),) * 4
    lfm = lfmeta.pack_lfm_fields(lvl, v, h, z1, zm, zm, rc, cc)
    return C, (lvl, v, h), thr, lfm, lfmeta.pack_lf_thresholds(thr)


def _plain(F, lfm, thr_t, lf_on, mi_rows, mi_cols, bd=8):
    Ft = torch.from_numpy(F.copy())
    LF.lf_frame_plain(Ft, torch.from_numpy(lfm), torch.from_numpy(thr_t),
                      lf_on, mi_rows=mi_rows, mi_cols=mi_cols, bd=bd)
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


def _check_oracle_order(seed, bd):
    from test_pallas_lf import _ref_filter
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = 15, 23                   # 2x3 SBs, ragged mi grid
    F, meta_y, meta_uv, thr, lfm, thr_t = _inputs(rng, mi_rows, mi_cols, bd)
    ha, wa = F.shape[1:]
    planes = [F[0].astype(np.int64), F[1, :ha // 2, :wa // 2].astype(
        np.int64), F[2, :ha // 2, :wa // 2].astype(np.int64)]
    _ref_filter(planes, meta_y, meta_uv, thr, bd)
    got = _plain(F, lfm, thr_t, 1, mi_rows, mi_cols, bd)
    assert (got != F).any()
    assert np.array_equal(got[0], planes[0]), "luma"
    assert np.array_equal(got[1, :ha // 2, :wa // 2], planes[1]), "U"
    assert np.array_equal(got[2, :ha // 2, :wa // 2], planes[2]), "V"


def test_plain_matches_oracle_order():
    _check_oracle_order(11, 8)


@pytest.mark.parametrize("bd", [10, 12])
def test_plain_matches_oracle_order_high_bitdepth(bd):
    _check_oracle_order(11 + bd, bd)


def test_plain_444_chroma_plane_matches_oracle():
    """The frame step's 4:4:4 chroma call at 10 bits: the luma path on a
    chroma plane's cell grid (15 x 23 cells, 2x3 SBs), against the oracle
    window filters in the normative order; planes 1 and 2 stay zero."""
    from test_pallas_lf import _ref_filter
    rng = np.random.default_rng(444)
    rc, cc, bd = 15, 23, 10
    C, meta, thr, lfm, thr_t = _inputs_444_chroma(rng, rc, cc, bd)
    want = [C[0].astype(np.int64), np.zeros((0, 0), np.int64),
            np.zeros((0, 0), np.int64)]
    none = (np.zeros((0, 0), np.int64), (np.zeros((0, 0), bool),) * 4,
            (np.zeros((0, 0), bool),) * 4)
    _ref_filter(want, meta, none, thr, bd)
    got = _plain(C, lfm, thr_t, 1, rc, cc, bd)
    assert (got[0] != C[0]).any()
    assert np.array_equal(got[0], want[0])
    assert not got[1:].any()


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
    """The pack names the port keeps in runtime/lfmeta (K,
    pack_lfm_fields, pack_lf_thresholds) against the Pallas module's."""
    from cuda_vp9_tpu.ops.pallas import loopfilter as plf
    assert lfmeta.K == plf.K
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
    # one persistent launch per call
    assert LF.launches == launches + 1
    assert torch.equal(Fk, Fp)
    assert not torch.equal(Fk.cpu(), torch.from_numpy(F))
    Fo = torch.from_numpy(F).to(dev)
    LF.lf_frame(Fo, *args, 0, **kw)
    assert torch.equal(Fo.cpu(), torch.from_numpy(F))


def _kernel_vs_plain(F, lfm, thr_t, mi_rows, mi_cols, bd):
    dev = torch.device("cuda")
    args = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr_t).to(dev))
    kw = dict(mi_rows=mi_rows, mi_cols=mi_cols, bd=bd)
    Fk = torch.from_numpy(F).to(dev)
    Fp = Fk.clone()
    LF.lf_frame(Fk, *args, 1, **kw)
    LF.lf_frame_plain(Fp, *args, 1, **kw)
    assert torch.equal(Fk, Fp)
    assert not torch.equal(Fk.cpu(), torch.from_numpy(F))


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [10, 12])
@pytest.mark.parametrize("mi_rows,mi_cols", [(8, 8), (135, 240)])
def test_kernel_matches_plain_on_card_high_bitdepth(mi_rows, mi_cols, bd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(bd * 7 + mi_cols)
    F, _, _, _, lfm, thr_t = _inputs(rng, mi_rows, mi_cols, bd)
    _kernel_vs_plain(F, lfm, thr_t, mi_rows, mi_cols, bd)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_444_chroma():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(4444)
    C, _, _, lfm, thr_t = _inputs_444_chroma(rng, 15, 23, 10)
    _kernel_vs_plain(C, lfm, thr_t, 15, 23, 10)


@pytest.mark.cuda
def test_kernel_repeated_runs_and_workspace_reuse_on_card(monkeypatch):
    """Ten runs of one 1920x1088 input, back to back on one stream: a race
    between superblocks would show as a run that differs.  Then two calls
    in a row on one stream share one workspace, left full of stale
    values: each call's reset must make both right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1010)
    kw = dict(mi_rows=135, mi_cols=240, bd=10)
    F, _, _, _, lfm, thr_t = _inputs(rng, 135, 240, 10)
    args = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr_t).to(dev))
    Fd = torch.from_numpy(F).to(dev)
    want = LF.lf_frame_plain(Fd.clone(), *args, 1, **kw)
    outs = [LF.lf_frame(Fd.clone(), *args, 1, **kw) for _ in range(10)]
    for out in outs:
        assert torch.equal(out, want)

    F2, _, _, _, lfm2, thr2 = _inputs(rng, 135, 240, 10)
    args2 = (torch.from_numpy(lfm2).to(dev), torch.from_numpy(thr2).to(dev))
    want2 = LF.lf_frame_plain(torch.from_numpy(F2).to(dev), *args2, 1, **kw)
    ws = torch.full((1 + F.shape[1] // 64,), 1 << 30, dtype=torch.int32,
                    device=dev)
    monkeypatch.setattr(LF, "workspace", lambda F: ws)
    a = LF.lf_frame(Fd.clone(), *args, 1, **kw)
    b = LF.lf_frame(torch.from_numpy(F2).to(dev), *args2, 1, **kw)
    assert torch.equal(a, want) and torch.equal(b, want2)
