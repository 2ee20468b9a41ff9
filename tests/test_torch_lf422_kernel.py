"""The port's chroma tile loop filter route for 4:2:2 and 4:4:0
(cuda_vp9_torch/ops/cuda/lf422.py).

`lf_chroma_tiles` filters both chroma planes of a 4:2:2 or 4:4:0 frame in
place: on the CPU through its plain twin (`ops/device/lf_wave.
lf_plane_tiles`, both planes in one stacked call), on the card through
the kernel `vp9_lf_plane_tiles` of `csrc/loopfilter.cu` (templated on the
tile: 64 x 32 pixels at 4:2:2, 32 x 64 at 4:4:0).

  * on the CPU: a CPU frame takes the plain twin (its counter moves, the
    kernel's does not), `lf_on = 0` is the identity, and the in-place call
    on the strided F[1:, :ha >> ss_y, :wa >> ss_x] views equals what
    `lf_plane_tiles` returns for each plane, at 4:2:2 and at 4:4:0; other
    subsamplings and maps of the wrong shape are refused;
  * on the card (marked `cuda`; skips without a device), at 4:2:2 and at
    4:4:0: the kernel against `lf_plane_tiles` at bit depths 8, 10 and 12
    on p1_04's (or p1_05's) 176x144 frame, on a ragged canvas and on the
    1920x1088 frame (chroma 1088x960 or 544x1920), on a single tile row
    and a single tile column, with every edge bit set in every cell and
    with none, ten runs of one input, and `lf_on = 0`.

This file imports no JAX and nothing of `cuda_vp9_tpu`, so on the card's
machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_lf422_kernel.py`.  Inputs are seeded: 8x8 blocks of
random level and noise amplitude (scaled to the bit depth), so every
filter width engages, and edge masks as test_pallas_lf builds them (no
edge on the plane's top and left borders), in the visible cells only, as
the packer writes them.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.cuda import lf422 as L4
from cuda_vp9_torch.ops.cuda import loopfilter as LF
from cuda_vp9_torch.ops.device.lf_wave import lf_plane_tiles
from cuda_vp9_torch.ops.ref.loopfilter import make_thresholds

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores.
torch.set_num_threads(1)

# mi grids: the 176x144 frame of p1_04 and p1_05 (a 192x192 canvas), a
# ragged canvas, 1920x1088 (chroma 1088x960 at 4:2:2, 544x1920 at 4:4:0),
# one tile row (a 64x640 canvas) and one tile column (640x64)
P1_04, RAGGED, HD = (18, 22), (13, 27), (135, 240)
ROW, COLUMN = (8, 80), (80, 8)
S422, S440 = (1, 0), (0, 1)


def _inputs(rng, mi_rows, mi_cols, bd, ss=S422):
    """(F [3, ha, wa] int32, maps: vbits, hbits, mb, lm, hv int16
    [ha >> ss_y >> 3, wa >> ss_x >> 3]) for a frame of mi_rows x mi_cols
    with chroma subsampling ss.  Luma is left zero: the route never
    touches it."""
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    # visible chroma cells
    R, C = (mi_rows + ss[1]) >> ss[1], (mi_cols + ss[0]) >> ss[0]
    s = bd - 8
    F = np.zeros((3, ha, wa), np.int32)
    for p in (1, 2):
        lvl = rng.integers(0, 256 << s, (R, C))
        amp = rng.choice([1, 3, 9, 40], (R, C)) << s
        noise = rng.integers(-64 << s, (64 << s) + 1, (8 * R, 8 * C)) \
            % np.repeat(np.repeat(amp, 8, 0), 8, 1)
        F[p, :8 * R, :8 * C] = np.clip(
            np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0, (1 << bd) - 1)

    def bits(top):
        kind = rng.integers(0, 4, (R, C))
        m16, m8, m4 = kind == 1, kind == 2, kind == 3
        m4i = (rng.random((R, C)) < 0.4) & ~m16
        for m in (m16, m8, m4):
            if top:
                m[0, :] = False
            else:
                m[:, 0] = False
        return m16 | m8 << 1 | m4 << 2 | m4i << 3

    tabs = make_thresholds(int(rng.integers(0, 8)))
    lv = rng.integers(0, 64, (R, C))
    maps = []
    for v in (bits(False), bits(True), *(t[lv] for t in tabs)):
        m = np.zeros((ha >> ss[1] >> 3, wa >> ss[0] >> 3), np.int16)
        m[:R, :C] = v
        maps.append(m)
    return F, maps


def _chroma(F, ss):
    """The chroma planes' region [ha >> ss_y, wa >> ss_x]."""
    return np.s_[:F.shape[1] >> ss[1], :F.shape[2] >> ss[0]]


def _plain_planes(F, maps, bd, ss=S422):
    """What lf_plane_tiles returns for each chroma plane of F."""
    gx, gy = L4.TILES[ss]
    m32 = [torch.from_numpy(m.astype(np.int32)) for m in maps]
    return [lf_plane_tiles(torch.from_numpy(F[p][_chroma(F, ss)].copy()),
                           *m32, 1, gx=gx, gy=gy, bd=bd).numpy()
            for p in (1, 2)]


def _outside(got, F, ss):
    """Luma and the chroma planes outside their region are untouched."""
    keep = np.ones(F.shape[1:], bool)
    keep[_chroma(F, ss)] = False
    return np.array_equal(got[0], F[0]) and all(
        np.array_equal(got[p][keep], F[p][keep]) for p in (1, 2))


def test_cpu_frame_takes_the_plain_twin():
    F, maps = _inputs(np.random.default_rng(1), 8, 16, 8)
    counts = (L4.launches, L4.plain_calls, LF.launches, LF.plain_calls)
    Ft = torch.from_numpy(F.copy())
    L4.lf_chroma_tiles(Ft, *map(torch.from_numpy, maps), 0, bd=8, ss=S422)
    assert np.array_equal(Ft.numpy(), F)
    L4.lf_chroma_tiles(Ft, *map(torch.from_numpy, maps), 1, bd=8, ss=S422)
    assert not np.array_equal(Ft.numpy(), F)
    assert (L4.launches, L4.plain_calls, LF.launches, LF.plain_calls) == (
        counts[0], counts[1] + 2, counts[2], counts[3])


def test_in_place_call_matches_plain_planes():
    """The route writes each plane through the strided F[p, :, :wa/2]
    view: the result equals lf_plane_tiles on a copy of the plane, and
    the luma plane and the right halves stay as they were."""
    F, maps = _inputs(np.random.default_rng(2), *RAGGED, 10)
    Ft = torch.from_numpy(F.copy())
    L4.lf_chroma_tiles(Ft, *map(torch.from_numpy, maps), 1, bd=10, ss=S422)
    got, wc = Ft.numpy(), F.shape[2] // 2
    for p, want in zip((1, 2), _plain_planes(F, maps, 10)):
        assert (want != F[p, :, :wc]).any()
        assert np.array_equal(got[p, :, :wc], want)
        assert np.array_equal(got[p, :, wc:], F[p, :, wc:])
    assert np.array_equal(got[0], F[0])


@pytest.mark.parametrize("mi", [P1_04, RAGGED, ROW])
def test_440_in_place_call_matches_plain_planes(mi):
    """The same at 4:4:0, through the F[p, :ha/2] views (tiles of 32 x 64):
    each plane equals lf_plane_tiles at gx = 8, gy = 4 on a copy, and the
    bottom halves and luma stay as they were."""
    F, maps = _inputs(np.random.default_rng(20 + mi[0]), *mi, 10, S440)
    Ft = torch.from_numpy(F.copy())
    plain = L4.plain_calls
    L4.lf_chroma_tiles(Ft, *map(torch.from_numpy, maps), 1, bd=10, ss=S440)
    assert L4.plain_calls == plain + 1
    got = Ft.numpy()
    for p, want in zip((1, 2), _plain_planes(F, maps, 10, S440)):
        assert (want != F[p][_chroma(F, S440)]).any()
        assert np.array_equal(got[p][_chroma(F, S440)], want)
    assert _outside(got, F, S440)


def test_other_subsamplings_and_map_shapes_are_refused():
    F, maps = _inputs(np.random.default_rng(4), 8, 16, 8, S440)
    t = [torch.from_numpy(m) for m in maps]
    Ft = torch.from_numpy(F)
    for ss in ((1, 1), (0, 0)):
        with pytest.raises(ValueError, match="subsampling"):
            L4.lf_chroma_tiles(Ft, *t, 1, bd=8, ss=ss)
    with pytest.raises(ValueError, match="map"):
        L4.lf_chroma_tiles(Ft, *t, 1, bd=8, ss=S422)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel(F, maps, bd, dev, lf_on=1, ss=S422):
    Fk = torch.from_numpy(F).to(dev)
    L4.lf_chroma_tiles(Fk, *(torch.from_numpy(m).to(dev) for m in maps),
                       lf_on, bd=bd, ss=ss)
    return Fk.cpu().numpy()


SS = pytest.mark.parametrize("ss", [S422, S440], ids=["422", "440"])


@pytest.mark.cuda
@SS
@pytest.mark.parametrize("bd,mi", [(8, P1_04), (10, P1_04), (12, P1_04),
                                   (8, RAGGED), (10, RAGGED), (12, RAGGED),
                                   (10, HD), (8, HD), (12, HD), (10, ROW),
                                   (12, COLUMN)])
def test_kernel_matches_plain_on_card(bd, mi, ss):
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(bd * 1000 + mi[1]), *mi, bd, ss)
    launches, plain = L4.launches, L4.plain_calls
    by_format = L4.format_launches[ss]
    got = _kernel(F, maps, bd, dev, ss=ss)
    assert (L4.launches, L4.plain_calls) == (launches + 1, plain)
    assert L4.format_launches[ss] == by_format + 1
    for p, want in zip((1, 2), _plain_planes(F, maps, bd, ss)):
        assert (want != F[p][_chroma(F, ss)]).any()
        assert np.array_equal(got[p][_chroma(F, ss)], want)
    assert _outside(got, F, ss)


@pytest.mark.cuda
@SS
@pytest.mark.parametrize("bits", [15, 0])
def test_kernel_every_or_no_edge_on_card(bits, ss):
    """Every edge bit set in every cell of both bit maps (the planes'
    borders included: the kernel reads 0 beyond them, as the twin's apron
    does), and none: the planes come back untouched."""
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(40 + bits), 24, 40, 10, ss)
    maps[0][:] = maps[1][:] = bits
    got = _kernel(F, maps, 10, dev, ss=ss)
    for p, want in zip((1, 2), _plain_planes(F, maps, 10, ss)):
        assert (want != F[p][_chroma(F, ss)]).any() == bool(bits)
        assert np.array_equal(got[p][_chroma(F, ss)], want)
    assert _outside(got, F, ss)


@pytest.mark.cuda
@SS
def test_kernel_repeated_runs_agree_on_card(ss):
    """Ten runs of one input, back to back on one stream: a race between
    tiles would show as a run that differs."""
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(7), 45, 80, 10, ss)
    want = _plain_planes(F, maps, 10, ss)
    md = [torch.from_numpy(m).to(dev) for m in maps]
    Fd = torch.from_numpy(F).to(dev)
    outs = [L4.lf_chroma_tiles(Fd.clone(), *md, 1, bd=10, ss=ss)
            for _ in range(10)]
    for out in outs:
        out = out.cpu().numpy()
        assert np.array_equal(out[1][_chroma(F, ss)], want[0])
        assert np.array_equal(out[2][_chroma(F, ss)], want[1])


@pytest.mark.cuda
@SS
def test_lf_off_is_identity_on_card(ss):
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(3), *P1_04, 8, ss)
    launches = L4.launches
    assert np.array_equal(_kernel(F, maps, 8, dev, lf_on=0, ss=ss), F)
    assert L4.launches == launches
