"""The port's 4:2:2 chroma loop filter route (cuda_vp9_torch/ops/cuda/lf422.py).

`lf_chroma_422` filters both chroma planes of a 4:2:2 frame in place: on
the CPU through its plain twin (`ops/device/lf_wave.lf_plane_tiles`, one
plane at a time), on the card through the kernel `vp9_lf_plane_tiles` of
`csrc/loopfilter.cu`.

  * on the CPU: a CPU frame takes the plain twin (its counter moves, the
    kernel's does not), `lf_on = 0` is the identity, and the in-place call
    on the strided F[p, :, :wa/2] views equals what `lf_plane_tiles`
    returns for each plane;
  * on the card (marked `cuda`; skips without a device): the kernel
    against `lf_plane_tiles` at bit depths 8, 10 and 12 on p1_04's chroma
    (144x88 in a 192x96 canvas), on a ragged canvas and on 1088x960
    planes, on a single tile row (64x320) and a single tile column
    (640x32), with every edge bit set in every cell and with none, ten
    runs of one input, and `lf_on = 0`.

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

# mi grids: p1_04's 176x144 (chroma 88x144 in a 96x192 canvas), a ragged
# canvas, 1920x1088 (chroma 960x1088), one tile row (chroma 320x64) and
# one tile column (chroma 32x640)
P1_04, RAGGED, HD = (18, 22), (13, 27), (135, 240)
ROW, COLUMN = (8, 80), (80, 8)


def _inputs(rng, mi_rows, mi_cols, bd):
    """(F [3, ha, wa] int32, maps: vbits, hbits, mb, lm, hv int16
    [ha/8, wa/16]) for a 4:2:2 frame of mi_rows x mi_cols.  Luma is left
    zero: the route never touches it."""
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    R, C = mi_rows, (mi_cols + 1) // 2          # visible chroma cells
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
        m = np.zeros((ha // 8, wa // 16), np.int16)
        m[:R, :C] = v
        maps.append(m)
    return F, maps


def _plain_planes(F, maps, bd):
    """What lf_plane_tiles returns for each chroma plane of F."""
    wc = F.shape[2] // 2
    m32 = [torch.from_numpy(m.astype(np.int32)) for m in maps]
    return [lf_plane_tiles(torch.from_numpy(F[p, :, :wc].copy()), *m32, 1,
                           gx=4, gy=8, bd=bd).numpy() for p in (1, 2)]


def test_cpu_frame_takes_the_plain_twin():
    F, maps = _inputs(np.random.default_rng(1), 8, 16, 8)
    counts = (L4.launches, L4.plain_calls, LF.launches, LF.plain_calls)
    Ft = torch.from_numpy(F.copy())
    L4.lf_chroma_422(Ft, *map(torch.from_numpy, maps), 0, bd=8)
    assert np.array_equal(Ft.numpy(), F)
    L4.lf_chroma_422(Ft, *map(torch.from_numpy, maps), 1, bd=8)
    assert not np.array_equal(Ft.numpy(), F)
    assert (L4.launches, L4.plain_calls, LF.launches, LF.plain_calls) == (
        counts[0], counts[1] + 2, counts[2], counts[3])


def test_in_place_call_matches_plain_planes():
    """The route writes each plane through the strided F[p, :, :wa/2]
    view: the result equals lf_plane_tiles on a copy of the plane, and
    the luma plane and the right halves stay as they were."""
    F, maps = _inputs(np.random.default_rng(2), *RAGGED, 10)
    Ft = torch.from_numpy(F.copy())
    L4.lf_chroma_422(Ft, *map(torch.from_numpy, maps), 1, bd=10)
    got, wc = Ft.numpy(), F.shape[2] // 2
    for p, want in zip((1, 2), _plain_planes(F, maps, 10)):
        assert (want != F[p, :, :wc]).any()
        assert np.array_equal(got[p, :, :wc], want)
        assert np.array_equal(got[p, :, wc:], F[p, :, wc:])
    assert np.array_equal(got[0], F[0])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel(F, maps, bd, dev, lf_on=1):
    Fk = torch.from_numpy(F).to(dev)
    L4.lf_chroma_422(Fk, *(torch.from_numpy(m).to(dev) for m in maps),
                     lf_on, bd=bd)
    return Fk.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("bd,mi", [(8, P1_04), (10, P1_04), (12, P1_04),
                                   (8, RAGGED), (10, RAGGED), (12, RAGGED),
                                   (10, HD), (8, HD), (12, HD), (10, ROW),
                                   (12, COLUMN)])
def test_kernel_matches_plain_on_card(bd, mi):
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(bd * 1000 + mi[1]), *mi, bd)
    launches, plain = L4.launches, L4.plain_calls
    got = _kernel(F, maps, bd, dev)
    assert (L4.launches, L4.plain_calls) == (launches + 1, plain)
    wc = F.shape[2] // 2
    for p, want in zip((1, 2), _plain_planes(F, maps, bd)):
        assert (want != F[p, :, :wc]).any()
        assert np.array_equal(got[p, :, :wc], want)
        assert np.array_equal(got[p, :, wc:], F[p, :, wc:])
    assert np.array_equal(got[0], F[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [15, 0])
def test_kernel_every_or_no_edge_on_card(bits):
    """Every edge bit set in every cell of both bit maps (the planes'
    borders included: the kernel reads 0 beyond them, as the twin's apron
    does), and none: the planes come back untouched."""
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(40 + bits), 24, 40, 10)
    maps[0][:] = maps[1][:] = bits
    got = _kernel(F, maps, 10, dev)
    wc = F.shape[2] // 2
    for p, want in zip((1, 2), _plain_planes(F, maps, 10)):
        assert (want != F[p, :, :wc]).any() == bool(bits)
        assert np.array_equal(got[p, :, :wc], want)
    assert np.array_equal(got[0], F[0])


@pytest.mark.cuda
def test_kernel_repeated_runs_agree_on_card():
    """Ten runs of one input, back to back on one stream: a race between
    tiles would show as a run that differs."""
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(7), 45, 80, 10)
    wc = F.shape[2] // 2
    want = _plain_planes(F, maps, 10)
    md = [torch.from_numpy(m).to(dev) for m in maps]
    Fd = torch.from_numpy(F).to(dev)
    outs = [L4.lf_chroma_422(Fd.clone(), *md, 1, bd=10) for _ in range(10)]
    for out in outs:
        out = out.cpu().numpy()
        assert np.array_equal(out[1, :, :wc], want[0])
        assert np.array_equal(out[2, :, :wc], want[1])


@pytest.mark.cuda
def test_lf_off_is_identity_on_card():
    dev = _cuda()
    F, maps = _inputs(np.random.default_rng(3), *P1_04, 8)
    launches = L4.launches
    assert np.array_equal(_kernel(F, maps, 8, dev, lf_on=0), F)
    assert L4.launches == launches
