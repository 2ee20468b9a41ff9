"""The port's shared-memory tile probe (cuda_vp9_torch/ops/cuda/tileprobe.py).

`tile_probe_plain` against the NumPy reference of the Pallas probe
(`tools/profiling/pallas_probe.py`, its `main`, copied below line for
line), on the probe's own inputs and on seeded random frames, masks and
waves; `tools/tile_probe.py` end to end on the CPU; and the CUDA kernel
against `tile_probe_plain` on the card (marked `cuda`; skips without a
device).  The file imports no JAX, so on a machine without it the kernel
test runs with `python -m pytest --noconftest -m cuda
tests/test_torch_tileprobe.py`.  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.cuda import tileprobe as TP
from cuda_vp9_torch.tools import tile_probe as tool

MAXW = 4
TS = 72


def _reference(frame, masks, coords):
    """pallas_probe.py:124-139."""
    ref = frame.copy()
    for wv in range(coords.shape[0]):
        for n in range(MAXW):
            sbr, sbc = coords[wv, n] - 1
            if sbr < 0:
                continue
            tile = ref[sbr * 64:sbr * 64 + TS, sbc * 64:sbc * 64 + TS].copy()
            tileT = tile.T.copy()
            acc = np.zeros((64,), np.int64)
            for j in range(2):
                v = tileT[8 + j, 8:TS]
                m = np.repeat(masks[sbr * 8, :8], 8)
                acc = acc + v + m
            tileT[8, 8:TS] = acc
            ref[sbr * 64:sbr * 64 + TS, sbc * 64:sbc * 64 + TS] = tileT.T
    return ref


def _random_inputs(rng, sb_rows, sb_cols, n_waves):
    """A frame of sb_rows x sb_cols superblocks plus the 8-pixel apron,
    masks, and waves of distinct SBs on anti-diagonals c + 2r (so no
    entry writes into another's tile), pads mixed in."""
    H, W = 64 * sb_rows + 8, 64 * sb_cols + 8
    frame = rng.integers(-2**20, 2**20, (H, W)).astype(np.int32)
    masks = rng.integers(0, 64, (8 * sb_rows, 128)).astype(np.int32)
    coords = np.zeros((n_waves, MAXW, 2), np.int32)
    for w in range(n_waves):
        s = int(rng.integers(0, sb_cols + 2 * (sb_rows - 1)))
        sbs = [(r, s - 2 * r) for r in range(sb_rows)
               if 0 <= s - 2 * r < sb_cols][:MAXW]
        slots = rng.permutation(MAXW)[:len(sbs)]
        for (r, c), n in zip(sbs, slots):
            coords[w, n] = (r + 1, c + 1)
    return frame, masks, coords


def _plain(frame, masks, coords, dev="cpu"):
    f = torch.from_numpy(frame.copy()).to(dev)
    TP.tile_probe_plain(f, torch.from_numpy(coords.reshape(-1)),
                        torch.from_numpy(masks).to(dev))
    return f.cpu().numpy()


def test_plain_matches_probe_reference():
    frame, masks, coords = tool.probe_inputs()
    coords = coords.reshape(-1, MAXW, 2)
    want = _reference(frame, masks, coords)
    assert (want != frame).any()
    assert np.array_equal(_plain(frame, masks, coords), want)
    assert np.array_equal(tool.probe_reference(frame, masks, coords), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_probe_reference_random(seed):
    rng = np.random.default_rng(900 + seed)
    frame, masks, coords = _random_inputs(rng, 3, 5, 6)
    assert np.array_equal(_plain(frame, masks, coords),
                          _reference(frame, masks, coords))


def test_tool_runs_on_cpu_and_cpu_takes_plain():
    launches, plain = TP.launches, TP.plain_calls
    assert tool.run("cpu") == (0, None)
    assert (TP.launches, TP.plain_calls) == (launches, plain + 1)


def test_entries_past_the_frame_raise():
    frame, masks, coords = tool.probe_inputs()
    coords[0:2] = (4, 1)             # a tile at rows 192..264 of 200
    with pytest.raises(ValueError, match="reaches past"):
        TP.tile_probe(torch.from_numpy(frame), torch.from_numpy(coords),
                      torch.from_numpy(masks))


@pytest.mark.parametrize("wave", [[(1, 1), (2, 1)], [(2, 1), (1, 1)],
                                  [(2, 2), (2, 2)]])
def test_waves_whose_entries_change_each_others_tiles_raise(wave):
    """The kernel runs a wave's entries in parallel, so no entry may
    change a pixel inside another entry's tile: vertical neighbours (the
    upper one changes rows 8..71 of column 8, and the lower tile starts at
    row 64) and a repeated entry are refused; the probe's own waves, whose
    tiles share only unchanged apron pixels, pass."""
    frame, masks, coords = tool.probe_inputs()
    coords = coords.reshape(-1, MAXW, 2)
    coords[1, :] = 0
    coords[1, :len(wave)] = wave
    with pytest.raises(ValueError, match="changes pixels inside"):
        TP.tile_probe(torch.from_numpy(frame),
                      torch.from_numpy(coords.reshape(-1)),
                      torch.from_numpy(masks))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_kernel_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if seed is None:
        frame, masks, coords = tool.probe_inputs()
        coords = coords.reshape(-1, MAXW, 2)
    else:
        frame, masks, coords = _random_inputs(
            np.random.default_rng(950 + seed), 8, 12, 10)
    dev = torch.device("cuda")
    f = torch.from_numpy(frame).to(dev)
    launches = TP.launches
    TP.tile_probe(f, torch.from_numpy(coords.reshape(-1)),
                  torch.from_numpy(masks).to(dev))
    # one launch per wave with a valid entry
    assert TP.launches == launches + int((coords[:, :, 0] > 0).any(1).sum())
    assert np.array_equal(f.cpu().numpy(), _plain(frame, masks, coords, dev))
    assert np.array_equal(f.cpu().numpy(), _reference(frame, masks, coords))
