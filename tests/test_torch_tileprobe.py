"""The port's shared-memory tile probe (cuda_vp9_torch/ops/cuda/tileprobe.py).

`tile_probe_plain` against the NumPy reference of the Pallas probe
(`tools/profiling/pallas_probe.py`, its `main`, copied below line for
line), on the probe's own inputs and on seeded random frames, masks and
waves; `tools/tile_probe.py` end to end on the CPU; the kernel's table
(`build_table`: ticket order, the entries each entry waits for, the split
into launches) against a brute-force rule, and any order of tile loads
and stores that keeps its waits against the reference; and the CUDA
kernel against `tile_probe_plain` on the card (marked `cuda`; skips
without a device), on the probe's waves, seeded random waves and the
anti-diagonal waves of a 1088x1920 frame (three launches).  The file imports no JAX, so on a machine without it the kernel
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


def _wide_inputs(rng, sb_rows=17, sb_cols=30):
    """A 1088x1920 frame of 17x30 superblocks plus the 8-pixel apron, its
    masks, and waves of up to MAXW entries cut from the anti-diagonals
    c + 2r of the superblock order, in order."""
    H, W = 64 * sb_rows + 8, 64 * sb_cols + 8
    frame = rng.integers(-2**20, 2**20, (H, W)).astype(np.int32)
    masks = rng.integers(0, 64, (8 * sb_rows, 128)).astype(np.int32)
    waves = []
    for s in range(sb_cols + 2 * (sb_rows - 1)):
        diag = [(r + 1, s - 2 * r + 1) for r in range(sb_rows)
                if 0 <= s - 2 * r < sb_cols]
        for k in range(0, len(diag), MAXW):
            wave = diag[k:k + MAXW]
            waves.append(wave + [(0, 0)] * (MAXW - len(wave)))
    return frame, masks, np.asarray(waves, np.int32)


def _waves(coords):
    return [[(r - 1, c - 1) for r, c in wave if r > 0]
            for wave in coords.reshape(-1, MAXW, 2).tolist()]


def _meets(a, b):
    """Whether the tiles of superblocks a and b share a pixel."""
    return all(64 * p < 64 * q + TS and 64 * q < 64 * p + TS
               for p, q in zip(a, b))


def _table_cases():
    rng = np.random.default_rng(970)
    yield "probe", tool.probe_inputs()[2]
    yield "empty", _wide_inputs(rng, 2, 3)[2][:0]
    yield "1088x1920", _wide_inputs(np.random.default_rng(971))[2]
    for seed in range(3):
        yield f"random{seed}", _random_inputs(
            np.random.default_rng(980 + seed), 3, 5, 24)[2]


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
        TP.build_table(_waves(coords))
    with pytest.raises(ValueError, match="changes pixels inside"):
        TP.tile_probe(torch.from_numpy(frame),
                      torch.from_numpy(coords.reshape(-1)),
                      torch.from_numpy(masks))


@pytest.mark.parametrize("case", list(_table_cases()),
                         ids=[c[0] for c in _table_cases()])
def test_table_against_brute_force(case):
    """build_table in ticket order: the entries in wave order; each waits
    for at most 9 entries, each an earlier-wave entry whose tile meets its
    own and the latest such at its superblock; through those waits it
    follows every earlier-wave entry whose tile meets its own (the
    brute-force rule); and each launch's rows carry the waits within that
    launch, numbered from the launch's first entry."""
    _, coords = case
    waves = _waves(coords)
    t = TP.build_table(waves)
    assert t.entries == [e for w in waves for e in w]
    wave_of = [k for k, w in enumerate(waves) for _ in w]
    after = []                  # entries each entry follows, transitively
    for i, (e, d) in enumerate(zip(t.entries, t.deps)):
        brute = {j for j in range(i) if wave_of[j] < wave_of[i]
                 and _meets(t.entries[j], e)}
        assert len(d) <= TP.MAX_DEPS and d == sorted(set(d))
        assert set(d) <= brute
        for j in d:
            assert not any(t.entries[k] == t.entries[j]
                           for k in range(j + 1, i)
                           if wave_of[k] < wave_of[i])
        after.append(set(d).union(*(after[j] for j in d)))
        assert brute <= after[i]
    assert list(t.sizes) == [min(TP.MAX_ENTRIES, len(t.entries) - s)
                             for s in range(0, len(t.entries),
                                            TP.MAX_ENTRIES)]
    assert len(t.rows) == 12 * len(t.entries)
    for i, d in enumerate(t.deps):
        start = i - i % TP.MAX_ENTRIES
        row = list(t.rows[12 * i:12 * i + 12])
        local = [j - start for j in d if j >= start]
        assert row == [*t.entries[i], len(local), *local,
                       *[0] * (TP.MAX_DEPS - len(local))]


def test_table_splits_past_max_entries():
    """The 1088x1920 anti-diagonal waves (510 entries) take three launches;
    an entry of the second launch that waits on the first waits on
    nothing there (the launches run in order on the stream)."""
    waves = _waves(_wide_inputs(np.random.default_rng(972))[2])
    t = TP.build_table(waves)
    assert len(t.entries) == 510 and list(t.sizes) == [224, 224, 62]
    i = TP.MAX_ENTRIES
    assert t.deps[i] and all(j < i for j in t.deps[i])
    assert t.rows[12 * i + 2] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_any_order_that_keeps_the_waits_gives_the_reference(seed):
    """The kernel's freedom, simulated: each entry loads its tile (and
    computes it) at any moment after the entries its row waits for have
    stored theirs, and stores it at any later moment, every launch after
    the one before it; entries of one wave share apron pixels.  Every such
    order gives the probe's reference."""
    rng = np.random.default_rng(990 + seed)
    frame, masks, coords = _random_inputs(rng, 3, 5, 24)
    t = TP.build_table(_waves(coords))
    out, stored, start = frame.copy(), set(), 0
    for size in t.sizes:
        todo, held = list(range(start, start + size)), {}
        while todo or held:
            ready = [i for i in todo if all(
                start + d in stored for d in
                t.rows[12 * i + 3:12 * i + 3 + t.rows[12 * i + 2]])]
            pick = int(rng.integers(len(ready) + len(held)))
            if pick < len(ready):
                i = ready[pick]
                todo.remove(i)
                r, c = t.entries[i]
                tile = out[64 * r:64 * r + TS, 64 * c:64 * c + TS].copy()
                tile[8:TS, 8] = (tile[8:TS, 8] + tile[8:TS, 9]
                                 + 2 * np.repeat(masks[8 * r, :8], 8))
                held[i] = tile
            else:
                i = list(held)[pick - len(ready)]
                r, c = t.entries[i]
                out[64 * r:64 * r + TS, 64 * c:64 * c + TS] = held.pop(i)
                stored.add(i)
        start += size
    assert np.array_equal(out, _reference(frame, masks,
                                          coords.reshape(-1, MAXW, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 0, 1, "1088x1920"])
def test_kernel_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if seed is None:
        frame, masks, coords = tool.probe_inputs()
        coords = coords.reshape(-1, MAXW, 2)
    elif seed == "1088x1920":
        frame, masks, coords = _wide_inputs(np.random.default_rng(973))
    else:
        frame, masks, coords = _random_inputs(
            np.random.default_rng(950 + seed), 8, 12, 10)
    dev = torch.device("cuda")
    f = torch.from_numpy(frame).to(dev)
    launches = TP.launches
    TP.tile_probe(f, torch.from_numpy(coords.reshape(-1)),
                  torch.from_numpy(masks).to(dev))
    # one launch for every MAX_ENTRIES entries: one for the probe's waves
    n = int((coords[:, :, 0] > 0).sum())
    assert TP.launches == launches + -(-n // TP.MAX_ENTRIES)
    assert seed is not None or TP.launches == launches + 1
    assert np.array_equal(f.cpu().numpy(), _plain(frame, masks, coords, dev))
    assert np.array_equal(f.cpu().numpy(), _reference(frame, masks, coords))
