"""The seed-to-playlist generator: deterministic, distinct across seeds,
the same work for every seed."""

from __future__ import annotations

import itertools
import json
from collections import Counter
from pathlib import Path

import pytest

from vp9bench import corpus
from vp9bench.traffic import load_traffic, playlists, warmup_items

BENCH = Path(__file__).resolve().parents[1]
CFG = {n: json.loads((BENCH / "configs" / f"{n}.json").read_text())
       for n in ("vp9_360p_vod", "vp9_2160p_vod")}
SEEDS = [0, 1, 2, 17, 123456789, 2 ** 31 - 1, 2 ** 31 + 11, 2 ** 33 + 5,
         4_000_000_007, 9_999_999_999, -5, 2 ** 63 + 1]
CELLS = [("vp9_360p_vod", "batch16_staggered"),
         ("vp9_2160p_vod", "stream1_lag16")]


def _take(traffic, streams, seed, n):
    return [list(itertools.islice(it, n))
            for it in playlists(traffic, streams, seed)]


@pytest.fixture(scope="module")
def streams():
    return {n: corpus.load(c) for n, c in CFG.items()}


@pytest.mark.parametrize("cfg,traffic", CELLS)
def test_deterministic(streams, cfg, traffic):
    t = load_traffic(traffic)
    for seed in SEEDS[:4]:
        assert _take(t, streams[cfg], seed, 300) == \
            _take(t, streams[cfg], seed, 300)


def test_distinct_across_seeds(streams):
    t = load_traffic("batch16_staggered")
    st = streams["vp9_360p_vod"]
    runs = {json.dumps(_take(t, st, seed, 300)) for seed in SEEDS}
    assert len(runs) == len(SEEDS)


def test_codec_api_orders_across_seeds(streams):
    """One stream of three streams: the seed sets their order, of which
    there are 3! = 6; a dozen seeds draw most of them."""
    t = load_traffic("stream1_lag16")
    st = streams["vp9_2160p_vod"]
    orders = {tuple(it.stream for it in _take(t, st, seed, 192)[0][::64])
              for seed in SEEDS}
    assert all(sorted(o) == [0, 1, 2] for o in orders)
    assert len(orders) >= 4


def test_same_work_every_seed(streams):
    """Every seed staggers the slots by the same set of first lengths and
    plays each stream equally often over a whole cycle."""
    t = load_traffic("batch16_staggered")
    st = streams["vp9_360p_vod"]
    firsts = set()
    for seed in SEEDS:
        lists = _take(t, st, seed, 120 * 9)
        lengths = []
        for items in lists:
            assert items[0].packet == 0                 # starts at a keyframe
            k = next(i for i, it in enumerate(items[1:], 1)
                     if it.packet == 0)
            lengths.append(k)
            # then whole streams, every one once a cycle
            cycle = items[k:k + 120 * 8]
            assert Counter(it.stream for it in cycle) == \
                Counter({i: 120 for i in range(8)})
        firsts.add(tuple(sorted(lengths)))
    assert len(firsts) == 1
    (lengths,) = firsts
    assert len(set(lengths)) == 16 and min(lengths) >= 1


def test_codec_api_playlist(streams):
    t = load_traffic("stream1_lag16")
    st = streams["vp9_2160p_vod"]
    (items,) = _take(t, st, 99, 64 * 6)
    order = [items[i].stream for i in range(0, 64 * 3, 64)]
    assert sorted(order) == [0, 1, 2]
    assert [it.packet for it in items[:64]] == list(range(64))
    assert items[64 * 3:] == items[:64 * 3]             # looped
    warm = warmup_items(t, st, 99)
    assert len(warm) == 3 * t["warmup_frames"]
    assert [w.stream for w in warm[::t["warmup_frames"]]] == order
