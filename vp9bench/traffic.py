"""The one traffic generator: a cell's playlists from its traffic file and
the run's seed.

A traffic file (`vp9bench/traffic/<name>.json`) holds parameters only:

  driver        "batched" (BatchedTorchDecoder, one packet a slot a round)
                or "codec_api" (vpx_codec_decode, one packet at a time);
  slots         streams decoded side by side (1 for "codec_api");
  stagger       "even": slot k plays frames 1 .. 1 + k * F // slots of its
                first stream (F its length; the lengths dealt to the slots
                in an order drawn from the seed) and then whole streams, so
                that keyframes arrive spread over the rounds; "none": every
                slot plays whole streams from round 0;
  drain_every   rounds between two drains of a batched decoder;
  read_lag      frames between a packet's decode and the read of its
                frame's planes ("codec_api");
  warmup_frames packets of each stream decoded before the window, for
                every shape the cell uses; "batched" decodes
                `warmup_rounds` rounds of its own playlists instead.

Each slot's playlist is an endless cycle through every stream of the
configuration, in an order drawn from the seed (a permutation per slot),
each stream from its keyframe.  Every seed gives the same set of lengths
and the same streams, in another order, so seeds change the order of the
work and not its amount.  The seed may be any whole number (it is taken
modulo 2**64 and split into words for numpy).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List, NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent


class Item(NamedTuple):
    """One packet of a playlist: stream index, packet index in the stream,
    and the shown frame it yields (its index in the stream's MD5s)."""
    stream: int
    packet: int
    shown: int


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _rng(seed: int, slot: int) -> np.random.Generator:
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, slot])


def playlists(traffic: dict, streams, seed: int) -> List[Iterator[Item]]:
    """One endless packet iterator per slot."""
    slots = traffic["slots"]
    stagger = traffic.get("stagger", "none")
    if stagger not in ("none", "even"):
        raise ValueError(f"unknown stagger {stagger!r}")
    ranks = _rng(seed, slots).permutation(slots)
    out = []
    for s in range(slots):
        order = [int(i) for i in _rng(seed, s).permutation(len(streams))]
        first = None
        if stagger == "even":
            n = len(streams[order[0]].packets)
            first = 1 + int(ranks[s]) * n // slots
        out.append(_cycle(streams, order, first))
    return out


def _cycle(streams, order, first) -> Iterator[Item]:
    limit = first
    while True:
        for k in order:
            st = streams[k]
            n = len(st.packets) if limit is None else limit
            limit = None
            for p in range(n):
                yield Item(k, p, st.packet_shown[p])


def warmup_items(traffic: dict, streams, seed: int) -> List[Item]:
    """The packets a "codec_api" cell decodes before its window: the first
    `warmup_frames` of each stream, in the slot's order."""
    order = [int(i) for i in _rng(seed, 0).permutation(len(streams))]
    k = traffic["warmup_frames"]
    return [Item(i, p, streams[i].packet_shown[p])
            for i in order for p in range(min(k, len(streams[i].packets)))]
