"""The benchmark's corpus, as a run reads it.

`load(cfg)` reads the streams of a configuration from
`vp9bench/corpus/<name>/s<seed>.{ivf,md5,json}` (made by
`make_corpus.py`): their packets, their golden per-frame MD5s and their
per-frame facts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from ..ivf import read_ivf

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent


@dataclass
class Stream:
    """One corpus stream: its packets, the golden MD5 of each shown frame
    (in display order) and its facts.  `packet_frames[p]` lists the
    indices into `facts["frames"]` of packet p's frames, and
    `packet_shown[p]` the index of the shown frame it yields."""
    name: str
    width: int
    height: int
    packets: List[bytes]
    md5: List[str]
    facts: dict
    packet_frames: List[List[int]] = field(default_factory=list)
    packet_shown: List[int] = field(default_factory=list)


def load_stream(cfg: dict, seed: int) -> Stream:
    base = HERE / cfg["name"] / f"s{seed}"
    width, height, packets = read_ivf(str(base.with_suffix(".ivf")))
    md5 = [line.split()[0] for line in
           base.with_suffix(".md5").read_text().splitlines() if line]
    facts = json.loads(base.with_suffix(".json").read_text())
    st = Stream(f"{cfg['name']}/s{seed}", width, height, packets, md5, facts)
    st.packet_frames = [[] for _ in packets]
    for i, f in enumerate(facts["frames"]):
        st.packet_frames[f["packet"]].append(i)
    shown = 0
    for p, idx in enumerate(st.packet_frames):
        n = sum(facts["frames"][i]["shown"] for i in idx)
        if n != 1:
            raise ValueError(f"{st.name}: packet {p} shows {n} frames; the "
                             "traffic expects one a packet")
        st.packet_shown.append(shown)
        shown += 1
    if shown != len(md5) or (width, height) != (cfg["width"],
                                                cfg["height"]):
        raise ValueError(f"{st.name}: does not match its configuration "
                         "or its MD5s")
    return st


def load(cfg: dict) -> List[Stream]:
    """Every stream of the configuration, in content-seed order."""
    return [load_stream(cfg, seed) for seed in cfg["content_seeds"]]
