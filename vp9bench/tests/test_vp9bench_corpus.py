"""The committed corpus: what each configuration asks for, one shown frame
a packet, facts and MD5s that agree, and at most 16 MB."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from vp9bench import corpus

BENCH = Path(__file__).resolve().parents[1]
NAMES = ["vp9_360p_vod", "vp9_2160p_vod"]


@pytest.mark.parametrize("name", NAMES)
def test_streams(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    streams = corpus.load(cfg)
    assert len(streams) == cfg["streams"]
    for st in streams:
        assert len(st.md5) == len(st.packets) == cfg["frames_per_stream"]
        frames = st.facts["frames"]
        assert frames[0]["type"] == "key"
        assert all(f["type"] != "key" for f in frames[1:])  # one GOP
        hidden = [f for f in frames if not f["shown"]]
        assert hidden, "alt-ref frames expected"
        kbps = 8 * sum(len(p) for p in st.packets) * cfg["fps"] \
            / len(st.packets) / 1000
        assert cfg["min_bitrate_kbps"] <= kbps <= cfg["max_bitrate_kbps"]


def test_size():
    total = sum(p.stat().st_size for p in (BENCH / "corpus").rglob("*")
                if p.is_file() and p.suffix in (".ivf", ".md5", ".json"))
    assert total <= 16 * 10 ** 6
