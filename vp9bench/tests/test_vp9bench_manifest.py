"""BENCHMARK.json against the contract the harness is built to: every name
found by file, every name and unit in its alphabet, every cell complete."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BM = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = BM["end_to_end"] + BM["per_layer"]


def test_top_level():
    assert set(BM) == KEYS["top"]
    assert 1 <= len(BM["paths"]) <= 16
    for p in BM["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(BM["command"]) <= 32
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("cfg", BM["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == KEYS["config"]
    assert NAME.match(cfg["name"]) and _one_line(cfg["source"])
    assert _one_line(cfg["why"]) and len(cfg["reduced"]) <= 16
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith(tuple(p + "/" for p in BM["paths"]))
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
    assert any(w["config"] == cfg["name"] for w in BM["workloads"])
    assert len({c["file"] for c in BM["configs"]}) == len(BM["configs"])


@pytest.mark.parametrize("wl", BM["workloads"], ids=lambda w: w["name"])
def test_workload(wl):
    assert set(wl) == KEYS["workload"]
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"])
    assert _one_line(wl["why"]) and wl["chips"] in (1, 4)
    assert wl["config"] in {c["name"] for c in BM["configs"]}
    assert (BENCH / "traffic" / f"{wl['traffic']}.json").is_file()
    mine = lambda m: wl["name"] in m.get("workloads", [wl["name"]])
    e2e = [m["name"] for m in BM["end_to_end"] if mine(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(mine(m) and m["moves"] in e2e for m in BM["per_layer"])


def test_cells_unique():
    names = [w["name"] for w in BM["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(names) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    kind = "end_to_end" if m in BM["end_to_end"] else "per_layer"
    assert set(m) - {"workloads"} == KEYS[kind]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BM["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if kind == "end_to_end":
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in BM["end_to_end"]}
    if "roofline" in m["name"]:
        assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_names_unique():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert len({c["name"] for c in BM["configs"]}) == len(BM["configs"])


def test_every_reader_loads():
    from vp9bench.metrics import reader
    for m in METRICS:
        assert callable(reader(m["name"]))
