"""`correct` comes out false under the control and under every fault a cell
can have, and true for the program as it is: the harness's run (set-up,
window, delivery, reference) on the CPU, without its look for a chip, on
the tests' tiny corpus (`tiny.json`: two 96x64 streams of 10 frames with
alt-ref frames and the loop filter on).  The card's versions at the cells'
own sizes carry the `cuda` marker."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from vp9bench.reference import compare, passed
from vp9bench.run import Run, result_line, run_cell
from vp9bench.traffic import Item, load_traffic

HERE = Path(__file__).resolve().parent
TINY = json.loads((HERE / "tiny.json").read_text())
TRAFFIC = {
    "batched": dict(load_traffic("batch16_staggered"), slots=4,
                    warmup_rounds=2, drain_every=2),
    "codec_api": dict(load_traffic("stream1_lag16"), read_lag=3,
                      warmup_frames=2),
}
SEED = 2 ** 33 + 5
CASES = [("batched", f) for f in ("skip_loop_filter", "stale", "drop_half",
                                  "alter")] + \
        [("codec_api", f) for f in ("skip_loop_filter", "stale", "alter")]


@pytest.mark.parametrize("driver,fault", CASES,
                         ids=[f"{d}-{f}" for d, f in CASES])
def test_fault_fails_correct(driver, fault):
    run = run_cell(TINY, TRAFFIC[driver], SEED, 0.5, device="cpu",
                   fault=fault)
    assert run.checks["frames_compared"]["value"] >= 1
    assert not run.correct, run.checks


@pytest.mark.parametrize("driver", ["batched", "codec_api"])
def test_sound_run_is_correct(driver):
    run = run_cell(TINY, TRAFFIC[driver], SEED, 0.5, device="cpu")
    assert run.correct, run.checks
    assert run.frames_window >= 1
    assert run.checks["frames_on_host"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("count", ["frames_on_host", "plain_calls"])
def test_fallback_fails_correct(count):
    """A frame the host oracle made, or a plain twin's call, in the window
    fails `correct` although every MD5 matches."""
    item = Item(0, 0, 0)
    streams = [SimpleNamespace(md5=["ab"])]
    fallback = {"frames_on_host": 0, "plain_calls": 0}
    assert passed(compare([(item, "ab")], streams, 1, fallback))
    fallback[count] = 1
    checks = compare([(item, "ab")], streams, 1, fallback)
    assert checks[count] == {"value": 1, "limit": 0}
    assert not passed(checks)


def test_traced_run_reads_the_spans():
    run = run_cell(TINY, TRAFFIC["codec_api"], SEED + 1, 1.0, trace=True,
                   device="cpu")
    assert run.correct and run.trace is not None and run.trace.frames >= 1
    wl = {"chips": 1}
    names = ["parse_ms_per_frame", "pack_ms_per_frame", "glue_ms_per_frame",
             "upload_kib_per_frame", "device_idle_pct", "mc_roofline"]
    units = dict.fromkeys(names, "x")
    line = result_line(run, wl, names, units, True)
    got = line["metrics"]
    assert got["parse_ms_per_frame"]["value"] > 0
    assert got["upload_kib_per_frame"]["value"] > 0
    assert "mc_roofline" not in got          # no device trace on the CPU
    assert list(line)[-1] == "checks"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_result_line_lists_failures():
    run = Run(TINY, [], "cpu")
    run.checks = {"md5_mismatch": {"value": 2, "limit": 0},
                  "frames_missing": {"value": 1, "limit": 0},
                  "frames_compared": {"value": 9, "limit": 1}}
    run.due = 10
    line = result_line(run, {"chips": 1}, [], {}, False)
    assert line["failed"] == 3 and line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault",
                         [("sd.batch16", "skip_loop_filter"),
                          ("uhd.stream1", "skip_loop_filter")])
def test_control_on_card(cell, fault):
    """The control at the cell's own size on the card: a sound run is
    correct and the control is not."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vp9bench.run import manifest
    _, cfg, traffic, _, _, _ = manifest(cell)
    assert run_cell(cfg, traffic, 5, 3.0).correct
    assert not run_cell(cfg, traffic, 5, 3.0, fault=fault).correct
