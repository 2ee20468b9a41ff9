"""Metric readers: `vp9bench/metrics/<metric>.py`, one a metric of
BENCHMARK.json, found by the metric's name.

Each defines `read(run)`, which returns the metric's value, or None where
the run holds nothing to read (the harness then leaves the metric out of
its line).  `run` is the harness's record of one run (`vp9bench.run.Run`):
`setup_s`, `window_s`, `frames_window`, `device_name`, `streams`, `cfg`,
and in a `--trace 1` run `trace`, the `vp9bench.trace.Stretch` of the
profiled stretch (None otherwise).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The `read` function of metric `name`."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"vp9bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_frame(run, value):
    """value over the frames delivered in the traced stretch (None where
    there is no trace, no value or no frame)."""
    tr = run.trace
    if tr is None or value is None or not tr.frames:
        return None
    return value / tr.frames
