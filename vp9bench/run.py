"""The benchmark of `cuda_vp9_torch`: one run of one cell.

    python3 -m vp9bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
are found by name from BENCHMARK.json: the configuration's file
(`vp9bench/configs/<name>.json`), the traffic's
(`vp9bench/traffic/<traffic>.json`), and a reader for each metric
(`vp9bench/metrics/<metric>.py`).  A run

1. fails (exit 3, no result) without as many CUDA cards as the cell asks
   for;
2. sets up: fixes glibc's allocation thresholds (`steady_malloc`),
   loads the corpus, builds the decoder the traffic names (`drivers.py`)
   and decodes its warm-up, which builds or loads every kernel and sizes
   every buffer the cell uses;
3. measures for --seconds, the hasher's thread on a CPU of its own and
   the program's threads on the others (`pin_cpus`): the driver's loop,
   ended at the first delivery boundary past the time; with --trace 1 a
   steady stretch of it runs under torch.profiler: from the first
   boundary past a fifth of the window, for three fifths of --seconds (at
   most STRETCH_S) timed from its own start (the window then lasts until
   the stretch has ended);
4. reads the device's memory peak, delivers what is still in flight,
   frees the program's state and holds every frame delivered after the
   warm-up (hashed by a thread as it came, `reference.Hasher`) against
   its golden MD5 (`reference.py`);
5. fails (exit 4, no result) if JAX or the JAX package is loaded;
6. prints the device, what the program counted, each number compared
   with its limit (the last lines of standard error), and one JSON line
   (the last of standard output).

The checks of `correct` under the control and planted faults run
through `run_cell` from `vp9bench.controls`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_vp9_tpu")
STRETCH_S = 12.0      # the longest traced stretch: its trace is read in
                      # seconds per second of stretch


def cache_env(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the program builds its own libraries into build/ there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "vp9bench"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "vp9bench"
                                         / "triton")


def manifest(cell: str, root: Path = ROOT):
    """(workload entry, config, traffic, end-to-end and per-layer metric
    names of the cell) from BENCHMARK.json."""
    from .traffic import load_traffic
    bm = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bm["workloads"]}.get(cell)
    if wl is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    cf = {c["name"]: c for c in bm["configs"]}[wl["config"]]
    cfg = json.loads((root / cf["file"]).read_text())
    traffic = load_traffic(wl["traffic"])

    def mine(m):
        return cell in m.get("workloads", [cell])
    e2e = [m["name"] for m in bm["end_to_end"] if mine(m)]
    layer = [m["name"] for m in bm["per_layer"]
             if mine(m) and m["moves"] in e2e]
    units = {m["name"]: m["unit"] for m in bm["end_to_end"] + bm["per_layer"]}
    return wl, cfg, traffic, e2e, layer, units


class Run:
    """What one run recorded; the metric readers read it."""

    def __init__(self, cfg, streams, device_name):
        self.cfg, self.streams, self.device_name = cfg, streams, device_name
        self.setup_s = None
        self.window_s = 0.0
        self.frames_window = 0
        self.trace = None
        self.counters = {}
        self.checks = {}
        self.correct = False
        self.due = 0
        self.memory_peak_bytes = 0
        self.phases = {}


def run_cell(cfg, traffic, seed, seconds, trace=False, device="cuda",
             fault=None, t_start=T_START) -> Run:
    """Set up, measure, check.  The chip check is the caller's."""
    import torch
    from . import corpus
    from .drivers import DRIVERS
    from .reference import Hasher, compare, passed
    cuda = torch.device(device).type == "cuda"
    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    streams = corpus.load(cfg)
    name = torch.cuda.get_device_name(torch.device(device)) if cuda \
        else "cpu"
    run = Run(cfg, streams, name)
    run.phases = phases
    phases["corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = DRIVERS[traffic["driver"]](cfg, traffic, streams, seed, device,
                                     fault)
    phases["decoder"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = drv.warm_up()
    run.due = -len(warm)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["warm_up"] = time.perf_counter() - t
    if trace:
        t = time.perf_counter()
        _warm_profiler(cuda)
        phases["profiler"] = time.perf_counter() - t
    drv.arm()
    armed = drv.counters()
    # the corpus and the set-up's objects live to the end: keep the
    # collector from walking them in the window
    gc.collect()
    gc.freeze()
    lo, span = 0.2 * seconds, min(0.6 * seconds, STRETCH_S)
    prof = stretch = None
    hasher = Hasher(pin_cpus())
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    now = t0
    while True:
        got = drv.step()
        now = time.perf_counter()
        for d in got:
            hasher.put(d.item, d.planes)
        run.frames_window += len(got)
        if drv.at_boundary:
            if trace and prof is None and now - t0 >= lo:
                prof, stretch = _start_stretch(drv, run, cuda)
            elif stretch is not None and "t1" not in stretch \
                    and now - stretch["start"] >= span:
                _end_stretch(prof, stretch, drv, run, cuda)
            if now - t0 >= seconds and (not trace or "t1" in stretch):
                break
    run.window_s = now - t0
    if stretch is not None:
        from .trace import Stretch
        run.trace = Stretch(prof.events(), stretch["frames"], stretch["fed"],
                            stretch["c0"], stretch["c1"])
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    gc.unfreeze()
    for d in drv.finish():
        hasher.put(d.item, d.planes)
    run.due += len(drv.fed)
    run.counters = drv.counters()
    del drv
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # frames the host oracle made, and the plain twins' calls (the
    # program's path for CPU tensors, so held on the card only)
    fallback = {k: run.counters[k] - armed[k]
                for k in ("frames_on_host", "plain_calls")
                if k == "frames_on_host" or cuda}
    run.checks = compare(hasher.results(), streams, run.due, fallback)
    run.correct = passed(run.checks)
    return run


def steady_malloc() -> None:
    """Fix glibc's allocation thresholds for this process: frames' planes
    and staging buffers (up to 12.4 MB a 4K frame) then come from a heap
    that is kept and reused, instead of being mapped and faulted in
    afresh by thresholds that glibc moves as a process runs, differently
    in every process."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return
    mallopt(-3, 32 << 20)     # M_MMAP_THRESHOLD, glibc's largest
    mallopt(-1, 1 << 30)      # M_TRIM_THRESHOLD
    mallopt(-2, 64 << 20)     # M_TOP_PAD


def pin_cpus():
    """Split this process's CPUs for the window: the highest for the
    hasher's thread, the rest for the main thread and every thread it
    starts from now on (the host parse's tile threads).  Returns the
    hasher's set, or None where there is one CPU."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None
    os.sched_setaffinity(0, cpus[:-1])
    return {cpus[-1]}


def _activities(cuda):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])


def _warm_profiler(cuda):
    """Start and stop the profiler once in set-up: its first start sets
    up device tracing for seconds, which must not fall in the window."""
    import torch
    from torch.profiler import profile
    with profile(activities=_activities(cuda)):
        if cuda:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()


def _start_stretch(drv, run, cuda):
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import profile
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=_activities(cuda))
    prof.start()
    rf = record_function("bench.stretch")
    rf.__enter__()
    return prof, {"rf": rf, "c0": drv.counters(), "fed0": len(drv.fed),
                  "n0": run.frames_window, "start": time.perf_counter()}


def _end_stretch(prof, st, drv, run, cuda):
    """Stop the profiler; its events are read once the window has closed."""
    import torch
    if cuda:
        torch.cuda.synchronize()
    st["rf"].__exit__(None, None, None)
    st["c1"] = drv.counters()
    st["fed"] = drv.fed[st["fed0"]:]
    st["frames"] = run.frames_window - st["n0"]
    prof.stop()
    st["t1"] = True


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(run, wl, names, units, trace) -> dict:
    from .metrics import reader
    metrics = {}
    for n in names:
        v = reader(n)(run)
        if v is not None:
            metrics[n] = {"value": float(v), "unit": units[n]}
    device = {"platform": "gpu", "kind": run.device_name,
              "count": wl["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": run.correct, "attempted": run.due,
            "failed": run.checks["md5_mismatch"]["value"]
            + run.checks["frames_missing"]["value"],
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = run.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_malloc()
    cache_env()
    wl, cfg, traffic, e2e, layer, units = manifest(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"vp9bench: the cell needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = run_cell(cfg, traffic, args.seed, args.seconds,
                   trace=bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"vp9bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    err = sys.stderr
    print(f"device: {run.device_name} x {torch.cuda.device_count()} "
          f"(cell uses {wl['chips']}); nvidia-smi: {power_limit()}",
          file=err)
    c = run.counters
    print("program: " + " ".join(f"{k}={v}" for k, v in c.items()), file=err)
    print(f"window: {run.frames_window} frames in {run.window_s:.3f} s, "
          f"setup {run.setup_s:.3f} s (" + ", ".join(
              f"{k} {v:.3f}" for k, v in run.phases.items())
          + f"), {run.due} frames due after the warm-up", file=err)
    line = result_line(run, wl, layer if args.trace else e2e, units,
                       args.trace)
    for k, v in run.checks.items():
        rule = ">=" if k == "frames_compared" else "<="
        print(f"check {k} {v['value']} {rule} {v['limit']}", file=err)
    err.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
