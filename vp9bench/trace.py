"""The traced stretch of a `--trace 1` run: torch.profiler's events reduced
to what the per-layer readers (`vp9bench/metrics/`) read.

The stretch is one span of the benchmark's own, `bench.stretch`, on the
main thread; the program's spans are its `vp9.*` record_function ranges
(`cuda_vp9_torch/utils/spans.py`) on the same thread.  Device intervals
are the profiler's CUDA events (kernels, copies, sets), less any that
carry a host span's name (the profiler may mirror a range on the
device).  All times are in seconds.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

STRETCH = "bench.stretch"
PREFIX = "vp9."


def merge(intervals) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip() or name


class Stretch:
    """What the profiler saw between the stretch's edges.

    spans:   {name: [(start, end), ...]} of the main thread's vp9.* spans;
    device:  [(name, start, end), ...] of device operations;
    t0, t1:  the stretch's edges; frames: frames delivered inside it;
    fed:     the items (stream, packet, shown) fed inside it;
    c0, c1:  the program's counters at its edges."""

    def __init__(self, events, frames: int, fed, c0: dict, c1: dict):
        from torch.autograd import DeviceType
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        edge = [e for e in cpu if e.name == STRETCH]
        if len(edge) != 1:
            raise RuntimeError(f"{len(edge)} '{STRETCH}' ranges in the trace")
        main = edge[0].thread
        self.t0 = edge[0].time_range.start / 1e6
        self.t1 = edge[0].time_range.end / 1e6
        host_names = set()
        self.spans: Dict[str, list] = defaultdict(list)
        for e in cpu:
            host_names.add(e.name)
            if e.thread == main and e.name.startswith(PREFIX):
                self.spans[e.name].append((e.time_range.start / 1e6,
                                           e.time_range.end / 1e6))
        self.device = [(e.name, e.time_range.start / 1e6,
                        e.time_range.end / 1e6) for e in events
                       if e.device_type == DeviceType.CUDA
                       and e.name not in host_names]
        self.frames, self.fed, self.c0, self.c1 = frames, fed, c0, c1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self):
        return clip(merge((a, b) for _, a, b in self.device), self.t0, self.t1)

    @property
    def busy_s(self) -> float:
        return total(self.busy())

    def span_s(self, name: str) -> float:
        return total(clip(self.spans.get(name, []), self.t0, self.t1))

    @property
    def glue_s(self) -> float:
        """Main-thread time outside every vp9.* span."""
        inside = merge(iv for ivs in self.spans.values() for iv in ivs)
        return self.window_s - total(clip(inside, self.t0, self.t1))

    def kernel_s(self, substring: str) -> float:
        """Device seconds of the operations whose name holds substring."""
        return total(clip(((a, b) for n, a, b in self.device
                           if substring in n), self.t0, self.t1))

    def delta(self, key: str):
        if key not in self.c0 or key not in self.c1:
            return None
        return self.c1[key] - self.c0[key]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the device's idle
        time by the host span open meanwhile ("outside spans" where none
        is), the largest first."""
        ops = defaultdict(float)
        for n, a, b in self.device:
            ops[short_name(n)] += total(clip([(a, b)], self.t0, self.t1))
        gaps, edge = [], self.t0
        for a, b in self.busy():
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if edge < self.t1:
            gaps.append((edge, self.t1))
        idle = defaultdict(float)
        spans = sorted((a, b, n) for n, ivs in self.spans.items()
                       for a, b in ivs)
        for ga, gb in gaps:
            covered = 0.0
            for a, b, n in spans:
                if a >= gb:
                    break
                ov = min(b, gb) - max(a, ga)
                if ov > 0:
                    idle[n] += ov
                    covered += ov
            idle["outside spans"] += (gb - ga) - covered
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
