"""Roofline shares of the program's kernels against the card's published
peak (`peaks.json`, found by the prefix of the card's name).

The kernels that the benchmark rates do almost no arithmetic, so their
least time is their least bytes over the peak memory bandwidth.  The
bytes come from the corpus's per-frame facts (`corpus/facts.py`), by the
byte function beside each roofline's reader, and so a change to the
program cannot move them.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peak_bytes_per_s(device_name: str):
    """The card's peak memory bandwidth, or None for a card the table
    does not hold."""
    for prefix, row in json.loads((HERE / "peaks.json").read_text()).items():
        if device_name.startswith(prefix):
            return row["hbm_bytes_per_s"]
    return None


def fed_frames(run):
    """The facts of every frame (shown or hidden) of the packets fed in
    the traced stretch."""
    for item in run.trace.fed:
        st = run.streams[item.stream]
        for i in st.packet_frames[item.packet]:
            yield st.facts["frames"][i]


def share(run, byte_fn, kernel: str):
    """Least time of the stretch's frames by byte_fn, over the device
    time of the kernels whose name holds `kernel`, in percent; None where
    the stretch ran no such kernel or the card is not in the table."""
    tr = run.trace
    if tr is None:
        return None
    peak = peak_bytes_per_s(run.device_name)
    seconds = tr.kernel_s(kernel)
    if peak is None or seconds <= 0:
        return None
    bps = 1 if run.cfg["bit_depth"] == 8 else 2
    least = sum(byte_fn(f, bps) for f in fed_frames(run))
    return 100.0 * least / peak / seconds
