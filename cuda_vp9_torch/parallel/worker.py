"""The worker process of `ShardedBatchedDecoder`: one `BatchedTorchDecoder`
on one device, serving the parent's requests over a pipe.

It lives in the package so that a spawned process can import it by name.
Each request is (command, argument); each answer is ("ok", value) or
("error", the traceback).  The worker exits on "close", or when the parent
goes away.  It keeps the seconds it spent on each kind of request, on
sending its answers ("send": pickling and the pipe), and in a drain on
the flush before the frames are converted ("drain.flush": waiting for the
device and the read-back); stats() reports them.
"""

from __future__ import annotations

import os
import time
import traceback
from collections import defaultdict

import numpy as np
import torch

# the kernel counters each worker reports (the attributes of ops/cuda/*)
COUNTERS = ("launches", "plain_calls", "host_calls", "chunks", "buckets",
            "phases", "scaled_calls", "mask_calls", "pages")


class DeferredPlanes:
    """The planes of a frame decoded with defer_output: never fetched."""

    def __getitem__(self, i):
        raise RuntimeError("the frame's output was not fetched "
                           "(defer_output)")


def kernel_counts():
    """{module: {counter: value}} of this process's kernel wrappers."""
    from ..ops.cuda import intra, lf422, loopfilter, mc, pages, residual
    return {mod.__name__.rsplit(".", 1)[1]:
            {c: getattr(mod, c) for c in COUNTERS if hasattr(mod, c)}
            for mod in (loopfilter, lf422, intra, residual, mc, pages)}


def _portable(frame, deferred):
    """The DecodedFrame with its planes as numpy arrays (fetched here), or
    with DeferredPlanes, ready to be pickled."""
    from ..decoder.frame import DecodedFrame
    planes = DeferredPlanes() if deferred else [
        np.asarray(p) for p in frame.planes]
    return DecodedFrame(planes, frame.width, frame.height, frame.bit_depth,
                        frame.ss_x, frame.ss_y)


def serve(conn, device: str, n_streams: int, validate: bool, defer: bool,
          threads: int) -> None:
    """The worker's loop (the target of its process)."""
    torch.set_num_threads(threads)
    try:
        from ..runtime.multistream import BatchedTorchDecoder
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dec = BatchedTorchDecoder(n_streams, dev, defer_output=defer,
                                  validate_against_oracle=validate)
        conn.send(("ok", os.getpid()))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    seconds = defaultdict(float)
    while True:
        try:
            cmd, arg = conn.recv()
        except EOFError:
            return
        if cmd == "close":
            return
        t0 = time.perf_counter()
        try:
            if cmd == "round":
                value = dec.decode_round(arg)
            elif cmd == "flush":
                value = dec.flush()
            elif cmd == "sync":
                value = dec.sync()
            elif cmd == "drain":
                dec.flush()
                seconds["drain.flush"] += time.perf_counter() - t0
                value = [(s, _portable(fr, defer)) for s, fr in dec.drain()]
            elif cmd == "stats":
                value = {"streams": dec.stats(), "device": str(dev),
                         "pid": os.getpid(), "rounds": dec.rounds,
                         "kernels": kernel_counts(),
                         "seconds": dict(seconds)}
            else:
                raise ValueError(f"unknown request {cmd!r}")
        except Exception:
            conn.send(("error", traceback.format_exc()))
            continue
        t1 = time.perf_counter()
        conn.send(("ok", value))
        seconds[cmd] += t1 - t0
        seconds["send"] += time.perf_counter() - t1
