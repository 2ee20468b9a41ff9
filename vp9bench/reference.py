"""The reference that decides `correct`: the golden per-frame MD5s.

VP9 decoding is normative: every conformant decoder gives the same
samples.  The reference is therefore an independent conformant decoder,
libavcodec's `vp9`, run when the corpus was made and held there against
`libvpx-vp9` frame by frame (`corpus/make_corpus.py`).  Its output is
kept as the MD5 of each shown frame's visible planes, Y then U then V,
row by row at one byte a sample (the format of libvpx's decode_to_md5
example).  This module hashes what the program delivered in the same
way and counts the frames that differ; it imports nothing of the
program.

A run hands each delivered frame to a `Hasher` as it comes: a thread
hashes it and lets its planes go, so the window's memory stays flat (a
run that kept every frame to hash after the window wrote gigabytes of
fresh pages in it).  hashlib releases the interpreter lock while it
hashes.  The hashes are held against the reference once the window has
closed.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading

import numpy as np


def frame_md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        a = np.asarray(p)
        if a.dtype != np.uint8:
            raise ValueError("8-bit planes expected")
        h.update(np.ascontiguousarray(a))
    return h.hexdigest()


class Hasher:
    """Hash delivered frames on a thread of their own: `put(item, planes)`
    in the window, `results()` after it ([(item, md5), ...] in delivery
    order).  At most `depth` frames wait; a full queue makes `put` wait.
    `cpus`, where given, is the set of CPUs the thread runs on."""

    def __init__(self, cpus=None, depth: int = 64):
        self._q = queue.Queue(depth)
        self._out = []
        self._error = None
        self._t = threading.Thread(target=self._work, args=(cpus,),
                                   daemon=True)
        self._t.start()

    def _work(self, cpus):
        if cpus:
            os.sched_setaffinity(0, cpus)
        while (job := self._q.get()) is not None:
            item, planes = job
            try:
                self._out.append((item, frame_md5(planes)))
            except Exception as e:    # reported by results()
                self._error = e

    def put(self, item, planes):
        self._q.put((item, planes))

    def results(self):
        self._q.put(None)
        self._t.join()
        if self._error is not None:
            raise self._error
        return self._out


def compare(hashed, streams, due: int, fallback=None) -> dict:
    """The numbers that decide `correct`, each with its limit: frames
    whose MD5 differs from the reference's at their position in their
    stream, frames due that were never delivered, the frames compared
    (at least 1), and each count of `fallback` ({name: n}: work that the
    program did off the path under test, such as frames its host oracle
    made) with the limit 0.  hashed: [(item, md5), ...]."""
    bad = sum(md5 != streams[item.stream].md5[item.shown]
              for item, md5 in hashed)
    checks = {"md5_mismatch": {"value": bad, "limit": 0},
              "frames_missing": {"value": max(0, due - len(hashed)),
                                 "limit": 0},
              "frames_compared": {"value": len(hashed), "limit": 1}}
    for k, n in (fallback or {}).items():
        checks[k] = {"value": n, "limit": 0}
    return checks


def passed(checks: dict) -> bool:
    """frames_compared is a floor, the others ceilings."""
    return all(v["value"] >= v["limit"] if k == "frames_compared"
               else v["value"] <= v["limit"] for k, v in checks.items())
