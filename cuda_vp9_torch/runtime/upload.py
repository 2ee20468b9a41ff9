"""The upload of a frame's flat, or of a batched round's flats.

Counterpart of the JAX package's page-compacted upload:
`TpuReconFused._compact` (`cuda_vp9_tpu/runtime/pipeline.py:410-448`),
`BatchedFusedDecoder._np_compact` and the page-tier branch of
`_dispatch_round` (`runtime/multistream.py:445-466,532-545`), with the
step's expansion (`runtime/fused.py:513-518`).  A flat is the packer's
capacity-padded int16 buffer of whole 1 KB pages, most of them zero.

An `Uploader` sends the flats of one step call (one frame, or the A
frames of a batched round with the round's int16 `aux`) in three stages,
each a span of the step (`runtime/fused.py`):

  stage   (vp9.compact, host) writes the call's upload into a pinned
          staging buffer: the table of `ops/cuda/pages.Flat`s, `aux`,
          then per flat its int32 page map and its nonzero pages
          (`native.compact_pages`, one pass, straight into the buffer
          through its numpy view; a `native.RecordedFlat` has only its
          recorded pages read), or the flat itself where the compacted
          form would not be smaller (`dense_frames`);
  send    (vp9.upload) one non_blocking host-to-device copy of the bytes
          used into a device buffer;
  expand  (vp9.expand) one `pages.expand_pages` call, the kernel on a
          CUDA device and its plain twin on the CPU, into a device flat
          buffer [A, nflat] int16.

Two staging buffers take turns, so the host compacts frame n + 1 while
frame n's copy is in flight; a buffer is refilled only after the event
recorded behind its last copy has completed.  Each grows only when a call
needs more than it holds, sized for the call's worst case (every flat
dense), so the first keyframe of a geometry sizes it.  The device buffers
are reused call after call and grow the same way: every copy and launch
goes to the current stream, in order.  The host's flats are untouched:
the step reads its loop bounds from them.

On a CUDA device the staging buffers are pinned, and a failed pin raises;
on the CPU they are plain tensors and the copy is a memcpy.  The host's
waits for a buffer's event are counted in `staging_wait_ns`, a total over
every uploader of the process (nanoseconds; 0 on the CPU, which records
no event).

Not ported: the page-tier ladder and the sticky tier floor
(`pipeline.py:39-55,204-209`, `multistream.py:446-463`), which manage the
TPU's compile count.  The map is int32, where JAX's int16 map caps a frame
at 32,767 nonzero pages, and the wire has no zero page and no padding.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..native import compact_pages
from ..ops.cuda.pages import (PAGE, PAGE_BYTES, TABLE_BYTES, Flat, Table,
                              expand_pages)

staging_wait_ns = 0     # host time in the staging buffers' event waits


def _align16(n: int) -> int:
    return (n + 15) & ~15


class Staged(NamedTuple):
    """One call's upload in staging buffer `turn`: its first `nbytes`
    bytes, the flats' table in host ints (checked once, here; with their
    page count, `flats.n_pages`), and the byte offset and length of the
    int16 aux (0 when there is none)."""
    turn: int
    nbytes: int
    flats: Table
    aux: int
    n_aux: int


class Uploader:
    """The upload of one flat or of a round, on `device` (module
    docstring).  Counts the flats sent (`frames`), those sent dense
    (`dense_frames`), their dense bytes (`flat_bytes`) and the bytes
    sent (`sent_bytes`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._host = [None, None]       # staging buffers, uint8
        self._copied = [None, None]     # event behind each one's last copy
        self._turn = 0
        self._buf = None                # device copy of a staging buffer
        self._out = None                # device flats, int16
        self.frames = 0
        self.dense_frames = 0
        self.flat_bytes = 0
        self.sent_bytes = 0

    def _staging(self, nbytes: int):
        """(turn, numpy view) of the next staging buffer, at least nbytes
        long, once its last copy has completed."""
        global staging_wait_ns
        turn = self._turn
        self._turn ^= 1
        if self._copied[turn] is not None:
            t0 = time.perf_counter_ns()
            self._copied[turn].synchronize()
            staging_wait_ns += time.perf_counter_ns() - t0
        host = self._host[turn]
        if host is None or host.numel() < nbytes:
            host = self._host[turn] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=self._cuda)
        return turn, host.numpy()

    def stage(self, flats, aux=None) -> Staged:
        """Write the upload of `flats` (a sequence of A int16 flats of one
        size, whole pages) and of `aux` (int16, or None) into the next
        staging buffer (host work only)."""
        nflat = flats[0].size if len(flats) else 0
        if not nflat or nflat % PAGE or any(
                f.dtype != np.int16 or f.shape != (nflat,)
                or not f.flags.c_contiguous for f in flats):
            raise ValueError("upload: flats must be contiguous int16 "
                             "vectors of one size, whole pages")
        A, K = len(flats), nflat // PAGE
        n_aux = 0 if aux is None else len(aux)
        head = _align16(TABLE_BYTES * A + 2 * n_aux)
        turn, buf = self._staging(head + A * K * PAGE_BYTES)
        if n_aux:
            buf[TABLE_BYTES * A:TABLE_BYTES * A + 2 * n_aux].view(
                np.int16)[:] = aux
        map_bytes = _align16(4 * K)
        # the most nonzero pages whose map and pages are smaller than the
        # dense flat
        max_pages = (K * PAGE_BYTES - map_bytes - 1) // PAGE_BYTES
        base, cur, table = buf.ctypes.data, head, []
        for f in flats:
            n = compact_pages(f, max_pages, base + cur,
                              base + cur + map_bytes,
                              getattr(f, "written", None))
            if n < 0:
                buf[cur:cur + K * PAGE_BYTES] = f.view(np.uint8)
                table.append(Flat(-1, cur, K))
                cur += K * PAGE_BYTES
                self.dense_frames += 1
            else:
                table.append(Flat(cur, cur + map_bytes, n))
                cur += map_bytes + n * PAGE_BYTES
        table = Table(table, K, cur)
        buf[:TABLE_BYTES * A].view(np.int64)[:] = table.words
        self.frames += A
        self.flat_bytes += A * K * PAGE_BYTES
        self.sent_bytes += cur
        return Staged(turn, cur, table, TABLE_BYTES * A if n_aux else 0,
                      n_aux)

    def send(self, st: Staged):
        """One host-to-device copy of the staged bytes (non_blocking: the
        host returns at once on a CUDA device); returns the device bytes
        [st.nbytes] uint8."""
        host = self._host[st.turn]
        if self._buf is None or self._buf.numel() < st.nbytes:
            self._buf = torch.empty(host.numel(), dtype=torch.uint8,
                                    device=self.device)
        buf = self._buf[:st.nbytes]
        buf.copy_(host[:st.nbytes], non_blocking=True)
        if self._cuda:
            ev = self._copied[st.turn] or torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[st.turn] = ev
        return buf

    def expand(self, st: Staged, buf):
        """The flats rebuilt on the device from buf (`send`'s), one
        `expand_pages` call: [A, nflat] int16, valid until the next
        call's expansion."""
        A, K = len(st.flats), st.flats.n_pages
        n = A * K * PAGE
        if self._out is None or self._out.numel() < n:
            self._out = torch.empty(n, dtype=torch.int16, device=self.device)
        out = self._out[:n].view(A, K * PAGE)
        return expand_pages(out, buf, st.flats, K)

    @staticmethod
    def aux(st: Staged, buf):
        """The int16 aux on the device, a view of buf."""
        return buf[st.aux:st.aux + 2 * st.n_aux].view(torch.int16)
