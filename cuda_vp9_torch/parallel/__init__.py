"""Multi-card scale-out: one worker process per card.

Counterpart of `cuda_vp9_tpu/parallel/__init__.py` and of the JAX
`BatchedFusedDecoder(mesh=)` (`runtime/multistream.py`), which shards the
stream axis of the vmapped frame step over a mesh's 'data' axis.  Streams
never communicate (the JAX path uses no collectives), and the port's time
is on the host (parse, pack, compaction), which one Python thread would
run for the cards one after another.  So here a mesh is a list of
`torch.device`s, and `ShardedBatchedDecoder` starts one worker process
per entry (`torch.multiprocessing`, spawn: CUDA cannot be used in a forked
child), each running a `BatchedTorchDecoder` on its contiguous block of
streams, laid out as `P("data")` lays out the leading axis.  An entry may
repeat (two processes on one card).

    mesh = data_mesh(2)                  # [cuda:0, cuda:1]
    with ShardedBatchedDecoder(16, mesh) as dec:
        for round_packets in zip(*stream_packet_lists):
            dec.decode_round(list(round_packets))   # None: no packet
        for s, frame in dec.drain():      # global stream index
            ...

Frames come back pickled, their planes forced to numpy in the worker (with
defer_output, without planes).  A worker's exception comes back with its
traceback and the parent raises RuntimeError naming the worker and its
device; a worker that dies, or does not answer within TIMEOUT seconds,
does too.  The parent never decodes a shard itself, and nothing falls
back to the CPU or to a plain version.  `python -m
cuda_vp9_torch.parallel.dryrun N` is the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import worker

# the decode path's CUDA sources (csrc/<name>.cu)
SOURCES = ("loopfilter", "intra", "residual", "mc", "pages")


def data_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """The first `n_devices` cards ("cuda") as a list of `torch.device`
    (every visible card by default); for "cpu",
    `n_devices` entries of cpu (one by default).  Raises ValueError when
    fewer cards are visible."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    have = torch.cuda.device_count()
    need = have if n_devices is None else n_devices
    if need < 1 or have < need:
        raise ValueError(f"need {max(need, 1)} devices, have {have}")
    return [torch.device(device_type, i) for i in range(need)]


def stream_sharding(mesh, n_streams: int):
    """Each mesh entry's contiguous block of streams (a range), as
    P("data") lays out a leading axis: block sizes differ by at most one,
    the first n_streams % len(mesh) blocks being the larger."""
    q, r = divmod(n_streams, len(mesh))
    starts = [i * q + min(i, r) for i in range(len(mesh) + 1)]
    return [range(a, b) for a, b in zip(starts, starts[1:])]


def _build_libraries(mesh) -> None:
    """Build and load, in this process, every library the workers load:
    the host library, and the decode path's CUDA sources (one nvcc each,
    in parallel) when the mesh holds a card; a worker then finds them
    built instead of racing the others to build them."""
    from .. import native
    native._load()
    if any(d.type == "cuda" for d in mesh):
        from ..ops.cuda import _build
        from ..ops.cuda import intra, lf422, loopfilter, mc, pages, residual
        with ThreadPoolExecutor(len(SOURCES)) as ex:
            list(ex.map(_build.build, SOURCES))
        for mod in (loopfilter, lf422, intra, residual, mc, pages):
            mod._lib()


class ShardedBatchedDecoder:
    """N same-geometry 4:2:0 streams decoded in lockstep over the mesh,
    one worker process per mesh entry, each a `BatchedTorchDecoder` on its
    block of `stream_sharding(mesh, n_streams)`.  The surface is
    `BatchedTorchDecoder`'s, with global stream indices; use it as a
    context manager, or call close()."""

    TIMEOUT = 600.0     # seconds a worker may take to answer one request

    def __init__(self, n_streams: int, mesh=None,
                 validate_against_oracle: bool = False,
                 defer_output: bool = False):
        self.mesh = [torch.device(d) for d in
                     (data_mesh() if mesh is None else mesh)]
        self.n = n_streams
        self.blocks = stream_sharding(self.mesh, n_streams)
        if not all(self.blocks):
            raise ValueError(f"{n_streams} streams cannot fill a mesh of "
                             f"{len(self.mesh)}")
        _build_libraries(self.mesh)
        ctx = torch.multiprocessing.get_context("spawn")
        threads = max(1, torch.get_num_threads() // len(self.mesh))
        self._procs, self._conns = [], []
        try:
            for i, (dev, blk) in enumerate(zip(self.mesh, self.blocks)):
                conn, child = ctx.Pipe()
                proc = ctx.Process(
                    target=worker.serve, name=f"vp9-shard-{i}", daemon=True,
                    args=(child, str(dev), len(blk), validate_against_oracle,
                          defer_output, threads))
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(conn)
            self._gather()       # each worker's decoder is up
        except BaseException:
            self.close()
            raise

    # ---------------------------------------------------------- requests

    def _recv(self, i):
        """Worker i's answer; RuntimeError when it failed, died or did
        not answer within TIMEOUT."""
        conn, proc = self._conns[i], self._procs[i]
        who = f"worker {i} on {self.mesh[i]} (pid {proc.pid})"
        deadline = time.monotonic() + self.TIMEOUT
        while not conn.poll(1.0):
            if proc.exitcode is not None:
                raise RuntimeError(f"{who} died with exit code "
                                   f"{proc.exitcode}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"{who} did not answer within "
                                   f"{self.TIMEOUT:.0f} s")
        try:
            status, value = conn.recv()
        except EOFError:
            proc.join(5.0)
            raise RuntimeError(f"{who} died with exit code "
                               f"{proc.exitcode}") from None
        if status != "ok":
            raise RuntimeError(f"{who} failed:\n{value}")
        return value

    def _gather(self):
        """Every worker's answer, in mesh order; on a failure the workers
        are stopped before the error is raised."""
        try:
            return [self._recv(i) for i in range(len(self._procs))]
        except BaseException:
            self.close()
            raise

    def _call(self, cmd, args=None):
        """Send `cmd` to every worker (with args[i] to worker i), then
        gather the answers: the workers run it concurrently."""
        if not self._procs:
            raise RuntimeError("the decoder is closed")
        for i, conn in enumerate(self._conns):
            try:
                conn.send((cmd, None if args is None else args[i]))
            except OSError:
                pass        # a dead worker: _recv names it
        return self._gather()

    # ---------------------------------------------------------- surface

    def decode_round(self, packets):
        """Feed one packet per stream (None: no packet for that stream this
        round); each worker runs one batched step for its block."""
        if len(packets) != self.n:
            raise ValueError(f"{len(packets)} packets for {self.n} streams")
        self._call("round", [list(packets[b.start:b.stop])
                             for b in self.blocks])

    def flush(self):
        """Run the rounds in flight and fetch every pending frame."""
        self._call("flush")

    def sync(self) -> int:
        """Wait until every worker's device has run every round, without
        fetching frames: the sum of the workers' ring checksums."""
        return sum(self._call("sync"))

    def drain(self):
        """Yield (global stream, DecodedFrame) for everything decoded so
        far, in stream order; the planes are numpy arrays (with
        defer_output, reading them raises RuntimeError)."""
        for blk, frames in zip(self.blocks, self._call("drain")):
            for s, fr in frames:
                yield blk.start + s, fr

    def stats(self):
        """{"streams": the per-stream dicts of BatchedTorchDecoder.stats()
        under global indices, "workers": per worker its device, pid,
        streams (a range), batched rounds, kernel counters ({module:
        {counter: value}}, from the worker's process) and seconds spent
        per kind of request (worker.serve)}."""
        streams, workers = [], []
        for blk, st in zip(self.blocks, self._call("stats")):
            streams.extend(st.pop("streams"))
            workers.append({**st, "streams": blk})
        return {"streams": streams, "workers": workers}

    def close(self):
        """Stop every worker (asked first, then terminated); idempotent."""
        for conn, proc in zip(self._conns, self._procs):
            if proc.is_alive():
                try:
                    conn.send(("close", None))
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(10.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(10.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
