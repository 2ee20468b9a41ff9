"""Where a decode's time goes, per stage of the frame step, on one device.

Usage:
  python -m cuda_vp9_torch.tools.profile_decode in.ivf [--frames N]
         [--device cuda] [--threads T] [--profile-frames K] [--streams S]
         [--time-calls NAME[,NAME...]] [--reps R]

Prints the host's core count (os.cpu_count()), decodes the stream once
to warm up (kernel build, allocator, cached steps), then:
  * decodes it again with a stage clock in place of every span of the
    decode (utils/spans.py): the host's vp9.parse (decoder/frame.py),
    vp9.pack and vp9.readback (runtime/pipeline.py, multistream.py), and
    the step's vp9.compact, vp9.upload, vp9.expand, vp9.residual,
    vp9.inter, vp9.intra, vp9.loopfilter and vp9.refresh
    (runtime/fused.py): the device is synchronised at each span edge,
    and the host wall time inside each span is summed.  Prints the frame
    rate of this pass, each span's milliseconds and share, what no span
    covers ("outside spans"), the upload's flats, flats sent dense and
    bytes (dense and sent), and the kernels' counters over the pass: the
    launches of the page expansion (with the pages they wrote), of the
    loop filter (lf_frame, lf_chroma_422), of the residual kernel (with
    the buckets they ran), of the intra kernel (with the chunks they ran)
    and of the MC kernel (with the phases they ran, and the launches that
    ran its scaled class and its mask phase), with the host calls of
    intra and MC, and the calls of each plain twin (0 on a CUDA device);
  * with --profile-frames K, decodes the first K frames under
    torch.profiler and prints the kernel launches, the device time of
    all kernels and copies, the device's busy share (that time over the
    wall time of the profiled pass, which the profiler itself slows),
    and the kernels with the most device time.  Keep K small: reading
    back a profile costs seconds per hundred thousand launches;
  * with --time-calls, decodes it once more with each named function of
    runtime/fused.py that the step calls (mc_frame, residual_stage, ...)
    wrapped: each call, before it runs for the decode, is run R more
    times on copies of its in-place argument (the first) made outside
    the timed window, and timed with CUDA events (the median) and with
    the host clock around the call (the median; the call enqueues its
    work and returns, so that is the host's own time).  Prints one line
    per call and each name's sums over the pass.  A name the step does
    not call is never timed.  On the CPU only the host clock is read.

--threads T parses each frame with T tile threads (DecCfg.threads,
vpxdec -t; default 1).  With --streams S > 1 every pass decodes S copies
of the stream in lockstep through BatchedTorchDecoder
(runtime/multistream.py), one parse thread a stream, whose batched step
has the same spans; rates are aggregate over the copies.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from ..codec import (CodecCtx, DecCfg, FrameIter, vp9_dx_torch,
                     vpx_codec_dec_init, vpx_codec_decode, vpx_codec_destroy,
                     vpx_codec_get_frame)
from ..containers import open_video
from ..ops.cuda import intra as IN
from ..ops.cuda import lf422 as L4
from ..ops.cuda import loopfilter as LF
from ..ops.cuda import mc as MC
from ..ops.cuda import pages as PG
from ..ops.cuda import residual as RS
from ..utils import spans
from ..utils.md5 import frame_md5
from ..runtime import fused

_KERNELS = (PG, LF, L4, RS, MC, IN)


def decode(path: str, device: str, limit: int = 0, streams: int = 1,
           threads: int = 1):
    """Decode up to `limit` frames (0 = all) through the codec API with
    vp9_dx_torch(device) and `threads` parse threads, or `streams` copies
    of them through BatchedTorchDecoder, and read each one back.  Returns
    (per-frame MD5s, the recon or decoder with its frame counts and its
    `uploader`)."""
    if streams > 1:
        return _decode_batched(path, device, limit, streams)
    ctx = CodecCtx()
    if vpx_codec_dec_init(ctx, vp9_dx_torch(device),
                          DecCfg(threads=threads)) != 0:
        raise RuntimeError(f"decoder init failed: {ctx.err_detail}")
    imgs = []
    with open_video(path) as r:
        for data, _pts in r:
            if vpx_codec_decode(ctx, data) != 0:
                raise RuntimeError(f"{path}: decode error {ctx.err_detail}")
            it = FrameIter()
            while (img := vpx_codec_get_frame(ctx, it)) is not None:
                imgs.append(img)
            if limit and len(imgs) >= limit:
                break
    md5s = [frame_md5(img.planes) for img in imgs[:limit or len(imgs)]]
    recon = ctx._recon
    vpx_codec_destroy(ctx)
    return md5s, recon


def _decode_batched(path, device, limit, streams):
    from .multistream_bench import run_batched
    with open_video(path) as r:
        packets = [d for d, _ in r][:limit or None]
    md5s, dec = run_batched([packets] * streams, device)
    return sum(md5s, []), dec


def stage_clock(path, device, limit, streams=1, threads=1, out=None):
    """(frames, wall seconds, {span: seconds}) of one decode with the
    device synchronised at every span edge; `out`, a dict, receives the
    recon or decoder under "recon"."""
    cuda = torch.device(device).type == "cuda"
    spent = defaultdict(float)

    @contextmanager
    def clock(name):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0

    span = spans.span
    spans.span = clock
    try:
        t0 = time.perf_counter()
        md5s, recon = decode(path, device, limit, streams, threads)
        wall = time.perf_counter() - t0
    finally:
        spans.span = span
    if out is not None:
        out["recon"] = recon
    return len(md5s), wall, spent


def kernel_profile(path, device, k, streams=1):
    """Print launches, kernel time and busy share over the first k
    frames under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = len(decode(path, device, k, streams)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("vp9.")]
    dev_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"profiled {n} frames: wall {wall:.3f} s, {launches}"
          f" kernels and copies, device time {dev_us / 1e3:.2f} ms, busy "
          f"share {dev_us / 1e6 / wall:.4f}")
    for e in sorted(rows, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:8d}x  "
              f"{e.key[:80]}")


def _timed(fn, args, reps: int, cuda: bool):
    """(device ms or None, host ms): medians of fn on copies of args[0]."""
    dev, host = [], []
    for _ in range(reps):
        a = (args[0].clone(),) + tuple(args[1:])
        if cuda:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        fn(*a)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            dev.append(e0.elapsed_time(e1))
    return (statistics.median(dev) if dev else None,
            statistics.median(host))


def call_times(path, device, limit, names, reps, streams=1):
    """Decode with the functions of runtime/fused.py in `names` timed
    call by call; returns the rows (name, call index, device ms or None,
    host ms)."""
    cuda = torch.device(device).type == "cuda"
    rows, seen = [], defaultdict(int)
    real = {n: getattr(fused, n) for n in names if hasattr(fused, n)}

    def spy(name):
        fn = real[name]

        def call(*args):
            ms, host = _timed(fn, args, reps, cuda)
            rows.append((name, seen[name], ms, host))
            seen[name] += 1
            return fn(*args)

        return call

    for name in real:
        setattr(fused, name, spy(name))
    try:
        decode(path, device, limit, streams)
    finally:
        for name, fn in real.items():
            setattr(fused, name, fn)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_decode",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames to decode (default all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=1, metavar="T",
                    help="tile threads of the parse (one stream only)")
    ap.add_argument("--profile-frames", type=int, default=0, metavar="K",
                    help="also profile the first K frames' kernels (CUDA)")
    ap.add_argument("--streams", type=int, default=1, metavar="S",
                    help="decode S copies in lockstep (BatchedTorchDecoder)")
    ap.add_argument("--time-calls", default="", metavar="NAMES",
                    help="time each call of these runtime/fused.py "
                    "functions (comma-separated)")
    ap.add_argument("--reps", type=int, default=20,
                    help="runs of each timed call (--time-calls)")
    args = ap.parse_args(argv)
    if args.threads > 1 and args.streams > 1:
        ap.error("--threads: the batched decoder parses with one thread a "
                 "stream")

    print(f"host cores (os.cpu_count): {os.cpu_count()}")
    decode(args.input, args.device, args.frames, args.streams, args.threads)
    for k in _KERNELS:
        k.reset_counts()
    got = {}
    n, wall, spent = stage_clock(args.input, args.device, args.frames,
                                 args.streams, args.threads, got)
    print(f"{args.input}: {n} frames, {wall:.3f} s with a stage clock "
          f"({n / wall:.2f} fps), device {args.device}, {args.threads} "
          "parse threads")
    for name, s in spent.items():
        print(f"  {name:16s} {s * 1e3:10.1f} ms  {s / wall:6.1%}")
    rest = wall - sum(spent.values())
    print(f"  {'outside spans':16s} {rest * 1e3:10.1f} ms  "
          f"{rest / wall:6.1%}")
    up = got["recon"].uploader
    print(f"  upload: {up.frames} flats, {up.dense_frames} sent dense, "
          f"{up.flat_bytes} bytes dense, {up.sent_bytes} sent")
    print(f"  kernel launches: expand_pages {PG.launches} ({PG.pages} "
          f"pages), lf_frame {LF.launches}, lf_chroma_422 "
          f"{L4.launches}, residual {RS.launches} ({RS.buckets} buckets), "
          f"mc {MC.launches} ({MC.phases} phases; {MC.scaled_calls} with "
          f"the scaled class, {MC.mask_calls} with the mask) in "
          f"{MC.host_calls} host calls, intra {IN.launches} ({IN.chunks} "
          f"chunks) in {IN.host_calls} host calls; plain "
          "calls: "
          + ", ".join(f"{k.__name__.rsplit('.', 1)[1]} {k.plain_calls}"
                      for k in _KERNELS))
    if args.profile_frames:
        kernel_profile(args.input, args.device, args.profile_frames,
                       args.streams)
    if args.time_calls:
        rows = call_times(args.input, args.device, args.frames,
                          args.time_calls.split(","), args.reps, args.streams)
        for name, i, ms, host in rows:
            print(f"  {name} call {i}: device window {fmt_ms(ms)}, host "
                  f"{host:.4f} ms")
        for name in dict.fromkeys(r[0] for r in rows):
            ms = [r[2] for r in rows if r[0] == name]
            dev = None if None in ms else sum(ms)
            print(f"  {name}: {len(ms)} calls, device windows summed "
                  f"{fmt_ms(dev)}, host summed "
                  f"{sum(r[3] for r in rows if r[0] == name):.4f} ms")
    return 0


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


if __name__ == "__main__":
    sys.exit(main())
