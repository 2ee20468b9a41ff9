"""Where a decode's time goes, per stage of the frame step, on one device.

Usage:
  python -m cuda_vp9_torch.tools.profile_decode in.ivf [--frames N]
         [--device cuda] [--profile-frames K] [--streams S]

Decodes the stream once to warm up (kernel build, allocator, cached
steps), then:
  * decodes it again with a stage clock in place of the step's spans
    (runtime/fused.py: vp9.upload, vp9.residual, vp9.inter, vp9.intra,
    vp9.loopfilter, vp9.refresh): the device is synchronised at each span
    edge, and the host wall time inside each span is summed.  Prints the
    frame rate of this pass and each stage's milliseconds and share;
  * with --profile-frames K, decodes the first K frames under
    torch.profiler and prints the kernel launches, the device time of
    all kernels and copies, the device's busy share (that time over the
    wall time of the profiled pass, which the profiler itself slows),
    and the kernels with the most device time.  Keep K small: reading
    back a profile costs seconds per hundred thousand launches.

With --streams S > 1 every pass decodes S copies of the stream in
lockstep through BatchedTorchDecoder (runtime/multistream.py), whose
batched step has the same spans; rates are aggregate over the copies.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from ..codec import (CodecCtx, DecCfg, FrameIter, vp9_dx_torch,
                     vpx_codec_dec_init, vpx_codec_decode, vpx_codec_destroy,
                     vpx_codec_get_frame)
from ..containers import open_video
from ..utils.md5 import frame_md5
from ..runtime import fused


def decode(path: str, device: str, limit: int = 0, streams: int = 1):
    """Decode up to `limit` frames (0 = all) through the codec API with
    vp9_dx_torch(device), or `streams` copies of them through
    BatchedTorchDecoder, and read each one back.  Returns (per-frame
    MD5s, the recon or decoder with its frame counts)."""
    if streams > 1:
        return _decode_batched(path, device, limit, streams)
    ctx = CodecCtx()
    if vpx_codec_dec_init(ctx, vp9_dx_torch(device), DecCfg()) != 0:
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


def stage_clock(path, device, limit, streams=1):
    """(frames, wall seconds, {span: seconds}) of one decode with the
    device synchronised at every span edge."""
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

    span = fused.record_function
    fused.record_function = clock
    try:
        t0 = time.perf_counter()
        n = len(decode(path, device, limit, streams)[0])
        wall = time.perf_counter() - t0
    finally:
        fused.record_function = span
    return n, wall, spent


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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_decode",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames to decode (default all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-frames", type=int, default=0, metavar="K",
                    help="also profile the first K frames' kernels (CUDA)")
    ap.add_argument("--streams", type=int, default=1, metavar="S",
                    help="decode S copies in lockstep (BatchedTorchDecoder)")
    args = ap.parse_args(argv)

    decode(args.input, args.device, args.frames, args.streams)
    n, wall, spent = stage_clock(args.input, args.device, args.frames,
                                 args.streams)
    print(f"{args.input}: {n} frames, {wall:.3f} s with a stage clock "
          f"({n / wall:.2f} fps), device {args.device}")
    for name, s in spent.items():
        print(f"  {name:16s} {s * 1e3:10.1f} ms  {s / wall:6.1%}")
    rest = wall - sum(spent.values())
    print(f"  {'outside step':16s} {rest * 1e3:10.1f} ms  {rest / wall:6.1%}"
          "  (parse, pack, read-back)")
    if args.profile_frames:
        kernel_profile(args.input, args.device, args.profile_frames,
                       args.streams)
    return 0


if __name__ == "__main__":
    sys.exit(main())
