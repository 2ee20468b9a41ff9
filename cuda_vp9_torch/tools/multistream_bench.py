"""Aggregate decode rate of N streams on one device: BatchedTorchDecoder
(one batched step per round) and MultiStreamDecoder (N TorchRecon
pipelines round-robin) against N sequential single-stream decodes.

Usage:
  python -m cuda_vp9_torch.tools.multistream_bench [--streams N]
         [--fixture NAME] [--device cuda]

Counterpart of the JAX package's `tools/profiling/multistream_bench.py`.
The port has no encoder, so the N streams are copies of one fixture of
`tests/fixtures/` (default 16 x nc03_640x360_occl).  Each decoder runs
twice and the second, warm run is timed: a host clock around the whole
decode, every frame read back to the host and its MD5 checked against
the golden file.  Prints one line per decoder, and the device's name
and the frames per second, aggregate over the N streams.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..containers import IvfReader
from ..decoder.frame import NativeVp9Decoder
from ..runtime.multistream import BatchedTorchDecoder, MultiStreamDecoder
from ..runtime.pipeline import TorchRecon
from ..utils.md5 import frame_md5

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"


def run_batched(packets, device):
    """Decode the packet lists in lockstep, one packet of each per round
    (None once a list ends), and read every frame back: (per-stream MD5s,
    the BatchedTorchDecoder)."""
    dec = BatchedTorchDecoder(len(packets), device)
    for i in range(max(map(len, packets))):
        dec.decode_round([p[i] if i < len(p) else None for p in packets])
    out = [[] for _ in packets]
    for s, fr in dec.drain():
        out[s].append(frame_md5(fr.visible_planes()))
    return out, dec


def run_round_robin(packets, device):
    msd = MultiStreamDecoder(len(packets),
                             recon_factory=lambda: TorchRecon(device))
    out = [[] for _ in packets]
    for i in range(max(map(len, packets))):
        for s, p in enumerate(packets):
            if i < len(p):
                msd.put(s, p[i])
        for s, f in msd.ready():
            out[s].append(frame_md5(f.visible_planes()))
    for s, f in msd.flush():
        out[s].append(frame_md5(f.visible_planes()))
    return out, msd


def run_sequential(packets, device):
    out = []
    for p in packets:
        dec = NativeVp9Decoder(recon_fn=TorchRecon(device))
        frames = []
        for data in p:
            dec.decode(data)
            frames.extend(dec.frames())
        out.append([frame_md5(f.visible_planes()) for f in frames])
    return out, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--fixture", default="nc03_640x360_occl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with IvfReader(str(FIXTURES / f"{args.fixture}.ivf")) as r:
        packets = [[d for d, _ in r]] * args.streams
    golden = [ln.split()[0] for ln in (FIXTURES / f"{args.fixture}.md5")
              .read_text().splitlines()]
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for label, run in (("batched", run_batched),
                       ("round-robin", run_round_robin),
                       ("sequential", run_sequential)):
        run(packets, dev)
        t0 = time.perf_counter()
        out, dec = run(packets, dev)
        dt = time.perf_counter() - t0
        note = "" if dec is None else f"stats {dec.stats()}"
        n = sum(map(len, out))
        exact = all(o == golden for o in out)
        print(f"{label}: {args.streams} x {args.fixture}, {n} frames in "
              f"{dt:.3f} s = {n / dt:.2f} fps aggregate, MD5-exact {exact}; "
              f"{note} [{name}]", flush=True)
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
