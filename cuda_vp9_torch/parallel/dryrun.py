"""Decode real fixtures over an n-entry mesh and check them against the
golden MD5s.

    python -m cuda_vp9_torch.parallel.dryrun N [--device cpu]

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`: the
same streams (lg01, in01 and kf02 of tests/fixtures, repeated to max(N,
3)), through `ShardedBatchedDecoder` over `data_mesh(N, device)` (one
worker process per device, each a `BatchedTorchDecoder` on its block),
and the same checks: every stream's MD5s equal its golden file, frame for
frame and in count, and the device ran frames.  lg01 is 48 frames with a
mid-stream keyframe, so the run crosses the 32-slot ring's wrap; the
shorter streams sit the last rounds out.  Prints one summary line; exits
non-zero on a failed check.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..containers import IvfReader
from ..utils.md5 import frame_md5
from . import ShardedBatchedDecoder, data_mesh

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
NAMES = ("lg01_176x144_48f", "in01_176x144", "kf02_176x144")


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Decode the streams over data_mesh(n_devices, device_type) and raise
    AssertionError on a failed check."""
    mesh = data_mesh(n_devices, device_type)
    packets, goldens = [], []
    for nm in NAMES:
        with IvfReader(str(FIXTURES / f"{nm}.ivf")) as r:
            packets.append([d for d, _ in r])
        goldens.append([ln.split()[0] for ln in
                        (FIXTURES / f"{nm}.md5").read_text().splitlines()])
    n = max(n_devices, len(NAMES))
    reps = -(-n // len(NAMES))
    sp, sg = (packets * reps)[:n], (goldens * reps)[:n]

    got = {s: [] for s in range(n)}
    with ShardedBatchedDecoder(n, mesh) as dec:
        for i in range(max(map(len, sp))):
            dec.decode_round([p[i] if i < len(p) else None for p in sp])
        for s, fr in dec.drain():
            got[s].append(frame_md5(fr.visible_planes()))
        n_dev_frames = sum(st["device"] for st in dec.stats()["streams"])
    for s in range(n):
        if got[s] != sg[s][:len(got[s])] or len(got[s]) != len(sg[s]):
            raise AssertionError(f"stream {s}: MD5 mismatch vs golden "
                                 f"({len(got[s])} frames of {len(sg[s])})")
    if not n_dev_frames:
        raise AssertionError("no frames ran on the device path")
    total = sum(len(g) for g in sg)
    print(f"dryrun_multichip: mesh {[str(d) for d in mesh]} ok — "
          f"{n} mixed-content streams, {total} frames MD5-exact "
          f"(longest {max(len(g) for g in sg)} rounds: crosses the "
          f"32-slot ring wrap), "
          f"{n_dev_frames} frames via the sharded batched step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
