"""Readings for the limits of `correct`: sound runs of the program over
many seeds and the control or a planted fault, in one process (set-up is
paid once; each reading is a whole run of the cell's traffic).

    python3 -m vp9bench.controls --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--fault none,skip_loop_filter,stale,...]

Prints one JSON line a (fault, seed): the numbers compared
(`reference.compare`), `correct` and the frames delivered in the window.
"none" is the program as it is; the others are `drivers.FAULTS`.  The
measured runs (`vp9bench.run`) never run these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import cache_env, manifest, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache_env()
    _, cfg, traffic, _, _, _ = manifest(args.workload)
    for fault in args.fault.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run = run_cell(cfg, traffic, seed, args.seconds,
                           device=args.device,
                           fault=None if fault == "none" else fault)
            print(json.dumps({
                "workload": args.workload, "fault": fault, "seed": seed,
                "correct": run.correct, "checks": run.checks,
                "frames_window": run.frames_window,
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
