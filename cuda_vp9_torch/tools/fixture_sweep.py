"""Decode every VP9 fixture through the port and check every frame's MD5.

Usage:
  python -m cuda_vp9_torch.tools.fixture_sweep [--device cuda]
         [--fixtures DIR] [--only NAME,...]

Decodes each VP9 stream of DIR/*.ivf (default: the checkout's
tests/fixtures) and the streams of `LARGE` in DIR/large/ (hb01, the
4:4:0 streams p1_05, p1_06 and p3_02, and the scaled 4:4:4 and 4:2:2
streams sc02 and sc03) through the codec API (`profile_decode.decode`:
vpx_codec_dec_init with vp9_dx_torch(device)), every frame, and holds
each frame's MD5 against the stream's golden .md5 file.  VP8 streams are
skipped by their IVF fourcc.  `--only` takes stream names (the file
stems) or their first four characters (`mv01`).  `--device cpu` runs the
kernels' plain versions.

Per stream it prints the frames decoded and expected, the first frame
whose MD5 differs, frames_on_host, frames_on_device and frames_wide of
the stream's TorchRecon, each kernel module's `launches` and
`plain_calls` over the stream, and its wall seconds; then a total line
(streams, frames, mismatches, seconds).  It exits 1 when a stream
mismatches, decodes fewer or more frames than its .md5 lists, fails a
decode, sends a frame to the host other than one whose reference lies
outside the spec's scale range (as the JAX package does: counted in
frames_out_of_scale and named in the stream's line), or, on a CUDA
device, runs a plain version.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from ..containers import IvfReader
from ..ops.cuda import intra as IN
from ..ops.cuda import lf422 as L4
from ..ops.cuda import loopfilter as LF
from ..ops.cuda import mc as MC
from ..ops.cuda import pages as PG
from ..ops.cuda import residual as RS
from .profile_decode import decode

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
LARGE = ("large/hb01_1920x1080_10b", "large/p1_05_176x144_440",
         "large/p1_06_640x360_440", "large/p3_02_176x144_440_10b",
         "large/sc02_176x144_444_scaled", "large/sc03_176x144_422_scaled")
KERNELS = (PG, RS, MC, IN, LF, L4)


def vp9_streams(fixtures: Path = FIXTURES):
    """Stream names (paths below `fixtures` without .ivf) of every VP9
    fixture: DIR/*.ivf whose IVF fourcc is VP90, then LARGE."""
    out = []
    for ivf in sorted(fixtures.glob("*.ivf")):
        with IvfReader(str(ivf)) as r:
            if r.fourcc == b"VP90":
                out.append(ivf.stem)
    return out + [n for n in LARGE if (fixtures / f"{n}.ivf").exists()]


def golden(fixtures: Path, name: str):
    return [ln.split()[0] for ln in
            (fixtures / f"{name}.md5").read_text().splitlines()]


def _short(k) -> str:
    return k.__name__.rsplit(".", 1)[1]


def sweep_stream(fixtures: Path, name: str, device: str) -> dict:
    """Decode one stream on `device`; returns its record (the keys that
    `line` prints, and "ok")."""
    want = golden(fixtures, name)
    for k in KERNELS:
        k.reset_counts()
    t0 = time.perf_counter()
    error, md5s, recon = None, [], None
    try:
        md5s, recon = decode(str(fixtures / f"{name}.ivf"), device)
    except RuntimeError as e:
        error = str(e)
    seconds = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(md5s, want)) if a != b]
    rec = {"name": name, "frames": len(md5s), "expected": len(want),
           "first_mismatch": bad[0] if bad else None,
           "mismatches": len(bad), "error": error, "seconds": seconds,
           "launches": {_short(k): k.launches for k in KERNELS},
           "plain_calls": {_short(k): k.plain_calls for k in KERNELS}}
    for key in ("frames_on_host", "frames_on_device", "frames_wide",
                "frames_out_of_scale"):
        rec[key] = getattr(recon, key, None)
    plain = device != "cpu" and any(rec["plain_calls"].values())
    rec["ok"] = (error is None and not bad and len(md5s) == len(want)
                 and rec["frames_on_host"] == rec["frames_out_of_scale"]
                 and not plain)
    return rec


def line(rec: dict) -> str:
    host = f"on host {rec['frames_on_host']}"
    if rec["frames_out_of_scale"]:
        host += (f" ({rec['frames_out_of_scale']} with a reference outside "
                 "the spec's scale range)")
    first = rec["first_mismatch"]
    return (f"{rec['name']}: {rec['frames']} of {rec['expected']} frames, "
            f"first mismatch {'none' if first is None else f'frame {first}'}"
            f" ({rec['mismatches']} frames), {host}, on device "
            f"{rec['frames_on_device']}, wide {rec['frames_wide']}, launches "
            + ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
            + "; plain calls "
            + ", ".join(f"{k} {v}" for k, v in rec["plain_calls"].items())
            + f"; {rec['seconds']:.2f} s"
            + ("" if rec["error"] is None else f"; {rec['error']}")
            + ("" if rec["ok"] else "  FAILED"))


def sweep(names, device: str, fixtures: Path = FIXTURES, out=print):
    """Decode `names` one after another, printing each stream's line and
    the total; returns the records."""
    t0 = time.perf_counter()
    recs = []
    for name in names:
        recs.append(sweep_stream(fixtures, name, device))
        out(line(recs[-1]))
    out(f"fixture sweep on {device}: {len(recs)} streams, "
        f"{sum(r['frames'] for r in recs)} frames, "
        f"{sum(r['mismatches'] for r in recs)} mismatches, "
        f"{sum(not r['ok'] for r in recs)} streams failed, "
        f"{time.perf_counter() - t0:.2f} s")
    return recs


def _pick(names, keys):
    keys = set(keys)
    return [n for n in names if n in keys or Path(n).name[:4] in keys]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fixture_sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixtures", type=Path, default=FIXTURES)
    ap.add_argument("--only", default="", help="streams to decode "
                    "(comma-separated names or four-character prefixes)")
    args = ap.parse_args(argv)
    names = vp9_streams(args.fixtures)
    if args.only:
        names = _pick(names, args.only.split(","))
    recs = sweep(names, args.device, args.fixtures)
    return 0 if recs and all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
