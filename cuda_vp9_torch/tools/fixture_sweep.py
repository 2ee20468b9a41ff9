"""Decode every fixture through the port and check every frame's MD5.

Usage:
  python -m cuda_vp9_torch.tools.fixture_sweep [--device cuda]
         [--fixtures DIR] [--only NAME,...]

Decodes each VP9 stream of DIR/*.ivf (default: the checkout's
tests/fixtures) and the streams of `LARGE` in DIR/large/ (hb01, the
4:4:0 streams p1_05, p1_06 and p3_02, and the scaled 4:4:4 and 4:2:2
streams sc02 and sc03) through the codec API (`profile_decode.decode`:
vpx_codec_dec_init with vp9_dx_torch(device)), every frame, and holds
each frame's MD5 against the stream's golden .md5 file.  The VP8 streams
of DIR/*.ivf (by their IVF fourcc, VP80) follow, through the codec API
with vp8_dx(), which decodes on the host by design: they are reported in
a group of their own, each line marked "decoded on the host (VP8)", are
never counted as device work, and fail only on a mismatch, a frame count
other than the .md5's, or a decode error.  `--only` takes stream names
(the file stems) or their first four or more characters (`mv01`,
`v8in01`).  `--device cpu` runs the kernels' plain versions.

Per stream it prints the frames decoded and expected, the first frame
whose MD5 differs, frames_on_host, frames_on_device and frames_wide of
the stream's TorchRecon, each kernel module's `launches` and
`plain_calls` over the stream, and its wall seconds; then, after the VP8
group's own total, a total line (streams, frames, mismatches, seconds).
It exits 1 when a stream mismatches, decodes fewer or more frames than
its .md5 lists, fails a decode, sends a frame to the host other than one
whose reference lies outside the spec's scale range (as the JAX package
does: counted in frames_out_of_scale and named in the stream's line),
or, on a CUDA device, runs a plain version.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from ..codec import (CodecCtx, DecCfg, FrameIter, vp8_dx,
                     vpx_codec_dec_init, vpx_codec_decode, vpx_codec_destroy,
                     vpx_codec_get_frame)
from ..containers import IvfReader, is_vp8
from ..ops.cuda import intra as IN
from ..ops.cuda import lf422 as L4
from ..ops.cuda import loopfilter as LF
from ..ops.cuda import mc as MC
from ..ops.cuda import pages as PG
from ..ops.cuda import residual as RS
from ..utils.md5 import frame_md5
from .profile_decode import decode

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
LARGE = ("large/hb01_1920x1080_10b", "large/p1_05_176x144_440",
         "large/p1_06_640x360_440", "large/p3_02_176x144_440_10b",
         "large/sc02_176x144_444_scaled", "large/sc03_176x144_422_scaled")
KERNELS = (PG, RS, MC, IN, LF, L4)


def _by_codec(fixtures: Path, vp8: bool):
    return [ivf.stem for ivf in sorted(fixtures.glob("*.ivf"))
            if is_vp8(ivf) == vp8]


def vp9_streams(fixtures: Path = FIXTURES):
    """Stream names (paths below `fixtures` without .ivf) of every VP9
    fixture: DIR/*.ivf whose IVF fourcc is not VP80, then LARGE."""
    return _by_codec(fixtures, False) + [
        n for n in LARGE if (fixtures / f"{n}.ivf").exists()]


def vp8_streams(fixtures: Path = FIXTURES):
    """Stream names of every VP8 fixture: DIR/*.ivf whose IVF fourcc is
    VP80."""
    return _by_codec(fixtures, True)


def streams(fixtures: Path = FIXTURES):
    """Every stream the sweep takes: the VP9 ones, then the VP8 ones."""
    return vp9_streams(fixtures) + vp8_streams(fixtures)


def decode_vp8(path: str):
    """Per-frame MD5s of a VP8 stream through the codec API with
    vp8_dx() (on the host)."""
    ctx = CodecCtx()
    if vpx_codec_dec_init(ctx, vp8_dx(), DecCfg()) != 0:
        raise RuntimeError(f"decoder init failed: {ctx.err_detail}")
    md5s = []
    with IvfReader(path) as r:
        for data, _pts in r:
            if vpx_codec_decode(ctx, data) != 0:
                raise RuntimeError(f"{path}: decode error {ctx.err_detail}")
            it = FrameIter()
            while (img := vpx_codec_get_frame(ctx, it)) is not None:
                md5s.append(frame_md5(img.planes))
    vpx_codec_destroy(ctx)
    return md5s


def golden(fixtures: Path, name: str):
    return [ln.split()[0] for ln in
            (fixtures / f"{name}.md5").read_text().splitlines()]


def _short(k) -> str:
    return k.__name__.rsplit(".", 1)[1]


def sweep_vp8(fixtures: Path, name: str) -> dict:
    """Decode one VP8 stream on the host; returns its record (the keys
    that `line` prints, and "ok")."""
    want = golden(fixtures, name)
    t0 = time.perf_counter()
    error, md5s = None, []
    try:
        md5s = decode_vp8(str(fixtures / f"{name}.ivf"))
    except RuntimeError as e:
        error = str(e)
    bad = [i for i, (a, b) in enumerate(zip(md5s, want)) if a != b]
    return {"name": name, "vp8": True, "frames": len(md5s),
            "expected": len(want),
            "first_mismatch": bad[0] if bad else None,
            "mismatches": len(bad), "error": error,
            "seconds": time.perf_counter() - t0,
            "ok": error is None and not bad and len(md5s) == len(want)}


def sweep_stream(fixtures: Path, name: str, device: str) -> dict:
    """Decode one VP9 stream on `device`; returns its record (the keys
    that `line` prints, and "ok")."""
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
    rec = {"name": name, "vp8": False, "frames": len(md5s),
           "expected": len(want),
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
    first = rec["first_mismatch"]
    head = (f"{rec['name']}: {rec['frames']} of {rec['expected']} frames, "
            f"first mismatch {'none' if first is None else f'frame {first}'}"
            f" ({rec['mismatches']} frames)")
    tail = (f"; {rec['seconds']:.2f} s"
            + ("" if rec["error"] is None else f"; {rec['error']}")
            + ("" if rec["ok"] else "  FAILED"))
    if rec["vp8"]:
        return f"{head}, decoded on the host (VP8){tail}"
    host = f"on host {rec['frames_on_host']}"
    if rec["frames_out_of_scale"]:
        host += (f" ({rec['frames_out_of_scale']} with a reference outside "
                 "the spec's scale range)")
    return (f"{head}, {host}, on device "
            f"{rec['frames_on_device']}, wide {rec['frames_wide']}, launches "
            + ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
            + "; plain calls "
            + ", ".join(f"{k} {v}" for k, v in rec["plain_calls"].items())
            + tail)


def _total(recs, seconds) -> str:
    return (f"{len(recs)} streams, {sum(r['frames'] for r in recs)} frames, "
            f"{sum(r['mismatches'] for r in recs)} mismatches, "
            f"{sum(not r['ok'] for r in recs)} streams failed, "
            f"{seconds:.2f} s")


def sweep(names, device: str, fixtures: Path = FIXTURES, out=print):
    """Decode `names`, the VP9 streams one after another and then the VP8
    ones as a group of their own with its total, printing each stream's
    line and the total; returns the records, VP9 first."""
    t0 = time.perf_counter()
    vp8 = [n for n in names if is_vp8(fixtures / f"{n}.ivf")]
    recs = []
    for name in names:
        if name not in vp8:
            recs.append(sweep_stream(fixtures, name, device))
            out(line(recs[-1]))
    if vp8:
        t8 = time.perf_counter()
        recs8 = []
        for name in vp8:
            recs8.append(sweep_vp8(fixtures, name))
            out(line(recs8[-1]))
        out("VP8 streams, decoded on the host (VP8): "
            + _total(recs8, time.perf_counter() - t8))
        recs += recs8
    out(f"fixture sweep on {device}: "
        + _total(recs, time.perf_counter() - t0))
    return recs


def _pick(names, keys):
    keys = set(keys)
    return [n for n in names if n in keys or any(
        Path(n).name.startswith(k) for k in keys if len(k) >= 4)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fixture_sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixtures", type=Path, default=FIXTURES)
    ap.add_argument("--only", default="", help="streams to decode "
                    "(comma-separated names or prefixes of four or more "
                    "characters)")
    args = ap.parse_args(argv)
    names = streams(args.fixtures)
    if args.only:
        names = _pick(names, args.only.split(","))
    recs = sweep(names, args.device, args.fixtures)
    return 0 if recs and all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
