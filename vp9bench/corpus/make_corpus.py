"""Make the benchmark's corpus: VP9 streams at published VOD bitrates,
their golden per-frame MD5s and their per-frame facts.

Usage (from the root of the repository, on a host with the system
libavcodec and gcc; no card needed):

    python -m vp9bench.corpus.make_corpus [--config NAME ...] [--jobs N]
    python -m vp9bench.corpus.make_corpus --config-file PATH


For each configuration `vp9bench/configs/<NAME>.json` (or the file
given, such as the tests' `vp9bench/tests/tiny.json`) and each of its
content seeds it

1. builds `oracle.c` (beside this file) against libavcodec into
   `build/vp9bench/oracle`;
2. makes the raw I420 content with `synth.synth_video(seed=...)`;
3. encodes it with libvpx-vp9 with the configuration's `encoder`
   settings (two passes, constrained quality: a CRF under the target
   bitrate, alt-ref frames on);
4. decodes the stream with libavcodec's `vp9` decoder and with
   `libvpx-vp9`, writes the first's per-frame MD5s and exits 1 if the two
   disagree on any frame or the stream does not show
   `frames_per_stream` frames;
5. writes the stream's per-frame facts (`facts.stream_facts`).

The files go to `vp9bench/corpus/<NAME>/s<seed>.{ivf,md5,json}`.  The
raw content is written under $TMPDIR and deleted after the encode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
ORACLE_SRC = HERE / "oracle.c"
ORACLE_BIN = ROOT / "build" / "vp9bench" / "oracle"

ENCODER_KEYS = ("passes", "fps", "crf", "bitrate", "minrate", "maxrate", "gop",
                "tile_cols", "cpu_used", "cpu_used_pass1", "threads", "lag",
                "auto_alt_ref")


def build_oracle() -> None:
    if (ORACLE_BIN.exists()
            and ORACLE_BIN.stat().st_mtime > ORACLE_SRC.stat().st_mtime):
        return
    ORACLE_BIN.parent.mkdir(parents=True, exist_ok=True)
    subprocess.check_call(["gcc", "-O2", "-o", str(ORACLE_BIN),
                           str(ORACLE_SRC), "-lavcodec", "-lavutil"])


def make_stream(cfg: dict, seed: int) -> dict:
    """Encode, check and describe one stream; returns its summary."""
    from .facts import stream_facts
    from .synth import synth_video
    w, h, n = cfg["width"], cfg["height"], cfg["frames_per_stream"]
    out = HERE / cfg["name"]
    out.mkdir(exist_ok=True)
    ivf, md5 = out / f"s{seed}.ivf", out / f"s{seed}.md5"
    enc = cfg["encoder"]
    opts = [f"{k}={enc[k]}" for k in ENCODER_KEYS if k in enc]
    with tempfile.TemporaryDirectory() as tmp:
        yuv = Path(tmp) / "in.yuv"
        yuv.write_bytes(synth_video(w, h, n, seed=seed))
        subprocess.check_call([str(ORACLE_BIN), "encode", str(w), str(h),
                               str(yuv), str(ivf)] + opts)
        yuv.unlink()
        other = Path(tmp) / "libvpx.md5"
        subprocess.check_call([str(ORACLE_BIN), "decode", str(ivf), str(md5),
                               "codec=vp9"])
        subprocess.check_call([str(ORACLE_BIN), "decode", str(ivf),
                               str(other), "codec=libvpx-vp9"])
        a, b = md5.read_text(), other.read_text()
    if a != b:
        raise SystemExit(f"{ivf}: libavcodec's vp9 and libvpx-vp9 disagree")
    shown = a.count("\n")
    if shown != n:
        raise SystemExit(f"{ivf}: {shown} frames shown, {n} expected")
    facts = stream_facts(str(ivf), cfg)
    if sum(f["shown"] for f in facts["frames"]) != n:
        raise SystemExit(f"{ivf}: the facts count another number of "
                         "shown frames than the decoders")
    (out / f"s{seed}.json").write_text(json.dumps(facts, separators=(",", ":")))
    size = ivf.stat().st_size
    return {"stream": f"{cfg['name']}/s{seed}", "bytes": size,
            "kbit_per_s": size * 8 * cfg["fps"] / n / 1000,
            "packets": facts["packets"], "frames": len(facts["frames"]),
            "shown": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append",
                    help="configuration name (default: every one)")
    ap.add_argument("--config-file", action="append", default=[],
                    help="a configuration file outside vp9bench/configs")
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)
    files = [BENCH / "configs" / f"{n}.json" for n in args.config or ()]
    files += [Path(f) for f in args.config_file]
    if not files:
        files = sorted((BENCH / "configs").glob("*.json"))
    build_oracle()
    work = []
    for path in files:
        cfg = json.loads(path.read_text())
        work += [(cfg, seed) for seed in cfg["content_seeds"]]
    with ProcessPoolExecutor(args.jobs,
                             mp_context=get_context("spawn")) as ex:
        futs = [ex.submit(make_stream, cfg, seed) for cfg, seed in work]
        for fut in futs:
            print(json.dumps(fut.result()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
