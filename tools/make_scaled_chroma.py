"""Make the scaled-reference fixtures at 4:4:4 and 4:2:2 in
tests/fixtures/large/: sc02_176x144_444_scaled and sc03_176x144_422_scaled.

Each stream is an 8-bit profile-1 keyframe at 176x144 from the oracle
(`tools/oracle/oracle encode ... pixfmt=444|422 profile=1 gop=1`, content
from `tools/make_440.py`'s `yuv`, numpy from a fixed seed), then four
inter frames from the JAX package's synthetic writer
(`cuda_vp9_tpu.encoder.interframe.write_inter_zeromv_frame`, profile 1),
all predicting from the keyframe: ZEROMV skip frames at 128x112, 176x144
and 240x200 (scaled down, unscaled, scaled up), and a 240x200 frame whose
blocks carry non-zero motion vectors (`MVS`), so that the scaled filter's
phases vary.  The golden MD5s come from the unmodified `tools/oracle/oracle
decode` (libavcodec's native VP9 decoder).  Then every stream is decoded
through the JAX package (`python -m cuda_vp9_tpu.tools.vpxdec --md5`,
whose scaled 4:4:4 and 4:2:2 frames go to its host oracle); the script
exits 1 if any MD5 differs from libavcodec's.

    python tools/make_scaled_chroma.py [--out tests/fixtures/large]

Needs gcc and the system libavcodec / libavutil (with libvpx).  The JAX
package's cross-check takes a few minutes on a CPU (most of it the XLA
compile of the keyframe's step).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from make_440 import BUILD, yuv  # noqa: E402
from make_fixtures import ORACLE_BIN, build_oracle  # noqa: E402

W, H = 176, 144
# name: pixfmt of the keyframe
STREAMS = {"sc02_176x144_444_scaled": 444, "sc03_176x144_422_scaled": 422}
# the inter frames: (width, height, with motion vectors)
FRAMES = ((128, 112, False), (176, 144, False), (240, 200, False),
          (240, 200, True))


def mv(mi_row: int, mi_col: int):
    """A block's motion vector (row, col) in 1/8 pel, even components (the
    writer codes frames without high-precision MVs), in [-8, 8] and
    [-10, 10] pixels' eighths, varying across the frame."""
    return (2 * ((mi_row + 3 * mi_col) % 9 - 4),
            2 * ((3 * mi_row + mi_col) % 11 - 5))


def make(out: Path, name: str, pixfmt: int) -> bool:
    """Write one stream and its golden MD5s, and hold the JAX package
    against them; False on a mismatch."""
    from cuda_vp9_tpu.containers.ivf import IvfReader, IvfWriter
    from cuda_vp9_tpu.encoder.interframe import write_inter_zeromv_frame

    cw = W if pixfmt == 444 else W // 2
    BUILD.mkdir(parents=True, exist_ok=True)
    raw, key = BUILD / f"{name}.yuv", BUILD / f"{name}.key.ivf"
    raw.write_bytes(yuv(W, H, 1, 8, cw, H))
    subprocess.run([ORACLE_BIN, "encode", str(W), str(H), str(raw), str(key),
                    f"pixfmt={pixfmt}", "profile=1", "gop=1", "crf=30",
                    "cpu_used=2"], check=True)
    raw.unlink()
    with IvfReader(str(key)) as r:
        keyframe = [d for d, _ in r]
    assert len(keyframe) == 1, f"{name}: {len(keyframe)} keyframe packets"
    ivf, md5 = out / f"{name}.ivf", out / f"{name}.md5"
    with open(ivf, "wb") as f:
        w = IvfWriter(f, b"VP90", W, H, 30, 1)
        w.write_frame(keyframe[0], 0)
        for i, (fw, fh, moving) in enumerate(FRAMES):
            w.write_frame(write_inter_zeromv_frame(
                fw, fh, profile=1, mv_fn=mv if moving else None), i + 1)
        w.close()
    subprocess.run([ORACLE_BIN, "decode", str(ivf), str(md5), "codec=vp9"],
                   check=True)
    golden = [ln.split()[0] for ln in md5.read_text().splitlines()]
    assert len(golden) == 1 + len(FRAMES), f"{name}: {len(golden)} frames"
    got = subprocess.run(
        [sys.executable, "-m", "cuda_vp9_tpu.tools.vpxdec", str(ivf),
         "--md5"], cwd=ROOT, check=True, capture_output=True,
        text=True).stdout
    have = [ln.split()[0] for ln in got.splitlines()]
    same = sum(a == b for a, b in zip(golden, have))
    ok = len(have) == len(golden) == same
    print(f"{name}: {ivf.stat().st_size} bytes, {len(golden)} frames; JAX "
          f"package vs libavcodec: {same} of {len(golden)} MD5s equal"
          + ("" if ok else " -- MISMATCH"))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out",
                    default=str(ROOT / "tests" / "fixtures" / "large"))
    args = ap.parse_args(argv)
    build_oracle()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    return 0 if all([make(out, n, f) for n, f in STREAMS.items()]) else 1


if __name__ == "__main__":
    sys.exit(main())
