"""Make tests/fixtures/large/hb01_1920x1080_10b.{ivf,md5}: a 10-bit 4:2:0
stream at 1920x1080, one keyframe then two inter frames.

The content is synthetic, made with numpy from a fixed seed: a diagonal
gradient and a sinusoid that move between frames, a noise texture that
translates by a whole and a half pixel per frame (so motion compensation
engages, sub-pel included), and a little fresh noise in every frame (so
every frame carries residual).  The repo's own encoder codes it
(`cuda_vp9_tpu.encoder.Vp9Encoder`, profile 2), and the golden MD5s come
from the JAX package's NumPy oracle decoder.

    python tools/make_hb01.py [--out tests/fixtures/large] [--frames 3]

Takes minutes on a CPU: the encoder is pure Python.  The stream lives in
`tests/fixtures/large/`, outside the sweeps of the JAX package's tests,
which run every `tests/fixtures/*.ivf` in their fast tier.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cuda_vp9_tpu.containers.ivf import IvfWriter  # noqa: E402
from cuda_vp9_tpu.decoder import constants as C  # noqa: E402
from cuda_vp9_tpu.encoder import Vp9Encoder  # noqa: E402

NAME = "hb01_1920x1080_10b"
W, H, BD = 1920, 1080, 10


def frames(n: int, seed: int = 2026):
    """n frames of [y, u, v] uint16 planes in [0, 2^BD)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << BD) - 1
    tex = rng.normal(0.0, 40.0, (H + 64, W + 64))
    ctex = rng.normal(0.0, 20.0, (H // 2 + 32, W // 2 + 32))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2].astype(np.float64)
    out = []
    for t in range(n):
        # texture window moves 1.5 px right and 1 px down per frame
        ox, oy = int(1.5 * t), t
        grad = (xx + yy + 24.0 * t) * (maxv / (W + H))
        wave = 90.0 * np.sin((xx - 6.0 * t) / 47.0) * np.cos(yy / 61.0)
        y = grad * 0.8 + wave + tex[oy:oy + H, ox:ox + W] + 100.0
        y += rng.normal(0.0, 4.0, (H, W))
        u = 512 + 160 * np.sin((cx + 3.0 * t) / 83.0) \
            + ctex[oy // 2:oy // 2 + H // 2, ox // 2:ox // 2 + W // 2]
        v = 512 + 160 * np.cos((cy - 2.0 * t) / 71.0) \
            + ctex[::-1, ::-1][:H // 2, :W // 2]
        out.append([np.clip(np.rint(p), 0, maxv).astype(np.uint16)
                    for p in (y, u, v)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out",
                    default=str(ROOT / "tests" / "fixtures" / "large"))
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--qindex", type=int, default=120)
    args = ap.parse_args(argv)
    ivf = Path(args.out) / f"{NAME}.ivf"
    enc = Vp9Encoder(W, H, base_qindex=args.qindex, bit_depth=BD,
                     block_size=C.BLOCK_16X16, gop=args.frames)
    with open(ivf, "wb") as f:
        writer = IvfWriter(f, b"VP90", W, H, 30, 1)
        for i, planes in enumerate(frames(args.frames)):
            t0 = time.monotonic()
            payload = enc.encode_frame(planes)
            writer.write_frame(payload, i)
            print(f"frame {i}: {len(payload)} bytes, "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        writer.close()
    md5 = subprocess.run(
        [sys.executable, "-m", "cuda_vp9_tpu.tools.vpxdec", str(ivf),
         "--md5", "--host-recon"], cwd=ROOT, check=True,
        capture_output=True, text=True).stdout
    (Path(args.out) / f"{NAME}.md5").write_text(md5)
    print(f"{ivf}: {ivf.stat().st_size} bytes\n{md5}", end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
