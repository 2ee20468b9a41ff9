"""Make the 4:4:0 fixtures in tests/fixtures/large/: p1_05_176x144_440
(8-bit, profile 1, 10 frames), p3_02_176x144_440_10b (10-bit, profile 3,
6 frames) and p1_06_640x360_440 (8-bit, 10 frames, at most 300 KB).

The content is synthetic, made with numpy from a fixed seed (`yuv`).
libvpx encodes it through a copy of `tools/oracle/oracle.c`, written into build/oracle440/
with three changes: `pixfmt=440` picks AV_PIX_FMT_YUV440P (and its
10/12-bit forms), and the raw input's chroma planes are w x (h+1)/2.  Each
change must match the source exactly once.  The golden MD5s come from the
unmodified `tools/oracle/oracle decode` (libavcodec's native VP9
decoder), held against libavcodec's libvpx-vp9 decoder.  Then every stream
is decoded through the JAX package (`python -m cuda_vp9_tpu.tools.vpxdec
--md5`, which reconstructs 4:4:0 on its host oracle); the script exits 1
if any MD5 differs from libavcodec's.  It also asserts that every frame of
p1_05 has a loop-filter level and that some inter frame of it codes
intra blocks.

    python tools/make_440.py [--out tests/fixtures/large] [--only p1_05]

Needs gcc and the system libavcodec / libavutil (with libvpx), nothing
else.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from make_fixtures import ORACLE_BIN, ORACLE_SRC, build_oracle  # noqa: E402

BUILD = ROOT / "build" / "oracle440"
# (exact text of tools/oracle/oracle.c, its replacement)
EDITS = (
    ("      : ss == 444 ? (bitdepth == 12 ? AV_PIX_FMT_YUV444P12LE\n",
     "      : ss == 440 ? (bitdepth == 12 ? AV_PIX_FMT_YUV440P12LE\n"
     "                   : bitdepth == 10 ? AV_PIX_FMT_YUV440P10LE\n"
     "                                    : AV_PIX_FMT_YUV440P)\n"
     "      : ss == 444 ? (bitdepth == 12 ? AV_PIX_FMT_YUV444P12LE\n"),
    ("    int cw_full = ss == 444 ? w : (w + 1) / 2;\n",
     "    int cw_full = ss == 444 || ss == 440 ? w : (w + 1) / 2;\n"),
    ("    int ch_full = ss == 420 ? (h + 1) / 2 : h;\n",
     "    int ch_full = ss == 420 || ss == 440 ? (h + 1) / 2 : h;\n"),
)
# name: (w, h, frames, bit depth, profile, encoder options, whether every
# frame must have a loop-filter level and some inter frame intra blocks)
STREAMS = {
    "p1_05_176x144_440": (176, 144, 10, 8, 1,
                          ["gop=9999", "crf=36", "cpu_used=2"], True),
    "p3_02_176x144_440_10b": (176, 144, 6, 10, 3,
                              ["gop=9999", "crf=36", "cpu_used=2"], False),
    "p1_06_640x360_440": (640, 360, 10, 8, 1,
                          ["gop=9999", "crf=36", "cpu_used=4"], False),
}
MAX_BYTES = {"p1_06_640x360_440": 300_000}


def build_encoder() -> Path:
    """build/oracle440/oracle: the oracle with pixfmt=440."""
    src = Path(ORACLE_SRC).read_text()
    for old, new in EDITS:
        n = src.count(old)
        assert n == 1, f"oracle.c: {old.strip()!r} matched {n} times"
        src = src.replace(old, new)
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "oracle.c").write_text(src)
    exe = BUILD / "oracle"
    subprocess.run(["gcc", "-O2", "-o", str(exe), str(BUILD / "oracle.c"),
                    "-lavcodec", "-lavutil"], check=True)
    return exe


def yuv(w: int, h: int, n: int, bd: int, cw: int, ch: int,
        seed: int = 2026) -> bytes:
    """n frames of raw planar video, luma w x h and chroma cw x ch, bd bits
    (little-endian 16-bit words above 8): a moving gradient and sinusoid,
    a noise texture that translates by 1.5 and 1 pixels per frame (sub-pel
    motion), fresh noise in every frame (residual everywhere, so that every
    frame gets a loop-filter level), and a flat disc that moves and fades
    (intra blocks in inter frames)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    dt = np.dtype("<u2") if bd > 8 else np.dtype(np.uint8)
    tex = rng.normal(0.0, 10.0, (h + 64, w + 64))
    ctex = rng.normal(0.0, 5.0, (ch + 32, cw + 32))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = np.mgrid[0:ch, 0:cw].astype(np.float64)
    sy, sx = ch / h, cw / w
    out = bytearray()
    for t in range(n):
        ox, oy = int(1.5 * t), t
        y = (xx + yy + 24.0 * t) * (200.0 / (w + h)) + 20.0 \
            + 30.0 * np.sin((xx - 6.0 * t) / 17.0) * np.cos(yy / 23.0) \
            + tex[oy:oy + h, ox:ox + w] + rng.normal(0.0, 4.0, (h, w))
        y[(xx - w * (0.3 + 0.05 * t)) ** 2 + (yy - h / 2) ** 2
          < (h / 6) ** 2] = 230 - 10 * t
        u = 128 + 40.0 * np.sin((cx / sx + 3.0 * t) / 23.0) \
            + ctex[int(oy * sy):int(oy * sy) + ch,
                   int(ox * sx):int(ox * sx) + cw]
        v = 128 + 40.0 * np.cos((cy / sy - 2.0 * t) / 21.0) \
            + ctex[::-1, ::-1][:ch, :cw]
        for p in (y, u, v):
            out += np.clip(np.rint(p * (maxv / 255)), 0, maxv) \
                .astype(dt).tobytes()
    return bytes(out)


def frame_stats(ivf: Path):
    """Per frame (keyframe, loop-filter level, whether it is an inter frame
    with intra blocks), from the JAX package's parser and host oracle."""
    from cuda_vp9_tpu.containers import IvfReader
    from cuda_vp9_tpu.decoder import constants as C
    from cuda_vp9_tpu.decoder.frame import NativeVp9Decoder
    from cuda_vp9_tpu.ops.ref import recon as ref_recon

    stats = []

    def recon(plan, refs):
        hdr = plan.hdr
        arr = getattr(plan, "blocks_arr", None)
        rc = (arr[:, :2] if arr is not None else
              np.array([[b.mi_row, b.mi_col] for b in plan.blocks]))
        intra = bool((plan.mi.ref[rc[:, 0], rc[:, 1], 0]
                      <= C.INTRA_FRAME).any())
        stats.append((hdr.frame_type == C.KEY_FRAME, hdr.lf.filter_level,
                      intra and not hdr.frame_is_intra_only))
        return ref_recon.reconstruct_frame(plan, refs)

    dec = NativeVp9Decoder(recon_fn=recon)
    with IvfReader(str(ivf)) as r:
        for data, _ in r:
            dec.decode(data)
    return stats


def make(exe: Path, out: Path, name: str) -> bool:
    """Encode one stream, write its golden MD5s, and hold the JAX package
    against them; False on a mismatch."""
    w, h, n, bd, profile, opts, busy = STREAMS[name]
    ivf, md5 = out / f"{name}.ivf", out / f"{name}.md5"
    raw = BUILD / f"{name}.yuv"
    raw.write_bytes(yuv(w, h, n, bd, w, (h + 1) // 2))
    subprocess.run([str(exe), "encode", str(w), str(h), str(raw), str(ivf),
                    "pixfmt=440", f"profile={profile}", f"bitdepth={bd}"]
                   + opts, check=True)
    raw.unlink()
    subprocess.run([ORACLE_BIN, "decode", str(ivf), str(md5), "codec=vp9"],
                   check=True)
    alt = BUILD / f"{name}.libvpx.md5"
    subprocess.run([ORACLE_BIN, "decode", str(ivf), str(alt),
                    "codec=libvpx-vp9"], check=True)
    golden = md5.read_text()
    assert golden == alt.read_text(), f"{name}: libavcodec's decoders differ"
    size = ivf.stat().st_size
    assert golden.count("\n") == n, f"{name}: {golden.count(chr(10))} frames"
    assert size <= MAX_BYTES.get(name, size), f"{name}: {size} bytes"
    stats = frame_stats(ivf)
    print(f"{name}: keyframes {[i for i, s in enumerate(stats) if s[0]]}, "
          f"filter levels {[s[1] for s in stats]}, inter frames with intra "
          f"blocks {[i for i, s in enumerate(stats) if s[2]]}")
    if busy:
        assert sum(s[0] for s in stats) == 1, f"{name}: one keyframe"
        assert all(s[1] > 0 for s in stats), f"{name}: a frame has level 0"
        assert any(s[2] for s in stats), f"{name}: no intra block in an " \
            "inter frame"
    got = subprocess.run(
        [sys.executable, "-m", "cuda_vp9_tpu.tools.vpxdec", str(ivf),
         "--md5"], cwd=ROOT, check=True, capture_output=True,
        text=True).stdout
    want = [ln.split()[0] for ln in golden.splitlines()]
    have = [ln.split()[0] for ln in got.splitlines()]
    same = sum(a == b for a, b in zip(want, have))
    ok = len(have) == len(want) == same
    print(f"{name}: {size} bytes, {n} frames; JAX package vs libavcodec: "
          f"{same} of {len(want)} MD5s equal{'' if ok else ' -- MISMATCH'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out",
                    default=str(ROOT / "tests" / "fixtures" / "large"))
    ap.add_argument("--only", default="",
                    help="comma-separated stream names or prefixes")
    args = ap.parse_args(argv)
    build_oracle()
    exe = build_encoder()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    only = [s for s in args.only.split(",") if s]
    names = [n for n in STREAMS
             if not only or any(n.startswith(s) for s in only)]
    return 0 if all([make(exe, out, n) for n in names]) else 1


if __name__ == "__main__":
    sys.exit(main())
