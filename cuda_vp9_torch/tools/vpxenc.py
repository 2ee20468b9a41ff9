"""vpxenc parity: encode raw video to VP9/VP8 in IVF or WebM.

Reference: libvpx/vpxenc.c + vp9/vp9_cx_iface.c.  Fixed-QP encoding;
--kf-max-dist > 1 codes single-reference ZEROMV/LAST inter frames with
intra fallback between keyframes.  .y4m or raw I420 input; IVF output, or WebM when the output
path ends in .webm (--codec=vp8 selects the VP8 encoder).

Usage:
  python -m cuda_vp9_torch.tools.vpxenc in.{y4m,yuv} -o out.ivf
         [--width W --height H] [--qindex Q] [--lossless]
         [--block-size {8,16,32,64}] [--limit N] [--bit-depth {8,10,12}]
         [--kf-max-dist N] [--no-mode-search] [--psnr]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..containers.ivf import IvfWriter
from ..containers.y4m import open_raw_video
from ..decoder import constants as C
from ..encoder import Vp9Encoder

_BSIZE = {8: C.BLOCK_8X8, 16: C.BLOCK_16X16,
          32: C.BLOCK_32X32, 64: C.BLOCK_64X64}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vpxenc", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--codec", choices=("vp9", "vp8"), default="vp9")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--qindex", type=int, default=60,
                    help="base quantizer index 1..255 (0 with --lossless)")
    ap.add_argument("--lossless", action="store_true")
    ap.add_argument("--block-size", type=int, default=16,
                    choices=sorted(_BSIZE))
    ap.add_argument("--limit", type=int, default=0, metavar="N")
    ap.add_argument("--bit-depth", type=int, default=0,
                    choices=(0, 8, 10, 12),
                    help="0 = take from the input")
    ap.add_argument("--kf-max-dist", type=int, default=1, metavar="N",
                    help="keyframe interval; N>1 codes motion-searched "
                         "LAST inter frames between keyframes "
                         "(default 1 = all-intra)")
    ap.add_argument("--target-bitrate", type=int, default=0, metavar="K",
                    help="one-pass rate control toward K kbit/s "
                         "(0 = fixed QP at --qindex)")
    ap.add_argument("--passes", type=int, default=1, choices=(1, 2),
                    help="2 = first-pass complexity analysis drives "
                         "per-frame bit allocation and scene-cut "
                         "keyframes (needs --target-bitrate)")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="frame rate for rate control (default 30)")
    ap.add_argument("--no-mode-search", action="store_true",
                    help="force DC_PRED (faster, lower quality)")
    ap.add_argument("--aq-mode", type=int, default=0, choices=(0, 1),
                    help="1 = variance-based adaptive quantization: "
                         "per-frame segment maps boost flat areas and "
                         "relax textured ones (vp9 aq-mode=1 shape; "
                         "vp9-only)")
    ap.add_argument("--psnr", action="store_true",
                    help="print per-frame Y PSNR vs the source")
    args = ap.parse_args(argv)

    src = open_raw_video(args.input, args.width, args.height,
                         args.bit_depth or 8)
    if getattr(src, "ss_x", 1) != 1 or getattr(src, "ss_y", 1) != 1:
        print("vpxenc: only 4:2:0 input is supported", file=sys.stderr)
        return 1
    bd = args.bit_depth or getattr(src, "bit_depth", 8)
    w, h = src.width, src.height

    if args.codec == "vp8":
        if bd != 8:
            print("vpxenc: vp8 is 8-bit only", file=sys.stderr)
            return 1
        from ..vp8.encoder import Vp8Encoder
        enc = Vp8Encoder(w, h, qindex=min(args.qindex, 127),
                         filter_level=20,
                         bitrate_kbps=args.target_bitrate, fps=args.fps,
                         kf_interval=max(args.kf_max_dist, 1))
    else:
        enc = Vp9Encoder(w, h, base_qindex=args.qindex, bit_depth=bd,
                         block_size=_BSIZE[args.block_size],
                         lossless=args.lossless,
                         mode_search=not args.no_mode_search,
                         gop=args.kf_max_dist,
                         target_bitrate_kbps=args.target_bitrate,
                         fps=args.fps)

    # ---- two-pass: first-pass stats -> per-frame bit allocation
    # (vp9/encoder/vp9_firstpass.c's coded_error/intra_error shape)
    stats = None
    if args.passes == 2:
        if not args.target_bitrate:
            print("vpxenc: --passes=2 needs --target-bitrate",
                  file=sys.stderr)
            return 1
        if args.codec == "vp8":
            print("vpxenc: --passes=2 is vp9-only", file=sys.stderr)
            return 1
        stats = []
        prev = None
        for planes in src:
            y = np.asarray(planes[0], np.int64)
            intra_err = float(np.abs(y - int(y.mean())).mean())
            inter_err = (float(np.abs(y - prev).mean())
                         if prev is not None else intra_err)
            stats.append((intra_err, inter_err))
            prev = y
            if args.limit and len(stats) >= args.limit:
                break
        src = open_raw_video(args.input, args.width, args.height,
                             args.bit_depth or 8)   # rewind for pass 2
        total_budget = (args.target_bitrate * 1000.0 / 8.0
                        * len(stats) / args.fps)
        # scene cut when inter prediction stops paying (fp.c kf logic)
        keys = [i == 0 or (s[1] > 0.9 * s[0] and s[1] > 12.0)
                for i, s in enumerate(stats)]
        weights = [(4.0 if keys[i] else 1.0)
                   * (0.2 + stats[i][0 if keys[i] else 1])
                   for i in range(len(stats))]
        wsum = sum(weights) or 1.0
        targets = [total_budget * wt / wsum for wt in weights]

    t0 = time.monotonic()
    n = 0
    total_bytes = 0
    is_webm = args.output.lower().endswith(".webm")

    def _is_key(payload: bytes) -> bool:
        """Sniff the (sub)frame type from the first payload byte."""
        if args.codec == "vp8":
            return (payload[0] & 1) == 0
        # VP9 profile 0/2 bit layout: marker(2) p0 p1 show_existing
        # frame_type show_frame ... (frame_type 0 = keyframe)
        return (payload[0] & 0x0C) == 0

    with open(args.output, "wb") as f:
        fps = getattr(src, "fps", (30, 1))
        if is_webm:
            from ..containers.webm import WebmWriter
            writer = WebmWriter(f, args.codec, w, h, fps[0], fps[1])
        else:
            fourcc = b"VP80" if args.codec == "vp8" else b"VP90"
            writer = IvfWriter(f, fourcc, w, h, fps[0], fps[1])
        for planes in src:
            if args.aq_mode and args.codec == "vp9":
                enc.set_segmentation(*variance_aq_map(enc, planes[0]))
            if stats is not None and n < len(targets):
                enc.next_frame_target = targets[n]
                payload = enc.encode_frame(planes, force_key=keys[n])
            else:
                payload = enc.encode_frame(planes)
            if is_webm:
                writer.write_frame(payload, n, _is_key(payload))
            else:
                writer.write_frame(payload, n)
            total_bytes += len(payload)
            if args.psnr:
                rec = enc_last_y(enc, h, w)
                d = rec.astype(np.float64) - np.asarray(
                    planes[0], np.float64)
                mse = (d * d).mean()
                p = 99.0 if mse == 0 else 10 * np.log10(
                    ((1 << bd) - 1) ** 2 / mse)
                print(f"frame {n}: {len(payload)} B  Y-PSNR {p:.2f} dB")
            n += 1
            if args.limit and n >= args.limit:
                break
        writer.close()
    dt = time.monotonic() - t0
    print(f"encoded {n} frames, {total_bytes} bytes, "
          f"{n / dt:.2f} fps" if n else "no frames", file=sys.stderr)
    return 0


def enc_last_y(enc, h, w):
    """Cropped luma of the encoder's in-loop reconstruction."""
    return enc._last_recon[0][:h, :w] if enc._last_recon else None


def variance_aq_map(enc, y_plane):
    """Variance-based AQ (vp9_aq_variance.c shape): per coding block,
    low-variance (flat) areas get a quality boost, high-variance
    (textured) areas relax — noise masks quantization there.  Returns
    (seg_map [mi_rows, mi_cols], per-segment q deltas)."""
    y = np.asarray(y_plane, np.float64)
    h, w = y.shape
    bs = 8  # per-mi granularity
    mr, mc = enc.mi_rows, enc.mi_cols
    pad = np.zeros((mr * bs, mc * bs), np.float64)
    pad[:h, :w] = y
    blocks = pad.reshape(mr, bs, mc, bs).transpose(0, 2, 1, 3)
    var = blocks.var(axis=(2, 3))
    lo, hi = np.percentile(var, (25, 75))
    seg = np.ones((mr, mc), np.int32)
    seg[var <= lo] = 0          # flat: boost quality
    seg[var >= hi] = 2          # textured: relax
    return seg, [-16, 0, 16]


if __name__ == "__main__":
    sys.exit(main())
