"""vp9_spatial_svc_encoder parity: n-spatial-layer VP9 SVC to IVF.

Reference: libvpx/examples/vp9_spatial_svc_encoder.c (+
svc_encodeframe.c).  Each temporal instant becomes one superframe of
n_layers frames; layer i predicts inter-layer from layer i-1's
reconstruction via scaled-reference MC.  Only the top layer is shown.

Usage:
  python -m cuda_vp9_torch.tools.vp9_spatial_svc_encoder in.{y4m,yuv} \
      -o out.ivf [--width W --height H] [--layers N] [--qindex Q]
      [--gop N] [--limit N]
"""

from __future__ import annotations

import argparse
import sys
import time

from ..containers.ivf import IvfWriter
from ..containers.y4m import open_raw_video
from ..encoder.svc import Vp9SvcEncoder


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vp9_spatial_svc_encoder",
                                 description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--layers", type=int, default=2, choices=(2, 3, 4))
    ap.add_argument("--qindex", type=int, default=120)
    ap.add_argument("--gop", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    src = open_raw_video(args.input, args.width, args.height, 8)
    if getattr(src, "ss_x", 1) != 1 or getattr(src, "ss_y", 1) != 1:
        print("svc encoder: only 4:2:0 input is supported",
              file=sys.stderr)
        return 1
    w, h = src.width, src.height
    enc = Vp9SvcEncoder(w, h, n_layers=args.layers,
                        base_qindex=args.qindex, gop=args.gop)
    print("layer dims:", enc.layer_dims, file=sys.stderr)

    t0 = time.monotonic()
    n = total = 0
    with open(args.output, "wb") as f:
        fps = getattr(src, "fps", (30, 1))
        writer = IvfWriter(f, b"VP90", w, h, fps[0], fps[1])
        for planes in src:
            payload = enc.encode_frame(planes)
            writer.write_frame(payload, n)
            total += len(payload)
            n += 1
            if args.limit and n >= args.limit:
                break
        writer.close()
    dt = time.monotonic() - t0
    print(f"encoded {n} superframes x {args.layers} layers, "
          f"{total} bytes, {n / dt:.2f} fps" if n else "no frames",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
