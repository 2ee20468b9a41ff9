"""vpxdec for the torch backend: decode an IVF VP9 stream through the
codec API with `vp9_dx_torch(device)`.

Usage:
  python -m cuda_vp9_torch.tools.vpxdec in.ivf --md5 [--device cuda]
         [--limit N]

--md5 prints one `<md5>  img-WxH-NNNN.i420` line per frame, the lines of
`cuda_vp9_tpu/tools/vpxdec.py --md5` and of the golden
`tests/fixtures/*.md5` files; above 8 bits each sample is hashed as two
little-endian bytes, as libvpx's vpxdec does.
"""

from __future__ import annotations

import argparse
import sys
from collections import deque

from ..codec import (CodecCtx, DecCfg, FrameIter, vp9_dx_torch,
                     vpx_codec_dec_init, vpx_codec_decode, vpx_codec_destroy,
                     vpx_codec_get_frame)
from ..containers import open_video
from ..utils.md5 import frame_md5

# frames held back before printing, so the output ring is fetched in one
# device-to-host copy per ring of frames
LAG = 32


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vpxdec", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("--md5", action="store_true",
                    help="print per-frame MD5 (decode_to_md5 format)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the frame step (default cuda)")
    ap.add_argument("--limit", type=int, default=0, metavar="N",
                    help="stop after N frames")
    args = ap.parse_args(argv)

    ctx = CodecCtx()
    if vpx_codec_dec_init(ctx, vp9_dx_torch(args.device), DecCfg()) != 0:
        print(f"failed to init decoder: {ctx.err_detail}", file=sys.stderr)
        return 1
    n = 0
    q = deque()

    def consume(img):
        nonlocal n
        n += 1
        if args.md5:
            print(f"{frame_md5(img.planes)}  img-{img.d_w}x{img.d_h}-"
                  f"{n:04d}.i420")

    def done():
        return bool(args.limit) and n >= args.limit

    with open_video(args.input) as r:
        for data, _pts in r:
            if vpx_codec_decode(ctx, data) != 0:
                print(f"decode error: {ctx.err_detail}", file=sys.stderr)
                return 1
            it = FrameIter()
            while (img := vpx_codec_get_frame(ctx, it)) is not None:
                q.append(img)
            while len(q) > LAG and not done():
                consume(q.popleft())
            if done():
                break
    while q and not done():
        consume(q.popleft())
    vpx_codec_destroy(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
