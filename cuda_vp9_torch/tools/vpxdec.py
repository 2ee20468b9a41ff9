"""vpxdec for the port: decode an IVF or WebM stream through the codec API,
VP9 with `vp9_dx_torch(device)` and VP8 with `vp8_dx()` (on the host).

Usage:
  python -m cuda_vp9_torch.tools.vpxdec in.ivf [--md5] [--device cuda]
         [-o out.y4m|out.yuv] [--limit N] [-t T] [--summary]

The codec is chosen by the IVF fourcc, as vpxdec.c probes its input:
VP80 takes `vp8_dx()`, which decodes on the host whatever --device says;
anything else takes `vp9_dx_torch(device)`.  --md5 prints one
`<md5>  img-WxH-NNNN.i420` line per frame, the lines of
`cuda_vp9_tpu/tools/vpxdec.py --md5` and of the golden
`tests/fixtures/*.md5` files; above 8 bits each sample is hashed as two
little-endian bytes, as libvpx's vpxdec does.  -o writes the frames:
raw planes to a `.yuv` file, or a `.y4m` file with one
`YUV4MPEG2 W H F30:1 Ip A1:1 C<tag>` header and `FRAME` before each
frame, the tag being the image's chroma format (420, 422, 444, 440) with
`p10`/`p12` above 8 bits; samples above 8 bits are written as two
little-endian bytes, so each frame's bytes in the file hash to its --md5
line.  -t/--threads parses each frame with T tile threads (vpxdec -t;
default 1), and --summary prints `N frames in S s (where; F fps)` to
stderr at the end, where says which codec ran and where: the VP9 frames
on the device and on the host, or that VP8 was decoded on the host.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from collections import deque
from contextlib import ExitStack

from ..codec import (CodecCtx, DecCfg, FrameIter, vp8_dx, vp9_dx_torch,
                     vpx_codec_dec_init, vpx_codec_decode, vpx_codec_destroy,
                     vpx_codec_get_frame)
from ..containers import is_vp8, open_video
from ..utils.md5 import frame_bytes

# frames held back before printing, so the output ring is fetched in one
# device-to-host copy per ring of frames
LAG = 32
# Y4M colour tag of each (x_chroma_shift, y_chroma_shift)
Y4M_CHROMA = {(1, 1): "420", (1, 0): "422", (0, 0): "444", (0, 1): "440"}


def y4m_header(img) -> bytes:
    """The Y4M stream header for frames like `img`."""
    c = Y4M_CHROMA[(img.x_chroma_shift, img.y_chroma_shift)]
    if img.bit_depth > 8:
        c += f"p{img.bit_depth}"
    return f"YUV4MPEG2 W{img.d_w} H{img.d_h} F30:1 Ip A1:1 C{c}\n".encode()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vpxdec", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("--md5", action="store_true",
                    help="print per-frame MD5 (decode_to_md5 format)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the VP9 frame step (default cuda)")
    ap.add_argument("-o", "--output", default=None,
                    help="write frames (.y4m, else raw planes)")
    ap.add_argument("--limit", type=int, default=0, metavar="N",
                    help="stop after N frames")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="tile-parallel host parse threads (vpxdec -t)")
    ap.add_argument("--summary", action="store_true",
                    help="print decode rate summary")
    args = ap.parse_args(argv)

    vp8 = is_vp8(args.input)
    iface = vp8_dx() if vp8 else vp9_dx_torch(args.device)
    ctx = CodecCtx()
    if vpx_codec_dec_init(ctx, iface, DecCfg(threads=args.threads)) != 0:
        print(f"failed to init decoder: {ctx.err_detail}", file=sys.stderr)
        return 1
    with ExitStack() as stack:
        out = None
        if args.output:
            out = stack.enter_context(open(args.output, "wb"))
        y4m = bool(args.output) and args.output.endswith(".y4m")
        n = 0
        q = deque()
        t0 = time.time()

        def consume(img):
            nonlocal n
            n += 1
            if not args.md5 and out is None:
                return
            buf = frame_bytes(img.planes)
            if args.md5:
                print(f"{hashlib.md5(buf).hexdigest()}  img-{img.d_w}x"
                      f"{img.d_h}-{n:04d}.i420")
            if out is not None:
                if y4m:
                    if n == 1:
                        out.write(y4m_header(img))
                    out.write(b"FRAME\n")
                out.write(buf)

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
    dt = time.time() - t0
    if args.summary:
        if vp8:
            where = "VP8, decoded on the host"
        else:
            rec = ctx._recon
            where = (f"VP9, frames on device {rec.frames_on_device}, on "
                     f"host {rec.frames_on_host}")
        print(f"{n} frames in {dt:.2f}s ({where}; {n / dt:.2f} fps)",
              file=sys.stderr)
    vpx_codec_destroy(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
