"""tiny_ssim parity: per-frame and global PSNR/SSIM between two raw
YUV (I420) files or a decoded stream and a raw file, as torch ops on a
device.

Reference behavior: libvpx/tools/tiny_ssim.c — SSIM is the mean of
8x8-window similarities sampled every 4 pixels (ssim2 :272,
ssim_8x8 :255, similarity :226 with the cc1/cc2 constants scaled by
count^2 >> 12), PSNR from summed squared error (mse2psnr :79, capped
at 100 dB).  The window sums and the SSE are int64 on the device, the
similarities float64; the same windows and aggregation as the C tool.

Usage:
    python -m cuda_vp9_torch.tools.tiny_ssim a.yuv b.yuv WxH [--device cuda]
    python -m cuda_vp9_torch.tools.tiny_ssim a.ivf b.yuv      # decode a
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .metrics import _planes, check_device, read_frames, window_sums_8x8

MAX_PSNR = 100.0
_CC = {8: (26634, 239708), 10: (428658, 3857925),
       12: (6857236, 61862325)}


def _ssim2(x: torch.Tensor, y: torch.Tensor, bd: int) -> float:
    h, w = x.shape
    if h < 8 or w < 8:
        return 1.0
    s, r, ss, rr, sr = window_sums_8x8(x, y)
    count = 64
    cc1, cc2 = _CC[bd]
    c1 = (cc1 * count * count) >> 12
    c2 = (cc2 * count * count) >> 12
    f64 = torch.float64
    s = s.to(f64)
    r = r.to(f64)
    n = (2.0 * s * r + c1) * (2.0 * count * sr.to(f64) - 2.0 * s * r + c2)
    d = (s * s + r * r + c1) * (count * ss.to(f64) - s * s
                                + count * rr.to(f64) - r * r + c2)
    return float((n / d).mean())


def ssim2(a, b, bd=8, device="cuda"):
    """tools/tiny_ssim.c ssim2: mean 8x8-window SSIM, 4-px sampling."""
    x, y = _planes([a, b], device)
    return _ssim2(x, y, bd)


def mse2psnr(samples, peak, mse):
    if mse > 0.0:
        psnr = 10.0 * np.log10(peak * peak * samples / mse)
    else:
        psnr = MAX_PSNR
    return min(psnr, MAX_PSNR)


def frame_metrics(planes_a, planes_b, bd=8, device="cuda"):
    """(psnr, ssim_y, ssim_u, ssim_v, sse, samples) for one frame."""
    peak = (1 << bd) - 1
    ta, tb = _planes(planes_a, device), _planes(planes_b, device)
    sse = 0
    n = 0
    ssims = []
    for pa, pb in zip(ta, tb):
        d = pa - pb
        sse += int((d * d).sum())
        n += d.numel()
        ssims.append(_ssim2(pa, pb, bd))
    return mse2psnr(n, peak, sse), ssims[0], ssims[1], ssims[2], sse, n


def _frames_of(path, size, bd, device):
    w = h = 0
    if not path.endswith((".ivf", ".webm")):
        if not size:
            raise SystemExit("raw .yuv inputs need an explicit WxH size")
        w, h = (int(v) for v in size.split("x"))
    yield from read_frames(path, w, h, bd, device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tiny_ssim", description=__doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("size", nargs="?", default=None, metavar="WxH",
                    help="frame size (required for raw .yuv inputs)")
    ap.add_argument("--bd", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the metrics and of the decode "
                         "(default cuda)")
    args = ap.parse_args(argv)
    try:
        dev = check_device(args.device)
    except RuntimeError as e:
        print(f"tiny_ssim: {e}", file=sys.stderr)
        return 1

    ssim_t = np.zeros(3)
    sse_t = 0
    n_t = 0
    nf = 0
    for fa, fb in zip(_frames_of(args.file1, args.size, args.bd, dev),
                      _frames_of(args.file2, args.size, args.bd, dev)):
        psnr, sy, su, sv, sse, n = frame_metrics(fa, fb, args.bd, dev)
        print(f"Frame {nf}: psnr={psnr:.4f} ssim_y={sy:.6f} "
              f"ssim_u={su:.6f} ssim_v={sv:.6f}")
        ssim_t += (sy, su, sv)
        sse_t += sse
        n_t += n
        nf += 1
    if nf == 0:
        print("no frames", file=sys.stderr)
        return 1
    peak = (1 << args.bd) - 1
    print(f"PSNR: {mse2psnr(n_t, peak, sse_t):.6f}")
    print(f"SSIM-Y: {ssim_t[0] / nf:.6f}")
    print(f"SSIM-U: {ssim_t[1] / nf:.6f}")
    print(f"SSIM-V: {ssim_t[2] / nf:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
