"""Full quality-metric suite as torch ops on a device: PSNR, SSIM,
FastSSIM (multi-scale) and PSNR-HVS-M between two I420 videos (raw YUV
files or decodable streams).

Parity targets (algorithms re-expressed as whole-frame tensor
arithmetic; constants and rounding follow the originals):
  - PSNR:     libvpx/vpx_dsp/psnr.c   (vpx_sse_to_psnr :17,
              vpx_calc_psnr / vpx_calc_highbd_psnr aggregation)
  - SSIM:     libvpx/vpx_dsp/ssim.c   (vpx_ssim2 :124 — 8x8 windows on
              the 4x4 grid, similarity :74 with cc1/cc2 scaled by
              count^2 >> 12; vpx_calc_ssim :168 — 0.8/0.1/0.1 weights)
  - FastSSIM: libvpx/vpx_dsp/fastssim.c (calc_ssim :455 — 4-level
              pyramid, per-level structure term from 45-degree gradient
              maps with a binomial sliding window, luminance applied at
              the coarsest level only, FS_WEIGHTS exponents,
              convert_ssim_db :447)
  - PSNR-HVS: libvpx/vpx_dsp/psnrhvs.c (calc_psnrhvs :124 — 8x8 blocks
              at step 7, integer vpx_fdct8x8, CSF weighting + contrast
              masking, 0.8/0.1/0.1 aggregate, convert_score_db :112)

Every public function takes planes (tensors or numpy arrays) and the
torch `device` to compute on (default "cuda"; a device whose backend is
absent raises, nothing falls back to the CPU).  Integer parts (sums,
the SSE, window sums, the integer DCT) stay int64; the float parts are
float64, as in the reference's double arithmetic.

The FastSSIM structure window is a fixed 2-D kernel extracted from the
sliding-column recurrence (the recurrence is linear in the gradient
energy maps, so it IS a correlation, boundaries included);
`_fs_structure_scalar` keeps the recurrence itself, the plain form the
kernel is held against.  The coarsest level's luminance
recurrence is a clamped 8x8 box sum, computed in closed form.

Usage:
    python -m cuda_vp9_torch.tools.metrics a.yuv b.yuv WxH [--device cuda]
    python -m cuda_vp9_torch.tools.metrics a.yuv b.ivf WxH   # decode b
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

MAX_PSNR = 100.0
MAX_SSIM_DB = 69.0


# --------------------------------------------------------------- device


def check_device(device) -> torch.device:
    """`device` as a torch.device, refusing a CUDA device when there is
    no card (the metrics never carry on on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but "
                           "torch.cuda.is_available() is false")
    return dev


def to_device(plane, device) -> torch.Tensor:
    """One plane (tensor or array of any integer type) as int64 on
    `device`; the copy crosses in the plane's own width."""
    if not isinstance(plane, torch.Tensor):
        a = np.ascontiguousarray(plane)
        if a.dtype == np.uint16:       # no uint16 arithmetic in torch
            a = a.astype(np.int32)
        elif not a.flags.writeable:    # a view of a read buffer
            a = a.copy()
        plane = torch.from_numpy(a)
    return plane.to(device).to(torch.int64)


def _planes(planes, device):
    dev = check_device(device)
    return [to_device(p, dev) for p in planes]


# ------------------------------------------------------------------ psnr


def sse_to_psnr(samples: float, peak: float, sse: float) -> float:
    """vpx_sse_to_psnr parity (psnr.c:17): capped at 100 dB."""
    if sse > 0.0:
        p = samples * peak * peak / sse
        return min(10.0 * math.log10(p), MAX_PSNR)
    return MAX_PSNR


def _sse(a: torch.Tensor, b: torch.Tensor, shift: int) -> torch.Tensor:
    d = (a >> shift) - (b >> shift)
    return (d * d).sum()


def plane_sse(a, b, shift: int = 0, device="cuda") -> int:
    """get_sse / highbd_get_sse_shift parity: samples are shifted DOWN
    to in_bd before differencing (psnr.c highbd_get_sse_shift)."""
    ta, tb = _planes([a, b], device)
    return int(_sse(ta, tb, shift))


def calc_psnr(planes_a, planes_b, bd: int = 8, in_bd: int = 8,
              device="cuda") -> dict:
    """vpx_calc_psnr / vpx_calc_highbd_psnr parity: per-plane and
    combined PSNR against peak = 2^in_bd - 1.  Returns {"psnr":
    [all, y, u, v], "sse": [...], "samples": [...]} matching
    PSNR_STATS (psnr.h:27)."""
    shift = bd - in_bd
    peak = float((1 << in_bd) - 1)
    ta, tb = _planes(planes_a, device), _planes(planes_b, device)
    sses = torch.stack([_sse(a, b, shift) for a, b in zip(ta, tb)]).tolist()
    samples = [a.numel() for a in ta]
    tot_sse = sum(sses)
    tot_n = sum(samples)
    return {
        "sse": [tot_sse] + sses,
        "samples": [tot_n] + samples,
        "psnr": [sse_to_psnr(tot_n, peak, tot_sse)] +
                [sse_to_psnr(n, peak, s) for n, s in zip(samples, sses)],
    }


# ------------------------------------------------------------------ ssim

# (64^2*(.01*max)^2, (64^2*(.03*max)^2 for max = 255/1023/4095 (ssim.c:66)
_SSIM_CC = {8: (26634, 239708), 10: (428658, 3857925),
            12: (6868593, 61817334)}


def window_sums_8x8(x: torch.Tensor, y: torch.Tensor):
    """Sums over 8x8 windows at every 4-px offset via integral images of
    int64 planes.  Returns (sx, sy, sxx, syy, sxy) maps of shape
    [wy, wx]."""
    h, w = x.shape
    wy = (h - 8) // 4 + 1
    wx = (w - 8) // 4 + 1

    def win(a):
        ii = torch.zeros((h + 1, w + 1), dtype=torch.int64, device=a.device)
        ii[1:, 1:] = a.cumsum(0).cumsum(1)
        tl = ii[0:4 * wy:4, 0:4 * wx:4]
        tr = ii[0:4 * wy:4, 8:8 + 4 * wx:4][:, :wx]
        bl = ii[8:8 + 4 * wy:4, 0:4 * wx:4][:wy]
        br = ii[8:8 + 4 * wy:4, 8:8 + 4 * wx:4][:wy, :wx]
        return br - tr - bl + tl

    return win(x), win(y), win(x * x), win(y * y), win(x * y)


def _ssim2(a: torch.Tensor, b: torch.Tensor, bd: int, shift: int) -> float:
    if a.shape[0] < 8 or a.shape[1] < 8:
        return 1.0
    sx, sy, sxx, syy, sxy = window_sums_8x8(a, b)
    if shift:
        sx = sx >> shift
        sy = sy >> shift
        sxx = sxx >> 2 * shift
        syy = syy >> 2 * shift
        sxy = sxy >> 2 * shift
    cc1, cc2 = _SSIM_CC[bd]
    count = 64
    c1 = (cc1 * count * count) >> 12
    c2 = (cc2 * count * count) >> 12
    f64 = torch.float64
    sx = sx.to(f64)
    sy = sy.to(f64)
    n = (2.0 * sx * sy + c1) * (2.0 * count * sxy.to(f64)
                                - 2.0 * sx * sy + c2)
    d = (sx * sx + sy * sy + c1) * (count * sxx.to(f64) - sx * sx
                                    + count * syy.to(f64) - sy * sy + c2)
    return float((n / d).mean())


def ssim2(a, b, bd: int = 8, shift: int = 0, device="cuda") -> float:
    """vpx_ssim2 / vpx_highbd_ssim2 parity (ssim.c:124,145): mean of
    8x8-window similarities sampled every 4 px."""
    ta, tb = _planes([a, b], device)
    return _ssim2(ta, tb, bd, shift)


def calc_ssim(planes_a, planes_b, bd: int = 8, in_bd: int = 8,
              device="cuda"):
    """vpx_calc_ssim parity (ssim.c:168): 0.8*y + 0.1*u + 0.1*v.
    Returns (ssim_all, weight=1.0)."""
    shift = bd - in_bd
    ta, tb = _planes(planes_a, device), _planes(planes_b, device)
    y, u, v = (_ssim2(a, b, bd, shift) for a, b in zip(ta, tb))
    return 0.8 * y + 0.1 * (u + v), 1.0


# -------------------------------------------------------------- fastssim

_FS_NLEVELS = 4
# Wang's MS-SSIM weights, finest scale dropped, renormalized
# (fastssim.c:428)
_FS_WEIGHTS = (0.2989654541015625, 0.3141326904296875,
               0.2473602294921875, 0.1395416259765625)
_SSIM_C1 = {8: 255 * 255 * 0.01 * 0.01, 10: 1023 * 1023 * 0.01 * 0.01,
            12: 4095 * 4095 * 0.01 * 0.01}
_SSIM_C2 = {8: 255 * 255 * 0.03 * 0.03, 10: 1023 * 1023 * 0.03 * 0.03,
            12: 4095 * 4095 * 0.03 * 0.03}


def _box2x2(a: torch.Tensor) -> torch.Tensor:
    """2x2 box sum with the last row and column clamped
    (fs_downsample_level0 / fs_downsample_level)."""
    h, w = a.shape
    dev = a.device
    i0 = torch.arange(0, w, 2, device=dev)
    i1 = (i0 + 1).clamp(max=w - 1)
    j0 = torch.arange(0, h, 2, device=dev)
    j1 = (j0 + 1).clamp(max=h - 1)
    r0, r1 = a.index_select(0, j0), a.index_select(0, j1)
    return (r0.index_select(1, i0) + r0.index_select(1, i1)
            + r1.index_select(1, i0) + r1.index_select(1, i1))


def _fs_gradients(a: torch.Tensor, b: torch.Tensor):
    """45-degree gradient energy maps gx, gy on an (h, w) grid (valid
    region (h-1, w-1); last row/col zero), fastssim.c:349-361."""
    def grad(x):
        g = torch.zeros_like(x)
        g1 = (x[1:, 1:] - x[:-1, :-1]).abs()
        g2 = (x[1:, :-1] - x[:-1, 1:]).abs()
        g[:-1, :-1] = 4 * torch.maximum(g1, g2) + torch.minimum(g1, g2)
        return g
    return grad(a), grad(b)


# Direct transcription of the sliding recurrence (numpy, on the host):
# the plain form the fixed kernel below is derived from and, in tests,
# held against, boundaries included.
def _fs_structure_scalar(gx: np.ndarray, gy: np.ndarray,
                         c2: float) -> np.ndarray:
    h, w = gx.shape
    stride = w + 8
    gx_buf = np.zeros((8, stride))
    gy_buf = np.zeros((8, stride))
    out = np.zeros((h, w))
    col_gx2 = np.zeros(8)
    col_gy2 = np.zeros(8)
    col_gxgy = np.zeros(8)

    def at(buf, joffs, ioffs, j, i):
        return buf[(j + joffs) & 7, i + ioffs]

    for j in range(h + 4):
        if j < h - 1:
            gx_buf[j & 7, 4:4 + w] = 0.0
            gy_buf[j & 7, 4:4 + w] = 0.0
            gx_buf[j & 7, 4:3 + w] = gx[j, :w - 1]
            gy_buf[j & 7, 4:3 + w] = gy[j, :w - 1]
        else:
            gx_buf[j & 7, :] = 0.0
            gy_buf[j & 7, :] = 0.0
        if j >= 4:
            col_gx2[:4] = col_gy2[:4] = col_gxgy[:4] = 0.0

            def cset(col, joffs, ioffs, i):
                a = at(gx_buf, joffs, ioffs, j, i)
                b = at(gy_buf, joffs, ioffs, j, i)
                col_gx2[col] = a * a
                col_gy2[col] = b * b
                col_gxgy[col] = a * b

            def cadd(col, joffs, ioffs, i):
                a = at(gx_buf, joffs, ioffs, j, i)
                b = at(gy_buf, joffs, ioffs, j, i)
                col_gx2[col] += a * a
                col_gy2[col] += b * b
                col_gxgy[col] += a * b

            def csub(col, joffs, ioffs, i):
                a = at(gx_buf, joffs, ioffs, j, i)
                b = at(gy_buf, joffs, ioffs, j, i)
                col_gx2[col] -= a * a
                col_gy2[col] -= b * b
                col_gxgy[col] -= a * b

            def cmul(col, col2, f):
                col_gx2[col] = col_gx2[col2] * f
                col_gy2[col] = col_gy2[col2] * f
                col_gxgy[col] = col_gxgy[col2] * f

            for i in range(4, 8):
                cset(i, -1, 0, i)
                cadd(i, 0, 0, i)
                for kk in range(1, 8 - i):
                    cmul(i, i, 2.0)
                    cadd(i, -kk - 1, 0, i)
                    cadd(i, kk, 0, i)
            for i in range(w):
                out[j - 4, i] = ((2 * col_gxgy.sum() + c2)
                                 / (col_gx2.sum() + col_gy2.sum() + c2))
                if i + 1 < w:
                    cset(0, -1, 1, i)
                    cadd(0, 0, 1, i)
                    csub(2, -3, 2, i)
                    csub(2, 2, 2, i)
                    cmul(1, 2, 0.5)
                    csub(3, -4, 3, i)
                    csub(3, 3, 3, i)
                    cmul(2, 3, 0.5)
                    cmul(3, 4, 1.0)
                    cmul(4, 5, 2.0)
                    cadd(4, -4, 5, i)
                    cadd(4, 3, 5, i)
                    cmul(5, 6, 2.0)
                    cadd(5, -3, 6, i)
                    cadd(5, 2, 6, i)
                    cmul(6, 7, 2.0)
                    cadd(6, -2, 7, i)
                    cadd(6, 1, 7, i)
                    cset(7, -1, 8, i)
                    cadd(7, 0, 8, i)
    return out


_FS_PAD = 8
_FS_KERNEL = None


def _fs_kernel() -> np.ndarray:
    """The effective structure window, found by pushing an impulse
    through the scalar recurrence (which is linear in the energy maps):
    a [17, 17] array K such that the window sum at output (jo, io) is
    sum K[dy + 8, dx + 8] * g2[jo + dy, io + dx]."""
    global _FS_KERNEL
    if _FS_KERNEL is None:
        n = 32
        g = np.zeros((n, n), np.int64)
        g[16, 16] = 1         # unit gradient energy (gx=1 -> gx2=1)
        # out = c2 / (wsum + c2)  =>  wsum = c2 * (1 - out) / out
        # (c2 large vs the <=2^5 weights but small enough that 1 - out
        # stays well above double epsilon)
        big = 1e6
        r = _fs_structure_scalar(g, np.zeros_like(g), big)
        w = big * (1.0 - r) / r
        k = np.zeros((2 * _FS_PAD + 1,) * 2)
        for y, x in zip(*np.nonzero(w > 0.5)):
            k[_FS_PAD + 16 - y, _FS_PAD + 16 - x] = float(round(w[y, x]))
        assert k.any()
        _FS_KERNEL = k
    return _FS_KERNEL


def _fs_structure(gx: torch.Tensor, gy: torch.Tensor,
                  c2: float) -> torch.Tensor:
    """Structure pass: one float64 correlation of the three energy maps
    (gx^2, gy^2, gx*gy) with the fixed window, zero outside the frame."""
    k = torch.as_tensor(_fs_kernel(), dtype=torch.float64, device=gx.device)
    maps = torch.stack([gx * gx, gy * gy, gx * gy]).to(torch.float64)
    s = torch.nn.functional.conv2d(maps[None], k.expand(3, 1, *k.shape),
                                   padding=_FS_PAD, groups=3)[0]
    return (2 * s[2] + c2) / (s[0] + s[1] + c2)


def _fs_luminance(a: torch.Tensor, b: torch.Tensor, level: int,
                  c1base: float) -> torch.Tensor:
    """fs_apply_luminance parity: the 8x8 box (offsets -4..3, clamped to
    the frame) of each image, whose sliding sums the reference keeps as
    running totals (exact integers here, as there in doubles).  The
    original's horizontal slide updates muy with col_sums_x
    (fastssim.c:243-244), so muy is its row's first window of im2 plus
    the change in mux along the row, replicated for parity."""
    h, w = a.shape
    c1 = c1base * 4096 * (1 << (4 * level))
    off = torch.arange(-4, 4, device=a.device)
    rows = (torch.arange(h, device=a.device)[:, None] + off).clamp(0, h - 1)
    cols = (torch.arange(w, device=a.device)[:, None] + off).clamp(0, w - 1)
    col_x = a[rows].sum(1)              # [h, w]
    col_y = b[rows].sum(1)
    mux = col_x[:, cols].sum(-1)        # [h, w]
    muy = col_y[:, cols[0]].sum(-1)[:, None] + mux - mux[:, :1]
    mux = mux.to(torch.float64)
    muy = muy.to(torch.float64)
    return (2 * mux * muy + c1) / (mux * mux + muy * muy + c1)


def _fs_calc_plane(a: torch.Tensor, b: torch.Tensor, bd: int,
                   shift: int) -> float:
    """calc_ssim parity (fastssim.c:455)."""
    ret = 1.0
    im1 = _box2x2(a >> shift)
    im2 = _box2x2(b >> shift)
    for level in range(_FS_NLEVELS):
        c2 = _SSIM_C2[bd] * (1 << (4 * level)) * 16 * 104
        gx, gy = _fs_gradients(im1, im2)
        ssim = _fs_structure(gx, gy, c2)
        if level == _FS_NLEVELS - 1:
            ssim = ssim * _fs_luminance(im1, im2, level, _SSIM_C1[bd])
        ret *= float(ssim.mean()) ** _FS_WEIGHTS[level]
        if level < _FS_NLEVELS - 1:
            im1 = _box2x2(im1)
            im2 = _box2x2(im2)
    return ret


def convert_ssim_db(ssim: float, weight: float) -> float:
    if (weight - ssim) < 1e-10:
        return MAX_SSIM_DB
    return 10 * (math.log10(weight) - math.log10(weight - ssim))


def calc_fastssim(planes_a, planes_b, bd: int = 8, in_bd: int = 8,
                  device="cuda"):
    """vpx_calc_fastssim parity: returns (db, y, u, v)."""
    shift = bd - in_bd
    ta, tb = _planes(planes_a, device), _planes(planes_b, device)
    y, u, v = (_fs_calc_plane(a, b, in_bd, shift) for a, b in zip(ta, tb))
    return convert_ssim_db(0.8 * y + 0.1 * (u + v), 1.0), y, u, v


# -------------------------------------------------------------- psnrhvs

# CSF tables (psnrhvs.c:54-110): normalized inverse quantization
# matrices for the 8x8 DCT at the point of transparency (Daala).
_CSF_Y = np.array([
    [1.6193873005, 2.2901594831, 2.08509755623, 1.48366094411,
     1.00227514334, 0.678296995242, 0.466224900598, 0.3265091542],
    [2.2901594831, 1.94321815382, 2.04793073064, 1.68731108984,
     1.2305666963, 0.868920337363, 0.61280991668, 0.436405793551],
    [2.08509755623, 2.04793073064, 1.34329019223, 1.09205635862,
     0.875748795257, 0.670882927016, 0.501731932449, 0.372504254596],
    [1.48366094411, 1.68731108984, 1.09205635862, 0.772819797575,
     0.605636379554, 0.48309405692, 0.380429446972, 0.295774038565],
    [1.00227514334, 1.2305666963, 0.875748795257, 0.605636379554,
     0.448996256676, 0.352889268808, 0.283006984131, 0.226951348204],
    [0.678296995242, 0.868920337363, 0.670882927016, 0.48309405692,
     0.352889268808, 0.27032073436, 0.215017739696, 0.17408067321],
    [0.466224900598, 0.61280991668, 0.501731932449, 0.380429446972,
     0.283006984131, 0.215017739696, 0.168869545842, 0.136153931001],
    [0.3265091542, 0.436405793551, 0.372504254596, 0.295774038565,
     0.226951348204, 0.17408067321, 0.136153931001, 0.109083846276]])
_CSF_CB = np.array([
    [1.91113096927, 2.46074210438, 1.18284184739, 1.14982565193,
     1.05017074788, 0.898018824055, 0.74725392039, 0.615105596242],
    [2.46074210438, 1.58529308355, 1.21363250036, 1.38190029285,
     1.33100189972, 1.17428548929, 0.996404342439, 0.830890433625],
    [1.18284184739, 1.21363250036, 0.978712413627, 1.02624506078,
     1.03145147362, 0.960060382087, 0.849823426169, 0.731221236837],
    [1.14982565193, 1.38190029285, 1.02624506078, 0.861317501629,
     0.801821139099, 0.751437590932, 0.685398513368, 0.608694761374],
    [1.05017074788, 1.33100189972, 1.03145147362, 0.801821139099,
     0.676555426187, 0.605503172737, 0.55002013668, 0.495804539034],
    [0.898018824055, 1.17428548929, 0.960060382087, 0.751437590932,
     0.605503172737, 0.514674450957, 0.454353482512, 0.407050308965],
    [0.74725392039, 0.996404342439, 0.849823426169, 0.685398513368,
     0.55002013668, 0.454353482512, 0.389234902883, 0.342353999733],
    [0.615105596242, 0.830890433625, 0.731221236837, 0.608694761374,
     0.495804539034, 0.407050308965, 0.342353999733, 0.295530605237]])
_CSF_CR = np.array([
    [2.03871978502, 2.62502345193, 1.26180942886, 1.11019789803,
     1.01397751469, 0.867069376285, 0.721500455585, 0.593906509971],
    [2.62502345193, 1.69112867013, 1.17180569821, 1.3342742857,
     1.28513006198, 1.13381474809, 0.962064122248, 0.802254508198],
    [1.26180942886, 1.17180569821, 0.944981930573, 0.990876405848,
     0.995903384143, 0.926972725286, 0.820534991409, 0.706020324706],
    [1.11019789803, 1.3342742857, 0.990876405848, 0.831632933426,
     0.77418706195, 0.725539939514, 0.661776842059, 0.587716619023],
    [1.01397751469, 1.28513006198, 0.995903384143, 0.77418706195,
     0.653238524286, 0.584635025748, 0.531064164893, 0.478717061273],
    [0.867069376285, 1.13381474809, 0.926972725286, 0.725539939514,
     0.584635025748, 0.496936637883, 0.438694579826, 0.393021669543],
    [0.721500455585, 0.962064122248, 0.820534991409, 0.661776842059,
     0.531064164893, 0.438694579826, 0.375820256136, 0.330555063063],
    [0.593906509971, 0.802254508198, 0.706020324706, 0.587716619023,
     0.478717061273, 0.393021669543, 0.330555063063, 0.285345396658]])

# psnrhvs.c's float constants: (1/63)*64 and (1/15)*16 in single precision
_F63 = float(np.float32(np.float32(1.0) / np.float32(63.0)) * np.float32(64.0))
_F15 = float(np.float32(np.float32(1.0) / np.float32(15.0)) * np.float32(16.0))


def _fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Integer vpx_fdct8x8_c parity, batched [N, 8, 8] int64 -> [N, 8, 8]
    (vpx_dsp/fwd_txfm.c:90; the highbd variant is the same function)."""
    from ..ops.ref.transforms import COSPI

    def rs(x):  # fdct_round_shift: ROUND_POWER_OF_TWO with DCT_BITS=14
        return (x + 8192) >> 14

    def pass1d(inp, scale):
        # inp [..., 8] along last axis
        s = [None] * 8
        for k in range(4):
            s[k] = (inp[..., k] + inp[..., 7 - k]) * scale
            s[7 - k] = (inp[..., k] - inp[..., 7 - k]) * scale
        x0 = s[0] + s[3]
        x1 = s[1] + s[2]
        x2 = s[1] - s[2]
        x3 = s[0] - s[3]
        o = [None] * 8
        o[0] = rs((x0 + x1) * COSPI[16])
        o[4] = rs((x0 - x1) * COSPI[16])
        o[2] = rs(x2 * COSPI[24] + x3 * COSPI[8])
        o[6] = rs(-x2 * COSPI[8] + x3 * COSPI[24])
        t2 = rs((s[6] - s[5]) * COSPI[16])
        t3 = rs((s[6] + s[5]) * COSPI[16])
        y0 = s[4] + t2
        y1 = s[4] - t2
        y2 = s[7] - t3
        y3 = s[7] + t3
        o[1] = rs(y0 * COSPI[28] + y3 * COSPI[4])
        o[5] = rs(y1 * COSPI[12] + y2 * COSPI[20])
        o[3] = rs(y2 * COSPI[12] - y1 * COSPI[20])
        o[7] = rs(y3 * COSPI[28] - y0 * COSPI[4])
        return torch.stack(o, dim=-1)

    x = blocks.to(torch.int64)
    # pass 1 over columns (inputs x4), then pass 2 over rows of the
    # transposed intermediate
    inter = pass1d(x.transpose(1, 2), 4)         # [N, col, vfreq]
    out = pass1d(inter.transpose(1, 2), 1)       # [N, vfreq, hfreq]
    # final /= 2 truncates toward zero in C
    neg_odd = ((out < 0) & ((out & 1) != 0)).to(torch.int64)
    return (out >> 1) + neg_odd


def _psnrhvs_plane(a: torch.Tensor, b: torch.Tensor, csf_np: np.ndarray,
                   shift: int) -> float:
    """calc_psnrhvs parity (8x8 blocks at step 7)."""
    h, w = a.shape
    dev = a.device
    f64 = torch.float64
    if h < 8 or w < 8:
        return 0.0
    ys = torch.arange(0, h - 7, 7, device=dev)
    xs = torch.arange(0, w - 7, 7, device=dev)
    csf = torch.as_tensor(csf_np, dtype=f64, device=dev)
    mask = (csf / csf[1, 0]) ** 2
    av = a >> shift
    bv = b >> shift
    # gather all blocks [N, 8, 8]
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    i8 = torch.arange(8, device=dev)
    ri = yy.reshape(-1)[:, None, None] + i8[None, :, None]
    ci = xx.reshape(-1)[:, None, None] + i8[None, None, :]
    si = av[ri, ci]
    di = bv[ri, ci]
    sb = si.to(f64)
    db = di.to(f64)
    # 4x4 quadrant index per pixel (psnrhvs.c:189)
    sub = ((i8[:, None] & 12) >> 2) + ((i8[None, :] & 12) >> 1)
    s_gmean = sb.mean(dim=(1, 2))
    d_gmean = db.mean(dim=(1, 2))
    s_gvar = ((sb - s_gmean[:, None, None]) ** 2).sum(dim=(1, 2)) * _F63
    d_gvar = ((db - d_gmean[:, None, None]) ** 2).sum(dim=(1, 2)) * _F63
    s_vars = torch.zeros((sb.shape[0], 4), dtype=f64, device=dev)
    d_vars = torch.zeros_like(s_vars)
    for q in range(4):
        m = sub == q
        sq, dq = sb[:, m], db[:, m]
        s_vars[:, q] = ((sq - sq.mean(dim=1)[:, None]) ** 2).sum(dim=1) * _F15
        d_vars[:, q] = ((dq - dq.mean(dim=1)[:, None]) ** 2).sum(dim=1) * _F15
    s_gv = torch.where(s_gvar > 0, s_vars.sum(dim=1) / s_gvar, s_gvar)
    d_gv = torch.where(d_gvar > 0, d_vars.sum(dim=1) / d_gvar, d_gvar)
    # od_bin_fdct8x8's (y + 4) >> 3 downscale
    scf = ((_fdct8x8(si) + 4) >> 3).to(f64)
    dcf = ((_fdct8x8(di) + 4) >> 3).to(f64)
    wm = torch.ones((8, 8), dtype=torch.bool, device=dev)
    wm[0, 0] = False  # DC excluded from the masking energy
    s_mask = (scf[:, wm] ** 2 * mask[wm][None]).sum(dim=1)
    d_mask = (dcf[:, wm] ** 2 * mask[wm][None]).sum(dim=1)
    s_mask = torch.sqrt(s_mask * s_gv) / 32.0
    d_mask = torch.sqrt(d_mask * d_gv) / 32.0
    s_mask = torch.maximum(s_mask, d_mask)
    err = (scf - dcf).abs()
    thr = s_mask[:, None, None] / mask[None]
    err_ac = (err - thr).clamp(min=0.0)
    err = torch.where(wm[None], err_ac, err)
    ret = ((err * csf[None]) ** 2).sum()
    return float(ret) / err.numel()


def convert_score_db(score: float, weight: float, bit_depth: int) -> float:
    pix_max = {8: 255, 10: 1023, 12: 4095}[bit_depth]
    if weight * score < pix_max * pix_max * 1e-10:
        return MAX_PSNR
    return 10 * (math.log10(pix_max * pix_max) - math.log10(weight * score))


def psnrhvs(planes_a, planes_b, bd: int = 8, in_bd: int = 8,
            device="cuda"):
    """vpx_psnrhvs parity: returns (db, y, u, v)."""
    shift = bd - in_bd
    ta, tb = _planes(planes_a, device), _planes(planes_b, device)
    y, u, v = (_psnrhvs_plane(a, b, csf, shift) for a, b, csf in
               zip(ta, tb, (_CSF_Y, _CSF_CB, _CSF_CR)))
    return convert_score_db(0.8 * y + 0.1 * (u + v), 1.0, in_bd), y, u, v


# ------------------------------------------------------------------- CLI


def read_frames(path: str, w: int, h: int, bd: int = 8, device="cuda"):
    """Yield (y, u, v) planes from a raw I420 file, or from a decodable
    stream (.ivf/.webm), decoded by the port with its frame step on
    `device`."""
    if path.endswith((".ivf", ".webm")):
        from ..containers import open_video
        from ..decoder.frame import NativeVp9Decoder
        from ..runtime.pipeline import TorchRecon
        dec = NativeVp9Decoder(recon_fn=TorchRecon(device))
        with open_video(path) as r:
            for data, _pts in r:
                dec.decode(data)
                for fr in dec.frames():
                    yield fr.visible_planes()
        return
    dt = np.uint8 if bd == 8 else np.uint16
    ps = 1 if bd == 8 else 2
    fsz = (w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)) * ps
    cw, ch = (w + 1) // 2, (h + 1) // 2
    with open(path, "rb") as f:
        while True:
            buf = f.read(fsz)
            if len(buf) < fsz:
                return
            a = np.frombuffer(buf, dt)
            y = a[:w * h].reshape(h, w)
            u = a[w * h:w * h + cw * ch].reshape(ch, cw)
            v = a[w * h + cw * ch:].reshape(ch, cw)
            yield (y, u, v)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="PSNR / SSIM / FastSSIM / PSNR-HVS between two "
                    "I420 inputs (raw .yuv or decodable streams)")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("size", nargs="?", help="WxH (required for raw yuv)")
    p.add_argument("--bit-depth", type=int, default=8,
                   choices=(8, 10, 12))
    p.add_argument("--frames", type=int, default=0,
                   help="limit the number of frames compared")
    p.add_argument("--metrics", default="psnr,ssim,fastssim,psnrhvs")
    p.add_argument("--device", default="cuda",
                   help="torch device of the metrics and of the decode "
                        "(default cuda)")
    args = p.parse_args(argv)
    try:
        dev = check_device(args.device)
    except RuntimeError as e:
        print(f"metrics: {e}", file=sys.stderr)
        return 1
    w = h = 0
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
    bd = args.bit_depth
    which = args.metrics.split(",")
    n = 0
    acc = {"psnr_sse": 0, "psnr_n": 0, "ssim": 0.0, "fastssim": 0.0,
           "psnrhvs": 0.0}
    for fa, fb in zip(read_frames(args.a, w, h, bd, dev),
                      read_frames(args.b, w, h, bd, dev)):
        fa, fb = _planes(fa, dev), _planes(fb, dev)
        row = [f"frame {n}:"]
        if "psnr" in which:
            st = calc_psnr(fa, fb, bd, bd, dev)
            acc["psnr_sse"] += st["sse"][0]
            acc["psnr_n"] += st["samples"][0]
            row.append(f"psnr {st['psnr'][0]:.4f}")
        if "ssim" in which:
            s, _ = calc_ssim(fa, fb, bd, bd, dev)
            acc["ssim"] += s
            row.append(f"ssim {s:.5f}")
        if "fastssim" in which:
            s = calc_fastssim(fa, fb, bd, bd, dev)[0]
            acc["fastssim"] += s
            row.append(f"fastssim {s:.4f}")
        if "psnrhvs" in which:
            s = psnrhvs(fa, fb, bd, bd, dev)[0]
            acc["psnrhvs"] += s
            row.append(f"psnrhvs {s:.4f}")
        print("  ".join(row))
        n += 1
        if args.frames and n >= args.frames:
            break
    if not n:
        print("no frames", file=sys.stderr)
        return 1
    peak = float((1 << bd) - 1)
    out = ["overall:"]
    if "psnr" in which:
        out.append(f"psnr {sse_to_psnr(acc['psnr_n'], peak, acc['psnr_sse']):.4f}")
    for k in ("ssim", "fastssim", "psnrhvs"):
        if k in which:
            out.append(f"{k} {acc[k] / n:.5f}")
    print("  ".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
