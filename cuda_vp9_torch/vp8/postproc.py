"""VP8 post-processing (vp8/common/postproc.c + vpx_dsp/deblock.c
parity; the reference is built with CONFIG_POSTPROC=1).

Three display-side filters, applied to the decoder's reconstruction
when the codec context is opened with VPX_CODEC_USE_POSTPROC and
configured through VP8_SET_POSTPROC:

- DEBLOCK: threshold-gated 5-tap smoothing down then across every
  plane (vpx_post_proc_down_and_across_mb_row); per-macroblock
  thresholds derive from the frame's loop-filter strength, halved for
  skipped macroblocks.
- DEMACROBLOCK: the stronger luma-only variance-gated 15-tap box
  filter across then down (vpx_mbpost_proc_across_ip / _down), on top
  of DEBLOCK at a caller-raised strength.
- ADDNOISE: film-grain style dither from a gaussian-derived lookup
  (vpx_setup_noise / vpx_plane_add_noise; the reference draws rand()
  offsets, so the noise pattern is non-normative by design — a seeded
  numpy generator reproduces the same distribution deterministically).

The sequential C loops are reformulated as whole-plane vectorized
passes: both deblock passes only ever read pre-pass values (the C
write-delay buffers exist precisely so filtered pixels never feed the
filter), and the demacroblock sliding window sums likewise read only
pre-pass values (writes trail the window by 8), so each pass is a pure
function of its input plane — bit-identical to the reference's
in-place loops.  MFQE (multi-frame quality enhancement,
vp8/common/mfqe.c) blends low-motion blocks toward the previous
displayed frame after a quality drop — see
multiframe_quality_enhance below; gating lives in
Vp8StreamDecoder._postproc.
"""

from __future__ import annotations

import numpy as np

from .pptables import VPX_RV

# vpx/vp8.h vp8_postproc_level
VP8D_NOFILTERING = 0
VP8D_DEBLOCK = 1 << 0
VP8D_DEMACROBLOCK = 1 << 1
VP8D_ADDNOISE = 1 << 2
VP8D_MFQE = 1 << 10

_RV = np.asarray(VPX_RV, np.int64)


def _ppl(q: int) -> int:
    """Deblock pixel threshold from the filter q (postproc.c:63)."""
    level = 6.0e-05 * q ** 3 - .0067 * q ** 2 + .306 * q + .0065
    return int(level + .5)


def _q2mbl(x: int) -> int:
    """Demacroblock variance limit (postproc.c:48; C trunc division)."""
    if x < 20:
        x = 20
    t = (x - 50) * 10
    x = 50 + (abs(t) // 8) * (1 if t >= 0 else -1)
    return (x * x) // 3


def _down_across(plane: np.ndarray, limits: np.ndarray) -> np.ndarray:
    """vpx_post_proc_down_and_across_mb_row over a whole plane.

    plane: [Ha, W] int (W = crop width; rows cover the mb-aligned
    height, edge rows replicate like the buffer border).  limits:
    per-pixel threshold map [Ha, W].  Returns the filtered plane."""
    p = plane.astype(np.int64)
    H = p.shape[0]
    ri = np.arange(H)
    a2 = p[np.clip(ri - 2, 0, H - 1)]
    a1 = p[np.clip(ri - 1, 0, H - 1)]
    b1 = p[np.clip(ri + 1, 0, H - 1)]
    b2 = p[np.clip(ri + 2, 0, H - 1)]
    cond = ((np.abs(p - a2) < limits) & (np.abs(p - a1) < limits)
            & (np.abs(p - b1) < limits) & (np.abs(p - b2) < limits))
    k3 = ((((a2 + a1 + 1) >> 1) + ((b2 + b1 + 1) >> 1) + 1) >> 1)
    d = np.where(cond, (k3 + p + 1) >> 1, p)
    # across: neighbors are all down-pass values (the C d[] ring delays
    # writes by 2 columns, so reads at +-1/+-2 never see filtered pixels)
    e = np.pad(d, ((0, 0), (2, 2)), mode="edge")
    l2, l1 = e[:, 0:-4], e[:, 1:-3]
    r1, r2 = e[:, 3:-1], e[:, 4:]
    cond = ((np.abs(d - l2) < limits) & (np.abs(d - l1) < limits)
            & (np.abs(d - r1) < limits) & (np.abs(d - r2) < limits))
    k3 = ((((l2 + l1 + 1) >> 1) + ((r2 + r1 + 1) >> 1) + 1) >> 1)
    return np.where(cond, (k3 + d + 1) >> 1, d)


def deblock(planes, skip_map, q, crop_w, crop_h):
    """vp8_deblock: per-MB thresholds (halved on skipped MBs), down+
    across on all three planes.  planes: aligned (Y[Ha,Wa], U, V);
    returns new cropped-width planes at aligned height."""
    ppl = _ppl(q)
    y, u, v = planes
    mr, mc = skip_map.shape
    if ppl <= 0:
        return [y.copy(), u.copy(), v.copy()]
    mb_ppl = np.where(skip_map, ppl >> 1, ppl).astype(np.int64)
    out = []
    for plane, bs, w in ((y, 16, crop_w), (u, 8, (crop_w + 1) // 2),
                         (v, 8, (crop_w + 1) // 2)):
        pl = plane[:mr * bs, :w]
        lim = np.repeat(np.repeat(mb_ppl, bs, axis=0), bs, axis=1)
        out.append(_down_across(pl, lim[:mr * bs, :w]))
    return out


def _mb_across_ip(y: np.ndarray, flimit: int) -> np.ndarray:
    """vpx_mbpost_proc_across_ip: luma rows, 15-tap variance-gated box
    filter (window sums read only pre-pass values; note the +16 sumsq
    seed the reference carries in every window)."""
    p = y.astype(np.int64)
    e = np.pad(p, ((0, 0), (7, 7)), mode="edge")
    c1 = np.cumsum(e, axis=1, dtype=np.int64)
    c2 = np.cumsum(e * e, axis=1, dtype=np.int64)
    z = np.zeros((p.shape[0], 1), np.int64)
    s = np.concatenate([z, c1], 1)
    s2 = np.concatenate([z, c2], 1)
    # window [c-7, c+7] -> padded indices [c, c+14]
    w1 = s[:, 15:] - s[:, :-15]
    w2 = 16 + s2[:, 15:] - s2[:, :-15]
    cond = w2 * 15 - w1 * w1 < flimit
    return np.where(cond, (8 + w1 + p) >> 4, p)


def _mb_down(y: np.ndarray, flimit: int) -> np.ndarray:
    """vpx_mbpost_proc_down: luma columns, with the VPX_RV dither."""
    p = y.astype(np.int64)
    H, W = p.shape
    e = np.pad(p, ((7, 7), (0, 0)), mode="edge")
    c1 = np.cumsum(e, axis=0, dtype=np.int64)
    c2 = np.cumsum(e * e, axis=0, dtype=np.int64)
    z = np.zeros((1, W), np.int64)
    s = np.concatenate([z, c1], 0)
    s2 = np.concatenate([z, c2], 0)
    w1 = s[15:] - s[:-15]
    w2 = s2[15:] - s2[:-15]
    cond = w2 * 15 - w1 * w1 < flimit
    rv = _RV[(np.arange(H)[:, None] & 127) + (np.arange(W)[None, :] & 7)]
    return np.where(cond, (rv + w1 + p) >> 4, p)


def de_mblock(y: np.ndarray, q: int) -> np.ndarray:
    """vp8_de_mblock: across then down (the down pass reads the across
    output, like the reference's in-place sequence)."""
    lim = _q2mbl(q)
    return _mb_down(_mb_across_ip(y, lim), lim)


class NoiseState:
    """vpx_setup_noise / vpx_plane_add_noise with a seeded generator."""

    def __init__(self, seed: int = 0x5eed):
        self._rng = np.random.default_rng(seed)
        self._line = None
        self._clamp = 0
        self._key = None

    def setup(self, sigma: float, width: int):
        import math
        dist = []
        for i in range(-32, 32):
            g = (1 / (sigma * math.sqrt(2 * 3.14159265))
                 * math.exp(-i * i / (2 * sigma * sigma)))
            dist.extend([i] * int(0.5 + 256 * g))
            if len(dist) >= 256:
                break
        dist = (dist + [0] * 256)[:256]
        self._clamp = -dist[0]
        self._line = self._rng.choice(np.asarray(dist, np.int64),
                                      size=width + 256)

    def apply(self, y: np.ndarray, q: int, noise_level: int):
        sigma = noise_level + .5 + .6 * q / 63.0
        key = (round(sigma, 6), y.shape[1])
        if self._key != key:
            self.setup(sigma, y.shape[1])
            self._key = key
        clamp = self._clamp
        h, w = y.shape
        offs = self._rng.integers(0, 256, h)
        rows = self._line[offs[:, None] + np.arange(w)[None, :]]
        v = np.clip(y.astype(np.int64) - clamp, 0, 255)
        v = np.clip(v + 2 * clamp, 0, 255)
        v = np.clip(v - clamp, 0, 255)
        return (v + rows).astype(y.dtype)


def post_proc_frame(planes_aligned, skip_map, filter_level, flags,
                    deblock_level, noise_level, crop_w, crop_h,
                    noise_state: NoiseState):
    """vp8_post_proc_frame (postproc.c:148): returns CROPPED [y, u, v].

    planes_aligned: the decoder's mb-aligned reconstruction (borders
    replicate edges, so index clamping reproduces border reads)."""
    q = min(63, filter_level * 10 // 6)
    ch = (crop_h + 1) // 2
    cw = (crop_w + 1) // 2
    if flags & VP8D_DEMACROBLOCK:
        out = deblock(planes_aligned, skip_map,
                      q + (deblock_level - 5) * 10, crop_w, crop_h)
        out[0] = de_mblock(out[0][:crop_h], q + (deblock_level - 5) * 10)
    elif flags & VP8D_DEBLOCK:
        out = deblock(planes_aligned, skip_map, q, crop_w, crop_h)
    else:
        y, u, v = planes_aligned
        out = [y[:, :crop_w].copy(), u[:, :cw].copy(), v[:, :cw].copy()]
    out[0] = out[0][:crop_h, :crop_w]
    out[1] = out[1][:ch, :cw]
    out[2] = out[2][:ch, :cw]
    if flags & VP8D_ADDNOISE:
        out[0] = noise_state.apply(out[0], q, noise_level)
    return [o.astype(np.uint8) for o in out]


# ---------------------------------------------------------------- MFQE
# Multiframe Quality Enhancement (vp8/common/mfqe.c): when a low-quality
# frame follows higher-quality ones (keyframe "popping"), low-motion
# blocks blend toward the previous displayed frame, weighted by the
# block's difference-to-threshold ratio.

MFQE_PRECISION = 4


def _int_sqrt(x: np.ndarray) -> np.ndarray:
    """mfqe.c int_sqrt: floor sqrt, +1 when guess^2+guess+1 <= x
    (round-to-nearest on the open interval)."""
    g = np.asarray(np.sqrt(x.astype(np.float64)), np.int64)
    # float sqrt can land one high near perfect squares; clamp to floor
    g = np.where(g * g > x, g - 1, g)
    return g + (g * g + g + 1 <= x)


def _bview(p: np.ndarray, bs: int) -> np.ndarray:
    h, w = p.shape
    return (p.reshape(h // bs, bs, w // bs, bs)
            .transpose(0, 2, 1, 3).astype(np.int64))


def _vpx_var(b: np.ndarray) -> np.ndarray:
    """vpx_dsp variance (vs zeros): sse - (sum^2 >> log2 n)."""
    n = b.shape[-1] * b.shape[-2]
    s = b.sum((-1, -2))
    sse = (b * b).sum((-1, -2))
    return sse - ((s * s) >> int(np.log2(n)))


def _ssd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return (d * d).sum((-1, -2))


def _mfqe_weights(cy, py, cu, pu, cv, pv, qcurr, qprev, bs):
    """Per-block MFQE blend weight in [0, 16] (16 = copy current).

    cy/py: current/previous luma blocks [N, bs, bs]; cu/pu/cv/pv chroma
    [N, bs/2, bs/2].  Mirrors multiframe_quality_enhance_block
    (mfqe.c:108, USE_SSD variant) for blksize 16 and 8."""
    sh = 8 if bs == 16 else 6
    rnd = 1 << (sh - 1)
    csh, crnd = sh - 2, rnd >> 2
    actd = (_vpx_var(py) + rnd) >> sh
    act = (_vpx_var(cy) + rnd) >> sh
    sad = (_ssd(cy, py) + rnd) >> sh
    usad = (_ssd(cu, pu) + crnd) >> csh
    vsad = (_ssd(cv, pv) + crnd) >> csh
    actrisk = actd > act * 5
    # thr = qdiff/16 + log2(actd) + log4(qprev)
    thr = np.full(actd.shape, (qcurr - qprev) >> 4, np.int64)
    a = actd.copy()
    while np.any(a):
        a >>= 1
        thr += a > 0
    qp = qprev
    while qp >> 2:
        qp >>= 2
        thr += 1
    thrsq = thr * thr
    qualify = ((sad < thrsq) & (4 * usad < thrsq) & (4 * vsad < thrsq)
               & ~actrisk)
    ifactor = (_int_sqrt(sad) << MFQE_PRECISION) // np.maximum(thr, 1)
    ifactor >>= (qcurr - qprev) >> 5
    # qualified: blend with src_weight=ifactor (0 = keep previous);
    # unqualified: copy current (weight 16)
    return np.where(qualify, ifactor, 1 << MFQE_PRECISION)


def _qualify_inter_mb(mode, mv, bmvs, skip):
    """mfqe.c qualify_inter_mb for one MB: returns map[4] (quadrant
    raster order).  Replicates the original's quirks: SPLITMV's inner
    loop gates on map[j] (not map[i]) and compares sub-MVs unsigned-
    upper-bound only (no abs)."""
    if skip:
        return [1, 1, 1, 1]
    if mode == 9:  # SPLITMV
        ndx = ((0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15))
        m = [0, 0, 0, 0]
        for i in range(4):
            m[i] = 1
            j = 0
            while j < 4 and m[j]:
                b = bmvs[ndx[i][j]]
                m[i] &= int(b[0] <= 2 and b[1] <= 2)
                j += 1
        return m
    ok = int(mode > 4 and abs(int(mv[0])) <= 2 and abs(int(mv[1])) <= 2)
    return [ok] * 4


def multiframe_quality_enhance(cur, prev, mode, mvs, bmvs, skip,
                               qcurr, qprev, frame_type):
    """vp8_multiframe_quality_enhance (mfqe.c:236): blend the current
    frame toward the previous displayed frame on low-motion blocks.

    cur/prev: mb-aligned [Y, U, V] uint8 planes (same shapes); mode/
    mvs [mr, mc(,2)], bmvs [mr, mc, 16, 2], skip [mr, mc] per-MB info;
    returns new aligned planes."""
    mr, mc = skip.shape
    y, u, v = (p.astype(np.int64) for p in cur)
    py, pu, pv = (p.astype(np.int64) for p in prev)

    # qualification maps (quadrant granularity)
    if frame_type == 0:     # key frame: everything qualifies at MB level
        map4 = np.ones((mr, mc, 4), np.int64)
    else:
        map4 = np.zeros((mr, mc, 4), np.int64)
        inter_ok = ((mode > 4) & (mode != 9)
                    & (np.abs(mvs[..., 0]) <= 2)
                    & (np.abs(mvs[..., 1]) <= 2))
        map4[:] = inter_ok[:, :, None]
        map4[skip] = 1
        for r, c in zip(*np.nonzero((mode == 9) & ~skip)):
            map4[r, c] = _qualify_inter_mb(9, mvs[r, c], bmvs[r, c], False)
    totmap = map4.sum(-1)

    # 16x16-granularity weights (totmap == 4), 8x8 for partial MBs
    w16 = _mfqe_weights(
        _bview(y, 16).reshape(-1, 16, 16),
        _bview(py, 16).reshape(-1, 16, 16),
        _bview(u, 8).reshape(-1, 8, 8), _bview(pu, 8).reshape(-1, 8, 8),
        _bview(v, 8).reshape(-1, 8, 8), _bview(pv, 8).reshape(-1, 8, 8),
        qcurr, qprev, 16).reshape(mr, mc)
    # 8x8 blocks in quadrant order: y8 view is [mr*2, mc*2] raster;
    # quadrant q of MB (r, c) is y8[2r + q//2, 2c + q%2]
    w8 = _mfqe_weights(
        _bview(y, 8).reshape(-1, 8, 8), _bview(py, 8).reshape(-1, 8, 8),
        _bview(u, 4).reshape(-1, 4, 4), _bview(pu, 4).reshape(-1, 4, 4),
        _bview(v, 4).reshape(-1, 4, 4), _bview(pv, 4).reshape(-1, 4, 4),
        qcurr, qprev, 8).reshape(mr * 2, mc * 2)

    # assemble the final per-8x8-luma weight map
    W = np.empty((mr * 2, mc * 2), np.int64)
    q16 = np.repeat(np.repeat(w16, 2, axis=0), 2, axis=1)
    t2 = np.repeat(np.repeat(totmap, 2, axis=0), 2, axis=1)
    m2 = np.empty((mr * 2, mc * 2), np.int64)
    m2[0::2, 0::2] = map4[..., 0]
    m2[0::2, 1::2] = map4[..., 1]
    m2[1::2, 0::2] = map4[..., 2]
    m2[1::2, 1::2] = map4[..., 3]
    COPY = 1 << MFQE_PRECISION
    W = np.where(t2 == 4, q16,                    # whole-MB blend
                 np.where(t2 == 0, COPY,          # copy current
                          np.where(m2 == 1, w8, COPY)))

    def blend(curp, prevp, bs):
        wmap = np.repeat(np.repeat(W, bs, axis=0), bs, axis=1)
        wmap = wmap[:curp.shape[0], :curp.shape[1]]
        rb = 1 << (MFQE_PRECISION - 1)
        return ((curp * wmap + prevp * (COPY - wmap) + rb)
                >> MFQE_PRECISION).astype(np.uint8)

    return [blend(y, py, 8), blend(u, pu, 4), blend(v, pv, 4)]
