"""One VP9 frame step on torch tensors.

Counterpart of `cuda_vp9_tpu/runtime/fused.py` (`make_frame_step`,
`get_frame_step`) for the slice this package covers: bit depths 8, 10 and
12, chroma 4:2:0, 4:4:4 and 4:2:2, lossless frames (the WHT on bucket
tx0, the only bucket of a lossless layout) and a dense wire
(pages_tier == 0).  It reads the flat int16 wire of `runtime/pack.py` or
of the native packer, the same bytes the JAX step reads.

`make_batched_step` / `get_batched_step` are the multi-stream step (the
counterpart of JAX's vmapped `get_batched_step`): the same stages, once
per round for the 4:2:0 frames of N streams of one geometry, with the
loop filter as one launch of the stream-axis kernel (`lf_frames`).

step(pool, ring, kernels, flat) reconstructs one frame and updates
`pool` and `ring` in place (JAX donates them; here the update is in
place to keep one copy of the pool on the device):

  residual transforms per coefficient bucket -> MC (mc4, mc8, mc16,
  mc32, then the scaled-reference class mcs; compound averages from
  each class's n_ref0 chunk on) -> inter residual add under mi_mask ->
  intra wavefront, chunk by chunk -> loop filter -> pool refresh
  (misc[5:13]) and ring row misc[13].

Above 8 bits the coefficients ship as (lo, hi) int16 pairs and the
transforms run in the int32 WRAPLOW domain; the ring is int16.  The loop
filter follows the chroma format: 4:2:0 is one `lf_frame` call; 4:4:4
filters each chroma plane through the kernel's luma path on the chroma
cell grid; 4:2:2 filters the chroma planes with `lf_chroma_422`, in the
order of the luma superblocks (fused.py:638-682).

The pool canvas [pha, pwa] may exceed the frame canvas [ha, wa] when
scaled references are live; each slot then holds its frame in the
top-left corner, as in JAX.  MC reads the pool directly with the
normative edge clamps (ops/ref/inter.convolve_block semantics); the
TPU's one-hot band formulation is not ported.

`flat` is the HOST numpy buffer.  The step uploads it once and reads
every loop bound (the misc trip counts, lf_on, the refresh flags, the
ring slot and chunk_bs) from the host copy, so it never waits on the
device for a number.

Padding.  The packer pads records with y = 0 on the wire; JAX drops
their writes (`mode="drop"`) and clamps their reads.  Torch wraps
negative indices and a CUDA device asserts on an out-of-range one, so
here every gather index is clamped into range and every scatter goes to
a frame buffer with one trash element past its end, where padded
records land.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import models as M
from ..ops import transforms as T
from ..ops.cuda.lf422 import lf_chroma_422
from ..ops.cuda.loopfilter import lf_frame, lf_frames
from ..ops.device import stages
from . import pack

I32 = torch.int32

# (tile size, misc slot of the chunk count, misc slot of the first
# compound-average chunk) per MC class, in the JAX step's order
MC_CLASSES = ((4, 0, 23), (8, 1, 24), (16, 2, 25), (32, 33, 34))
# chroma subsampling (ss_x, ss_y) the step runs: 4:2:0, 4:4:4, 4:2:2
CHROMA_FORMATS = ((1, 1), (0, 0), (1, 0))


def cdiv(a, b):
    return (a + b - 1) // b


def require_slice(ss=(1, 1), scaled: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP queue-1 item, for a
    frame outside the slice this package ports; such a frame never goes
    to the host oracle."""
    if tuple(ss) not in CHROMA_FORMATS:
        raise NotImplementedError(
            f"chroma subsampling {tuple(ss)} (4:4:0): ROADMAP queue 1 "
            "item 9")
    if scaled and tuple(ss) != (1, 1):
        raise NotImplementedError(
            "scaled references with chroma other than 4:2:0: ROADMAP "
            "queue 1 item 8")


def frame_buffer(ha: int, wa: int, device) -> torch.Tensor:
    """int32 [3*ha*wa + 1]: a [3, ha, wa] frame plus one trash element
    that padded records write to."""
    return torch.zeros(3 * ha * wa + 1, dtype=I32, device=device)


def _block_index(buf, plane, y0, x0, valid, h, w, ha, wa):
    """Linear indices [N, h, w] of the blocks buf[plane, y0 + i, x0 + j]
    of a frame buffer (frame_buffer); padded records (valid false) point
    at the trash element."""
    dev = buf.device
    ri = torch.arange(h, device=dev)[None, :, None]
    rj = torch.arange(w, device=dev)[None, None, :]
    lin = ((plane.long()[:, None, None] * ha + y0.long()[:, None, None] + ri)
           * wa + x0.long()[:, None, None] + rj)
    return torch.where(valid[:, None, None], lin, buf.numel() - 1)


def _put_blocks(buf, plane, y0, x0, valid, vals, ha, wa):
    """buf[plane, y0 + i, x0 + j] = vals[n, i, j] for the valid records;
    the others write the trash element.  Destinations must be distinct."""
    lin = _block_index(buf, plane, y0, x0, valid, vals.shape[1],
                       vals.shape[2], ha, wa)
    buf.index_put_((lin.reshape(-1),), vals.reshape(-1))


# ----------------------------------------------------------------- residual


def _scan_table(tx: int, ncoef: int, device) -> torch.Tensor:
    """[4, ncoef] first-ncoef scan positions per tx_type."""
    return torch.as_tensor(np.stack(
        [np.asarray(M.SCAN_ORDERS[tx][t].scan[:ncoef], np.int64)
         for t in range(4)]), device=device)


def residual_units(Rbuf, coeffs, pos, tx: int, ha: int, wa: int,
                   bd: int = 8, lossless: bool = False):
    """Inverse-transform N units and write them into the residual frame.

    coeffs [N, n*n] raster order, int16 at bd 8 and int32 above; pos
    [N, 4] int32 = (plane, y + 1, x, tx_type), y + 1 == 0 marking a padded
    record (fused.py:44-63).  Lossless units (tx 0) take the WHT."""
    if lossless:
        resid = T.inv_wht2d(coeffs, bd)
    elif tx == 3:
        resid = T.inv_txfm2d(coeffs, 3, 0, bd)
    else:
        resid = T.inv_txfm2d_select(coeffs, tx, pos[:, 3] & 3, bd)
    _put_blocks(Rbuf, pos[:, 0], pos[:, 1] - 1, pos[:, 2], pos[:, 1] != 0,
                resid, ha, wa)


def expand_prefix(cm, tt, scan, n2: int):
    """First-ncoef scan coefficients [N, ncoef] -> raster [N, n2]."""
    full = torch.zeros(cm.shape[0], n2, dtype=cm.dtype, device=cm.device)
    return full.scatter_(1, scan[(tt & 3).long()], cm)


def expand_pairs(cm):
    """Interleaved (raster_idx, value) int16 pairs [N, 2P] -> raster
    [N, 1024].  Pad pairs are (0, 0); they go to index 1024, which is
    dropped (fused.py:593-599)."""
    idx = cm[:, 0::2].long()
    val = cm[:, 1::2]
    idx = torch.where((idx == 0) & (val == 0), 1024, idx.clamp(0, 1024))
    full = torch.zeros(cm.shape[0], 1025, dtype=cm.dtype, device=cm.device)
    return full.scatter_(1, idx, val)[:, :1024]


# ----------------------------------------------------------------- inter


def mc_predict(pool, kernels, hdr, u, w: int, bd: int):
    """8-tap sub-pel prediction of N w x w tiles (ops/ref/inter
    convolve_block semantics; counterpart of fused._mc_chunk_compute).

    pool [S, 3, pha, pwa] int32 (S = 8 slots, or 8N for the pools of N
    streams, slot 8s + i); kernels [4, 16, 8] int32; hdr [N, 8]
    each tile's chunk header (slot, plane, srow, cw, chh, ...); u [N, 4]
    wire records (dx | filt << 13, dy + 1, sr, sc) with sr / sc =
    ((src - dst) << 4) | subpel.  Reads rows clip(y0 - 3 + i, 0, chh - 1)
    and columns clip(x0 - 3 + j, 0, cw - 1) of pool[slot, plane], filters
    horizontally (rounded and clipped), then vertically.  Returns
    [N, w, w] int32; padded records (dy + 1 == 0) give unspecified
    values."""
    dev = u.device
    pha, pwa = pool.shape[2], pool.shape[3]
    valid = u[:, 1] != 0
    filt = torch.where(valid, u[:, 0] >> 13, 0) & 3
    x0 = (u[:, 0] & 0x1FFF) + (u[:, 3] >> 4)     # sc >> 4: arithmetic
    y0 = u[:, 1] - 1 + (u[:, 2] >> 4)
    slot = torch.where(valid, hdr[:, 0], 0).clamp(0, pool.shape[0] - 1)
    plane = torch.where(valid, hdr[:, 1], 0).clamp(0, 2)
    cw = torch.where(valid, hdr[:, 3], 1).clamp(1, pwa)
    chh = torch.where(valid, hdr[:, 4], 1).clamp(1, pha)
    t = torch.arange(w + 7, device=dev)[None, :]
    rows = torch.minimum((y0[:, None] - 3 + t).clamp(min=0), chh[:, None] - 1)
    cols = torch.minimum((x0[:, None] - 3 + t).clamp(min=0), cw[:, None] - 1)
    base = (slot * 3 + plane) * pha
    lin = (((base[:, None] + rows).long() * pwa)[:, :, None]
           + cols.long()[:, None, :])
    win = pool.reshape(-1)[lin]                   # [N, w+7, w+7]
    fx = kernels[filt.long(), (u[:, 3] & 15).long()]     # [N, 8]
    fy = kernels[filt.long(), (u[:, 2] & 15).long()]
    maxv = (1 << bd) - 1
    acc = fx[:, 0, None, None] * win[:, :, 0:w]
    for k in range(1, 8):
        acc = acc + fx[:, k, None, None] * win[:, :, k:k + w]
    temp = ((acc + 64) >> 7).clamp(0, maxv)       # [N, w+7, w]
    acc = fy[:, 0, None, None] * temp[:, 0:w, :]
    for k in range(1, 8):
        acc = acc + fy[:, k, None, None] * temp[:, k:k + w, :]
    return ((acc + 64) >> 7).clamp(0, maxv)


def mcs_predict(pool, kernels, hdr, u, bd: int):
    """Scaled-reference 4x4 prediction of N tiles (counterpart of
    fused._mcs_chunk_compute; vpx_scaled_2d semantics).  u [N, 16] wire
    records: x0 = u[4], y0 = u[5] source origin, spx / spy = u[6] / u[7]
    base phases, filt = u[8], crop cw / chh = u[9] / u[10], x / y step
    q4 = u[12] / u[13] (<= 32).  Column c reads source column
    x0 + ((spx + c * xs) >> 4) with phase (spx + c * xs) & 15; the 14
    intermediate rows are clip(y0 - 3 + i, 0, chh - 1), and output row r
    filters intermediate rows ((spy + r * ys) >> 4) + k.  Returns [N, 4, 4]
    int32; padded records (u[2] == 0) give unspecified values."""
    dev = u.device
    pha, pwa = pool.shape[2], pool.shape[3]
    valid = u[:, 2] != 0
    filt = torch.where(valid, u[:, 8], 0).clamp(0, 3).long()
    slot = torch.where(valid, hdr[:, 0], 0).clamp(0, 7)
    plane = torch.where(valid, hdr[:, 1], 0).clamp(0, 2)
    cw = torch.where(valid, u[:, 9], 1).clamp(1, pwa)
    chh = torch.where(valid, u[:, 10], 1).clamp(1, pha)
    xs = torch.where(valid, u[:, 12], 16).clamp(0, 32)
    ys = torch.where(valid, u[:, 13], 16).clamp(0, 32)
    c4 = torch.arange(4, device=dev)[None, :]
    k8 = torch.arange(8, device=dev)
    xq4 = u[:, 6, None] + c4 * xs[:, None]                    # [N, 4]
    cols = torch.minimum(
        ((u[:, 4, None] + (xq4 >> 4))[:, :, None] + k8 - 3).clamp(min=0),
        cw[:, None, None] - 1)                                # [N, 4, 8]
    rows = torch.minimum(
        (u[:, 5, None] - 3 + torch.arange(14, device=dev)).clamp(min=0),
        chh[:, None] - 1)                                     # [N, 14]
    base = (slot * 3 + plane) * pha
    lin = (((base[:, None] + rows).long() * pwa)[:, :, None, None]
           + cols.long()[:, None, :, :])
    win = pool.reshape(-1)[lin]                               # [N, 14, 4, 8]
    fx = kernels[filt[:, None], (xq4 & 15).long()]            # [N, 4, 8]
    maxv = (1 << bd) - 1
    temp = (((fx[:, None] * win).sum(3) + 64) >> 7).clamp(0, maxv)
    yq4 = u[:, 7, None] + c4 * ys[:, None]                    # [N, 4]
    fy = kernels[filt[:, None], (yq4 & 15).long()]            # [N, 4, 8]
    trow = ((yq4 >> 4)[:, :, None] + k8).clamp(0, 13).long()  # [N, 4, 8]
    taps = temp[torch.arange(u.shape[0], device=dev)[:, None, None],
                trow]                                         # [N, 4, 8, 4]
    acc = (fy[:, :, :, None] * taps).sum(2, dtype=I32)
    return ((acc + 64) >> 7).clamp(0, maxv)


def _land(Fbuf, pred, plane, y0, x0, valid, n0: int, ha: int, wa: int):
    """Land one MC class's predictions (fused._mc_pass): tiles [0, n0)
    are first-reference predictions with distinct destinations, tiles
    [n0, N) compound second predictions that average into them."""
    args = (plane, y0, x0, valid)
    if n0:
        _put_blocks(Fbuf, *(a[:n0] for a in args), pred[:n0], ha, wa)
    if n0 < pred.shape[0]:
        rest = [a[n0:] for a in args]
        cur = Fbuf[_block_index(Fbuf, *rest, pred.shape[1], pred.shape[2],
                                ha, wa)]
        _put_blocks(Fbuf, *rest, (cur + pred[n0:] + 1) >> 1, ha, wa)


def mc_pass(Fbuf, pool, kernels, units, hdrs, n_chunks: int, n_ref0: int,
            w: int, bd: int, ha: int, wa: int):
    """One unscaled MC tile class: units [CAPC, CH, 4], hdrs [CAPC, 8];
    chunks from n_ref0 on are compound second predictions."""
    CH = units.shape[1]
    u = units[:n_chunks].reshape(-1, 4)
    hd = hdrs[:n_chunks].repeat_interleave(CH, 0)
    pred = mc_predict(pool, kernels, hd, u, w, bd)
    _land(Fbuf, pred, hd[:, 1], u[:, 1] - 1, u[:, 0] & 0x1FFF, u[:, 1] != 0,
          n_ref0 * CH, ha, wa)


def mcs_pass(Fbuf, pool, kernels, units, hdrs, n_chunks: int, n_ref0: int,
             bd: int, ha: int, wa: int):
    """The scaled-reference 4x4 class (fused._mcs_pass): units
    [CAPC, CH, 16] with (plane, dx, dy + 1) in columns 0..2, hdrs
    [CAPC, 4].  Runs after the unscaled classes, so a compound average
    with a scaled first reference sees its first prediction."""
    CH = units.shape[1]
    u = units[:n_chunks].reshape(-1, 16)
    hd = hdrs[:n_chunks].repeat_interleave(CH, 0)
    pred = mcs_predict(pool, kernels, hd, u, bd)
    _land(Fbuf, pred, u[:, 0], u[:, 2] - 1, u[:, 1], u[:, 2] != 0,
          n_ref0 * CH, ha, wa)


def mask_add(F, R, mp, mi_rows: int, mi_cols: int, bd: int, ss=(1, 1)):
    """F = clip(F + R) over the non-skip inter mi cells (fused.py:620-633).
    F, R [..., 3, ha, wa]; mp [..., mi_rows, cdiv(mi_cols, 16)] int32, 16
    cells per (sign-extended) word; a chroma cell is (8 >> ss_y) x
    (8 >> ss_x) pixels.  Leading dimensions are frames (the batched
    step's streams)."""
    bits = torch.arange(16, device=F.device, dtype=I32)
    m = ((mp[..., None] >> bits) & 1).reshape(
        *mp.shape[:-2], mi_rows, -1)[..., :mi_cols] != 0
    maxv = (1 << bd) - 1
    for planes, gy, gx in ((slice(0, 1), 8, 8),
                           (slice(1, 3), 8 >> ss[1], 8 >> ss[0])):
        cm = m.repeat_interleave(gy, -2).repeat_interleave(gx, -1)
        h, w = cm.shape[-2:]
        f = F[..., planes, :h, :w]
        f.copy_(torch.where(cm[..., None, :, :],
                            (f + R[..., planes, :h, :w]).clamp(0, maxv), f))


# ----------------------------------------------------------------- intra


def intra_chunk(Fbuf, R, u, bs: int, bd: int, plane_off=None, keep=None):
    """One intra chunk from its 4-int16 records (fused._intra_chunk):
      w0 = x0/4 | plane << 14
      w1 = (y0/4 + 1) | have_up << 15      (all-zero record = padding)
      w2 = mode | n_above << 4 | n_left << 10
      w3 = tl_mode | have_left << 2
    u [CHUNK, 4] int32, sign-extended from int16.  For a stack of frames
    (R [3N, ha, wa]), plane_off [CHUNK] adds each record's frame offset
    3s to its plane, and records where keep [CHUNK] is false are padding."""
    w0 = u[:, 0] & 0xFFFF
    w1 = u[:, 1] & 0xFFFF
    w2 = u[:, 2] & 0xFFFF
    w3 = u[:, 3]
    y0q = w1 & 0x7FFF
    y0 = torch.where(y0q == 0, -32768, (y0q - 1) << 2)
    if keep is not None:
        y0 = torch.where(keep, y0, -32768)
    plane = w0 >> 14
    if plane_off is not None:
        plane = plane + plane_off
    stages.intra_wave(Fbuf, R, plane, (w0 & 0x3FFF) << 2, y0, w2 & 15,
                      (w2 >> 4) & 63, (w2 >> 10) & 63, w3 & 3, w1 >> 15,
                      (w3 >> 2) & 1, bs=bs, bd=bd)


# ----------------------------------------------------------------- frame step


def loop_filter(F, seg, lf_on: int, mi_rows: int, mi_cols: int, bd: int,
                ss):
    """Deblock F [3, ha, wa] in place by chroma format (fused.py:638-682);
    `seg(name, dtype=...)` gives the device view of a wire segment."""
    thr = seg("lf_thr", dtype=torch.int16)
    ha, wa = F.shape[1:]
    ssx, ssy = ss
    hcc, wcc = ha >> ssy, wa >> ssx
    # the lfm of a 4:4:4 or 4:2:2 frame ships zeroed chroma fields, so
    # this call leaves the chroma planes as they are; they are filtered
    # after it
    lf_frame(F, seg("lfm", dtype=torch.int16), thr, lf_on, mi_rows=mi_rows,
             mi_cols=mi_cols, bd=bd)
    if ss == (1, 1) or not lf_on:
        return
    if ss == (0, 0):
        # 4:4:4: each chroma plane through the kernel's luma path on the
        # chroma plane's own cell grid, as plane 0 of a [3, hac, wac] canvas
        rc, cc = cdiv(mi_rows, 1 << ssy), cdiv(mi_cols, 1 << ssx)
        hac, wac = ((rc + 7) & ~7) * 8, ((cc + 7) & ~7) * 8
        lfm_c = seg("lfm_c", dtype=torch.int16)
        for p in (1, 2):
            Cp = torch.zeros((3, hac, wac), dtype=I32, device=F.device)
            Cp[0, :hcc, :wcc] = F[p, :hcc, :wcc]
            lf_frame(Cp, lfm_c, thr, lf_on, mi_rows=rc, mi_cols=cc, bd=bd)
            F[p, :hcc, :wcc] = Cp[0, :hcc, :wcc]
    else:
        # 4:2:2: both chroma planes in place, 64x32 tiles in luma-SB order
        lf_chroma_422(F, *(seg(nm, dtype=torch.int16) for nm in (
            "lfw_v", "lfw_h", "lfw_mb", "lfw_lm", "lfw_hv")), lf_on, bd=bd)


def make_frame_step(mi_rows: int, mi_cols: int, layout, bd: int = 8,
                    ss=(1, 1), lossless: bool = False):
    """The step for one frame geometry, bit depth, chroma format, capacity
    tier and lossless flag (see the module docstring).  step(pool, ring,
    kernels, flat) -> None."""
    ss = tuple(ss)
    if ss not in CHROMA_FORMATS or bd not in (8, 10, 12):
        raise ValueError(f"no frame step for bd {bd}, chroma {ss}")
    ha = ((mi_rows + 7) & ~7) * 8
    wa = ((mi_cols + 7) & ~7) * 8
    hc, wc = ha >> ss[1], wa >> ss[0]
    segs = layout.segs
    scans = {}

    def step(pool, ring, kernels, flat: np.ndarray):
        dev = pool.device
        pha, pwa = pool.shape[2], pool.shape[3]
        if pha < ha or pwa < wa:
            raise ValueError(f"pool canvas {(pha, pwa)} is smaller than "
                             f"the frame canvas {(ha, wa)}")
        with record_function("vp9.upload"):
            flat_d = torch.from_numpy(flat).to(dev)

        def host(name):
            off, shape = segs[name]
            return flat[off:off + int(np.prod(shape))].reshape(shape)

        def seg(name, rows=None, dtype=I32):
            """Device view of a segment (first `rows` rows), sign-extended
            to int32 unless dtype is int16."""
            off, shape = segs[name]
            if rows is not None:
                shape = (rows,) + tuple(shape[1:])
            a = flat_d[off:off + int(np.prod(shape))].view(shape)
            return a if dtype == torch.int16 else a.to(dtype)

        misc = host("misc").astype(np.int64)
        Fbuf = frame_buffer(ha, wa, dev)
        Rbuf = frame_buffer(ha, wa, dev)
        F = Fbuf[:-1].view(3, ha, wa)
        R = Rbuf[:-1].view(3, ha, wa)

        with record_function("vp9.residual"):
            for name, tx, ncoef in pack.COEFF_BUCKETS:
                n = int(misc[pack.MISC_TRIP[name]]) * pack.COEFF_CHUNK[name]
                # a lossless layout holds bucket tx0 only (fused.py:541)
                if not n or f"coeff_{name}" not in segs:
                    continue
                if bd == 8:
                    cm = seg(f"coeff_{name}", n, torch.int16)
                else:
                    # hi/lo words: v = (hi << 15) + lo (fused.py:557-561)
                    cm = ((seg(f"coeffh_{name}", n) << 15)
                          + seg(f"coeff_{name}", n))
                pos = seg(f"cpos_{name}", n)
                n2 = (4 << tx) ** 2
                if ncoef < n2:
                    key = (tx, ncoef)
                    if key not in scans:
                        scans[key] = _scan_table(tx, ncoef, dev)
                    cm = expand_prefix(cm, pos[:, 3], scans[key], n2)
                residual_units(Rbuf, cm, pos, tx, ha, wa, bd, lossless)
            for name, chunk, trip in (
                    ("tx3c", pack.CHUNK_TX3C, pack.MISC_TRIP_TX3C),
                    ("tx3cs", pack.CHUNK_TX3CS, pack.MISC_TRIP_TX3CS)):
                # 8-bit only: the layout has no coo buckets above 8 bits
                # nor in a lossless frame
                n = int(misc[trip]) * chunk
                if n and f"coeff_{name}" in segs:
                    residual_units(Rbuf,
                                   expand_pairs(seg(f"coeff_{name}", n,
                                                    torch.int16)),
                                   seg(f"cpos_{name}", n), 3, ha, wa)

        with record_function("vp9.inter"):
            for w, n_slot, r0_slot in MC_CLASSES:
                n_chunks = int(misc[n_slot])
                if n_chunks:
                    mc_pass(Fbuf, pool, kernels, seg(f"mc{w}", n_chunks),
                            seg(f"mc{w}h", n_chunks), n_chunks,
                            int(misc[r0_slot]), w, bd, ha, wa)
            if "mcs" in segs and misc[14]:
                mcs_pass(Fbuf, pool, kernels, seg("mcs", int(misc[14])),
                         seg("mcsh", int(misc[14])), int(misc[14]),
                         int(misc[15]), bd, ha, wa)
            mask_add(F, R, seg("mi_mask"), mi_rows, mi_cols, bd, ss)

        with record_function("vp9.intra"):
            n_intra = int(misc[3])
            if n_intra:
                chunk_bs = host("chunk_bs")
                chunks = seg("intra", n_intra)
                for i in range(n_intra):
                    intra_chunk(Fbuf, R, chunks[i], 4 << int(chunk_bs[i]), bd)

        with record_function("vp9.loopfilter"):
            loop_filter(F, seg, int(misc[4]), mi_rows, mi_cols, bd, ss)

        with record_function("vp9.refresh"):
            for i in range(8):
                if misc[5 + i] > 0:
                    if (pha, pwa) != (ha, wa):
                        pool[i].zero_()
                    pool[i, :, :ha, :wa].copy_(F)
            # the ring row's dtype (uint8, or int16 above 8 bits) is the
            # ring's: copy_ narrows the int32 pixels
            out = torch.cat([F[0].reshape(-1), F[1, :hc, :wc].reshape(-1),
                             F[2, :hc, :wc].reshape(-1)])
            row = ring[int(misc[13])]
            row[:out.numel()].copy_(out)
            row[out.numel():].zero_()

    return step


def get_frame_step(mi_rows: int, mi_cols: int, tier: str,
                   lossless: bool = False, bd: int = 8, ss=(1, 1),
                   pool_ha: int | None = None):
    """(step, caps, layout) for one frame geometry and capacity tier
    ("full", "tight", "wide" or "scaled"; fused.get_frame_step).
    pool_ha: the reference pool's canvas height when it exceeds the
    frame's (scaled references).  Uncached: the caller keeps the result,
    because the native packer caches per layout object."""
    ss = tuple(ss)
    require_slice(ss, tier == "scaled")
    caps = pack.compute_caps(mi_rows, mi_cols, tier, lossless,
                             pool_ha=pool_ha, ss=ss)
    layout = pack.build_layout(caps, mi_rows, mi_cols, lossless, bd, ss=ss)
    return (make_frame_step(mi_rows, mi_cols, layout, bd, ss, lossless),
            caps, layout)


# ----------------------------------------------------------------- batched


def make_batched_step(n_streams: int, mi_rows: int, mi_cols: int, layout,
                      bd: int = 8, lossless: bool = False):
    """The step of N same-geometry 4:2:0 streams decoded in lockstep: the
    counterpart of the vmapped step of `fused.get_batched_step`
    (fused.py:724-766), with the vmap written out as a stream axis.

    step(pool, ring, kernels, flats, active) -> None.  pool [N, 8, 3, ha,
    wa] int32 and ring [N, RING, nout] are updated in place; flats is a
    HOST int16 array [A, nflat], the flat of each stream in `active` (a
    host sequence of A distinct stream indices: the streams with a frame
    this round, in any order).  A stream outside `active` sits the round
    out: no records, no refresh, no ring write.  Every loop bound comes
    from the host flats, as in the single-frame step.

    The A frames share one frame buffer of 3A planes (plus the trash
    element), frame k at planes 3k .. 3k + 2, and every stage runs once
    for all of them: each coefficient bucket, each MC class (landed in
    two steps, so that every compound average sees its first
    prediction), the mask add, each intra chunk index (one call per
    distinct block size among the streams' chunk i; the chunks of two
    streams never depend on each other), one `lf_frames` launch, one
    indexed pool refresh and one indexed ring write.  A stream whose
    count in a bucket, class or chunk list is below the round's most
    runs the rest as padding records (the wire is zero there), as JAX's
    shared round-max trip counts do."""
    ha = ((mi_rows + 7) & ~7) * 8
    wa = ((mi_cols + 7) & ~7) * 8
    hc, wc = ha >> 1, wa >> 1
    segs = layout.segs
    nflat = cdiv(layout.size, pack.PAGE) * pack.PAGE
    ich = segs["intra"][1][1]
    scans = {}

    def step(pool, ring, kernels, flats: np.ndarray, active):
        dev = pool.device
        A = len(active)
        if tuple(pool.shape) != (n_streams, 8, 3, ha, wa) \
                or flats.shape != (A, nflat) or not A:
            raise ValueError("batched step: pool, flats or active do not "
                             "match the step's geometry")
        miscs = [layout.view(f, "misc").astype(np.int64) for f in flats]
        # pool refresh pairs: (slot 8s + i of the stacked pool, frame k)
        refresh = [(8 * s + i, k) for k, (s, m) in enumerate(
            zip(active, miscs)) for i in range(8) if m[5 + i] > 0]
        aux = np.array(list(active) + [d for d, _ in refresh]
                       + [k for _, k in refresh], np.int16)
        with record_function("vp9.upload"):
            up = torch.from_numpy(np.concatenate([flats.reshape(-1), aux])
                                  ).to(dev)
        flat_d = up[:A * nflat].view(A, nflat)
        aux_d = up[A * nflat:].long()
        act_d = aux_d[:A]

        def most(slot):
            return max(int(m[slot]) for m in miscs)

        def seg(name, rows=None, dtype=I32):
            """[A, ...] device view of a segment of every flat (first
            `rows` rows), sign-extended to int32 unless dtype is int16."""
            off, shape = segs[name]
            if rows is not None:
                shape = (rows,) + tuple(shape[1:])
            a = flat_d[:, off:off + int(np.prod(shape))].view(A, *shape)
            return a if dtype == torch.int16 else a.to(dtype)

        Fbuf = torch.zeros(3 * A * ha * wa + 1, dtype=I32, device=dev)
        Rbuf = torch.zeros_like(Fbuf)
        F = Fbuf[:-1].view(A, 3, ha, wa)
        R = Rbuf[:-1].view(A, 3, ha, wa)
        poff = 3 * torch.arange(A, device=dev, dtype=I32)[:, None]

        with record_function("vp9.residual"):
            for name, tx, ncoef in pack.COEFF_BUCKETS:
                n = most(pack.MISC_TRIP[name]) * pack.COEFF_CHUNK[name]
                if not n or f"coeff_{name}" not in segs:
                    continue
                if bd == 8:
                    cm = seg(f"coeff_{name}", n, torch.int16)
                else:
                    cm = ((seg(f"coeffh_{name}", n) << 15)
                          + seg(f"coeff_{name}", n))
                cm = cm.reshape(A * n, ncoef)
                pos = seg(f"cpos_{name}", n)
                pos[:, :, 0] += poff
                pos = pos.reshape(A * n, 4)
                n2 = (4 << tx) ** 2
                if ncoef < n2:
                    key = (tx, ncoef)
                    if key not in scans:
                        scans[key] = _scan_table(tx, ncoef, dev)
                    cm = expand_prefix(cm, pos[:, 3], scans[key], n2)
                residual_units(Rbuf, cm, pos, tx, ha, wa, bd, lossless)
            for name, chunk, trip in (
                    ("tx3c", pack.CHUNK_TX3C, pack.MISC_TRIP_TX3C),
                    ("tx3cs", pack.CHUNK_TX3CS, pack.MISC_TRIP_TX3CS)):
                n = most(trip) * chunk
                if n and f"coeff_{name}" in segs:
                    pos = seg(f"cpos_{name}", n)
                    pos[:, :, 0] += poff
                    cm = seg(f"coeff_{name}", n, torch.int16)
                    residual_units(Rbuf,
                                   expand_pairs(cm.reshape(A * n, -1)),
                                   pos.reshape(A * n, 4), 3, ha, wa)

        with record_function("vp9.inter"):
            pool_s = pool.view(n_streams * 8, 3, ha, wa)
            misc_d = seg("misc")
            for w, n_slot, r0_slot in MC_CLASSES:
                n = most(n_slot)
                if not n:
                    continue
                u = seg(f"mc{w}", n)
                ch = u.shape[2]
                u = u.reshape(-1, 4)
                hd = seg(f"mc{w}h", n)
                plane = (hd[:, :, 1] + poff).repeat_interleave(ch, 1)
                hd[:, :, 0] += 8 * act_d[:, None].to(I32)
                # chunks before each stream's own n_ref0 are first
                # predictions, the others compound second ones
                first = (torch.arange(n, device=dev)[None, :]
                         < misc_d[:, r0_slot, None]
                         ).repeat_interleave(ch, 1).reshape(-1)
                pred = mc_predict(pool_s, kernels,
                                  hd.repeat_interleave(ch, 1).reshape(-1, 8),
                                  u, w, bd)
                plane = plane.reshape(-1)
                y0, x0 = u[:, 1] - 1, u[:, 0] & 0x1FFF
                valid = u[:, 1] != 0
                _put_blocks(Fbuf, plane, y0, x0, valid & first, pred,
                            ha, wa)
                second = valid & ~first
                cur = Fbuf[_block_index(Fbuf, plane, y0, x0, second, w, w,
                                        ha, wa)]
                _put_blocks(Fbuf, plane, y0, x0, second,
                            (cur + pred + 1) >> 1, ha, wa)
            mask_add(F, R, seg("mi_mask"), mi_rows, mi_cols, bd)

        with record_function("vp9.intra"):
            counts = [int(m[3]) for m in miscs]
            if max(counts):
                chunk_bs = [layout.view(f, "chunk_bs") for f in flats]
                chunks = seg("intra", max(counts)).transpose(0, 1
                                                             ).contiguous()
                cbs_d = seg("chunk_bs", max(counts))
                Rs = Rbuf[:-1].view(3 * A, ha, wa)
                off = poff.repeat_interleave(ich, 1).reshape(-1)
                for i in range(max(counts)):
                    codes = sorted({int(chunk_bs[k][i]) for k in range(A)
                                    if i < counts[k]})
                    u = chunks[i].reshape(-1, 4)
                    for c in codes:
                        keep = None if len(codes) == 1 else (
                            cbs_d[:, i, None] == c).expand(A, ich).reshape(-1)
                        intra_chunk(Fbuf, Rs, u, 4 << c, bd, off, keep)

        with record_function("vp9.loopfilter"):
            lf_frames(F, seg("lfm", dtype=torch.int16),
                      seg("lf_thr", dtype=torch.int16),
                      [int(m[4]) for m in miscs], mi_rows=mi_rows,
                      mi_cols=mi_cols, bd=bd)

        with record_function("vp9.refresh"):
            if refresh:
                nr = len(refresh)
                pool_s[aux_d[A:A + nr]] = F[aux_d[A + nr:]]
            out = torch.cat([F[:, 0].reshape(A, -1),
                             F[:, 1, :hc, :wc].reshape(A, -1),
                             F[:, 2, :hc, :wc].reshape(A, -1)], 1)
            # every stream of a round writes the round's ring slot
            ring[act_d, int(miscs[0][13])] = out.to(ring.dtype)

    return step


def get_batched_step(n_streams: int, mi_rows: int, mi_cols: int,
                     lossless: bool = False, bd: int = 8,
                     tier: str = "wide"):
    """(step, caps, layout) of the batched step for N same-geometry 4:2:0
    streams at one capacity tier ("tight" or "wide", as
    fused.get_batched_step; or "full", for rounds of intra-only frames
    that overflow the wide tier, which JAX decodes on its host oracle).
    The tight and wide tiers pin the 64-unit intra chunk, so that a tight
    flat escalates to the wide layout by a prefix copy per segment.
    Uncached, as get_frame_step."""
    caps = pack.compute_caps(mi_rows, mi_cols, tier, lossless)
    if tier != "full":
        caps["intra_chunk"] = pack.CHUNK_INTRA
    layout = pack.build_layout(caps, mi_rows, mi_cols, lossless, bd)
    return (make_batched_step(n_streams, mi_rows, mi_cols, layout, bd,
                              lossless), caps, layout)


def ring_dtype(bd: int) -> torch.dtype:
    """The output ring's dtype: uint8 at 8 bits, int16 above (pixels are
    at most 4095)."""
    return torch.uint8 if bd == 8 else torch.int16


def entry(device):
    """(fn, example_args): the step at one 64x64 superblock on an
    all-zero tight-tier flat, the counterpart of `__graft_entry__.entry`
    as a check that the step builds and runs on `device`."""
    step, caps, layout = get_frame_step(8, 8, "tight")
    ha = wa = 64
    pool = torch.zeros((8, 3, ha, wa), dtype=I32, device=device)
    ring = torch.zeros((32, ha * wa + 2 * (ha >> 1) * (wa >> 1)),
                       dtype=ring_dtype(8), device=device)
    kernels = torch.as_tensor(np.asarray(M.FILTER_KERNELS, np.int32),
                              device=device)
    flat = np.zeros(cdiv(layout.size, pack.PAGE) * pack.PAGE, np.int16)
    return step, (pool, ring, kernels, flat)
