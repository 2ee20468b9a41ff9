"""Whole-frame VP9 loop filter: the CUDA kernel and its plain torch twin.

`lf_frame` is the counterpart of `cuda_vp9_tpu/ops/pallas/loopfilter.py`
`lf_frame`, in place on an int32 [3, ha, wa] frame (a luma plane and two
4:2:0 chroma planes, bit depth 8, 10 or 12).  `lf_frames` is the same
kernel with a leading stream axis, the counterpart of that `lf_frame`
under the batched step's vmap: it filters N frames [N, 3, ha, wa] of one
geometry and bit depth, each with its own metadata, in one launch, and
`lf_frame` is its N = 1 call.  On a CUDA tensor they launch the kernel of
`csrc/loopfilter.cu` or raise; on a CPU tensor they run `lf_frame_plain`
per frame, the same math in torch ops.  Both keep the Pallas kernel's
order: SB (r, c) after (r, c-1) and (r-1, c+1); per SB all vertical edge
chains, then all horizontal ones; per chain the main edge and the
interior +4 edge.  The kernel is one persistent launch per call: its
blocks walk the SB rows of every frame with a filter level, each SB
staged in shared memory, and wait on per-row progress flags in a small
workspace this wrapper allocates.

`launches` counts the kernel launches (one per call with any filter
level, as the C entry point reports them) and `plain_calls` the calls of
the plain version (one per frame).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

launches = 0
plain_calls = 0


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


# ----------------------------------------------------------------- plain


def _edge_chain(W, bits, mb, lm, hv, bd):
    """One edge chain on windows W [L, 16] int32 (edge between 7 | 8);
    bits/mb/lm/hv [L] int32 (thresholds bd-scaled).  Returns the new
    windows (positions 1..14 may change).  Mirrors the Pallas
    `_edge_chain` term for term."""
    w = [W[:, k] for k in range(16)]
    p3, p2, p1, p0, q0, q1, q2, q3 = w[4:12]
    ft = 1 << (bd - 8)
    off = 0x80 << (bd - 8)
    lo, hi = -off, off - 1
    k16 = (bits & 1) > 0
    k8 = (bits & 2) > 0
    k4 = (bits & 4) > 0
    k4i = (bits & 8) > 0

    def over(a, b, t):
        return (a - b).abs() > t

    def f4(ps1, ps0, qs0, qs1, m, h):
        f = torch.where(h, (ps1 - qs1).clamp(lo, hi), 0)
        f = torch.where(m, (f + 3 * (qs0 - ps0)).clamp(lo, hi), 0)
        f1 = (f + 4).clamp(lo, hi) >> 3
        f2 = (f + 3).clamp(lo, hi) >> 3
        fo = torch.where(h, 0, (f1 + 1) >> 1)
        return ((ps1 + fo).clamp(lo, hi) + off, (ps0 + f2).clamp(lo, hi) + off,
                (qs0 - f1).clamp(lo, hi) + off, (qs1 - fo).clamp(lo, hi) + off)

    mask = ~(over(p3, p2, lm) | over(p2, p1, lm) | over(p1, p0, lm)
             | over(q1, q0, lm) | over(q2, q1, lm) | over(q3, q2, lm)
             | ((p0 - q0).abs() * 2 + ((p1 - q1).abs() >> 1) > mb))
    hev = over(p1, p0, hv) | over(q1, q0, hv)
    flat = ~(over(p1, p0, ft) | over(q1, q0, ft) | over(p2, p0, ft)
             | over(q2, q0, ft) | over(p3, p0, ft) | over(q3, q0, ft))
    mask = mask & (k16 | k8 | k4)
    out = list(w)
    for k, v in zip(range(6, 10), f4(p1 - off, p0 - off, q0 - off, q1 - off,
                                     mask, hev)):
        out[k] = torch.where(mask, v, out[k])

    sel8 = flat & mask & (k8 | k16)
    v8 = [(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
          (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
          (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
          (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
          (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
          (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3]
    for k, v in zip(range(5, 11), v8):
        out[k] = torch.where(sel8, v, out[k])

    flat2 = over(w[0], p0, ft) | over(w[15], q0, ft)
    for k in range(1, 4):
        flat2 = flat2 | over(w[k], p0, ft) | over(w[15 - k], q0, ft)
    sel16 = ~flat2 & flat & mask & k16
    p = [w[7 - k] for k in range(8)]
    q = [w[8 + k] for k in range(8)]
    P = sum(p[1:], p[0])
    Q = sum(q[1:], q[0])
    for i in range(7):
        qpre = sum(q[1:7 - i], q[0])      # q[0] + .. + q[6-i]
        ppre = sum(p[1:7 - i], p[0])
        out[7 - i] = torch.where(sel16, (p[7] * i + p[i] + P + qpre + 8) >> 4,
                                 out[7 - i])
        out[8 + i] = torch.where(sel16, (q[7] * i + q[i] + Q + ppre + 8) >> 4,
                                 out[8 + i])

    i3, i2, i1, i0, j0, j1, j2, j3 = out[8:16]
    m2 = ~(over(i3, i2, lm) | over(i2, i1, lm) | over(i1, i0, lm)
           | over(j1, j0, lm) | over(j2, j1, lm) | over(j3, j2, lm)
           | ((i0 - j0).abs() * 2 + ((i1 - j1).abs() >> 1) > mb)) & k4i
    h2 = over(i1, i0, hv) | over(j1, j0, hv)
    for k, v in zip(range(10, 14), f4(i1 - off, i0 - off, j0 - off, j1 - off,
                                      m2, h2)):
        out[k] = torch.where(m2, v, out[k])
    return torch.stack(out, 1)


def _chain_lanes(rs, cs, d, i, ha, wa):
    """Pixel geometry of chain i in direction d (0 = vertical edges,
    1 = horizontal) for the SBs (rs[k], cs[k]) of one wave, luma and (for
    i < 4) both chroma planes together.  Returns numpy (lin [L, 16] linear
    frame index, inb [L, 16] inside the plane, lfm_idx [L] index into
    lfm.view(-1))."""
    lins, inbs, lfms = [], [], []
    k16 = np.arange(16) - 8
    planes = [(0, 64, ha, wa, 0)]
    if i < 4:
        planes += [(p, 32, ha // 2, wa // 2, 64) for p in (1, 2)]
    sb = np.asarray(rs) * (wa // 64) + np.asarray(cs)
    for plane, sz, ph, pw, lbase in planes:
        t = np.arange(sz)
        along = (np.asarray(rs if d == 0 else cs)[:, None] * sz + t[None, :])
        edge = np.asarray(cs if d == 0 else rs)[:, None] * sz + i * 8
        across = (edge[:, :, None] + k16[None, None, :])      # [nsb, 1, 16]
        across = np.broadcast_to(across, (len(sb), sz, 16))
        along = np.broadcast_to(along[:, :, None], (len(sb), sz, 16))
        y, x = (along, across) if d == 0 else (across, along)
        inb = (y >= 0) & (y < ph) & (x >= 0) & (x < pw)
        lins.append((plane * ha * wa + y * wa + x).reshape(-1, 16))
        inbs.append(inb.reshape(-1, 16))
        lfms.append((sb[:, None] * 256 + d * 128 + lbase + i * 8
                     + t[None, :] // 8).reshape(-1))
    return (np.concatenate(lins), np.concatenate(inbs),
            np.concatenate(lfms))


def lf_frame_plain(F, lfm, thr, lf_on, *, mi_rows, mi_cols, bd):
    """Plain torch loop filter, in place on F [3, ha, wa] int32: one
    vectorised step per (wave, direction, chain) over all lanes of the
    wave's superblocks.  Returns F."""
    _check(F, lfm, thr, mi_rows, mi_cols)
    global plain_calls
    plain_calls += 1
    if not lf_on:
        return F
    _, ha, wa = F.shape
    sb_rows, sb_cols = ha // 64, wa // 64
    dev = F.device
    Ff = F.view(-1)
    lf = lfm.reshape(-1).to(torch.int32)
    th = thr.to(torch.int32) << (bd - 8)
    for s in range(sb_cols + 2 * (sb_rows - 1)):
        rs = [r for r in range(sb_rows) if 0 <= s - 2 * r < sb_cols]
        cs = [s - 2 * r for r in rs]
        for d in (0, 1):
            for i in range(8):
                lin, inb, lidx = _chain_lanes(rs, cs, d, i, ha, wa)
                lin_t = torch.from_numpy(np.where(inb, lin, 0)).to(dev)
                inb_t = torch.from_numpy(inb).to(dev)
                v = lf[torch.from_numpy(lidx).to(dev)]
                lvl = (v >> 4).long()
                W = torch.where(inb_t, Ff[lin_t], 0)
                W = _edge_chain(W, v & 15, th[lvl, 1], th[lvl, 2],
                                th[lvl, 3], bd)
                st = inb.copy()
                st[:, [0, 15]] = False
                st_t = torch.from_numpy(st).to(dev)
                Ff[lin_t[st_t]] = W[st_t]
    return F


# ----------------------------------------------------------------- kernel


def lf_frames_plain(F, lfm, thr, lf_on, *, mi_rows, mi_cols, bd):
    """lf_frame_plain on each frame F[k] with lfm[k], thr[k] and
    lf_on[k]; returns F."""
    for k, on in enumerate(lf_on):
        lf_frame_plain(F[k], lfm[k], thr[k], on, mi_rows=mi_rows,
                       mi_cols=mi_cols, bd=bd)
    return F


def _check_frames(F, lfm, thr, lf_on, mi_rows, mi_cols):
    """The stream-axis shapes: F [N, 3, ha, wa] contiguous, lfm
    [N, >= n_sbs, 2, 128] and thr [N, 64, 4] with each frame's entry
    contiguous (any stride between frames), N == len(lf_on)."""
    if F.dim() != 4 or lfm.dim() != 4 or thr.dim() != 3 \
            or not F.shape[0] == lfm.shape[0] == thr.shape[0] == len(lf_on):
        raise ValueError("lf_frames: F [N, 3, ha, wa], lfm [N, n_sbs_pad, "
                         "2, 128], thr [N, 64, 4] and N lf_on values")
    if not F.is_contiguous() or lfm.stride()[1:] != (256, 128, 1) \
            or thr.stride()[1:] != (4, 1):
        raise ValueError("lf_frames: F must be contiguous, and each frame's "
                         "lfm and thr contiguous")
    _check(F[0], lfm[0], thr[0], mi_rows, mi_cols)


def _check(F, lfm, thr, mi_rows, mi_cols):
    if F.dtype != torch.int32 or F.dim() != 3 or F.shape[0] != 3 \
            or not F.is_contiguous():
        raise ValueError("F must be a contiguous int32 [3, ha, wa] tensor")
    _, ha, wa = F.shape
    if ha != ((mi_rows + 7) & ~7) * 8 or wa != ((mi_cols + 7) & ~7) * 8:
        raise ValueError(f"F canvas {ha}x{wa} does not match the "
                         f"{mi_rows}x{mi_cols} mi grid")
    if lfm.dtype != torch.int16 or lfm.dim() != 3 \
            or tuple(lfm.shape[1:]) != (2, 128) or not lfm.is_contiguous() \
            or lfm.shape[0] < (ha // 64) * (wa // 64):
        raise ValueError("lfm must be a contiguous int16 "
                         "[>= n_sbs, 2, 128] tensor")
    if thr.dtype != torch.int16 or tuple(thr.shape) != (64, 4) \
            or not thr.is_contiguous():
        raise ValueError("thr must be a contiguous int16 [64, 4] tensor")
    if lfm.device != F.device or thr.device != F.device:
        raise ValueError("F, lfm and thr must be on one device")


def workspace(F, frames: int = 1):
    """The kernels' int32 scratch for `frames` frames of F's geometry
    ([..., ha, wa]): a row ticket and one progress flag per SB row of each
    frame.  The C entry point zeroes it on the stream before its launch;
    the caching allocator keeps it with the stream, so the next call may
    get the same block back."""
    return torch.empty(1 + frames * (F.shape[-2] // 64), dtype=torch.int32,
                       device=F.device)


def _lib():
    """The bound C entry point; builds csrc/loopfilter.cu at first use."""
    fn = _build.load("loopfilter").vp9_lf_frames
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i
        fn.argtypes = [vp, vp, ll, vp, ll, vp, i, vp, i, i, i, vp,
                       ctypes.POINTER(i)]
    return fn


def lf_frames(F, lfm, thr, lf_on, *, mi_rows: int, mi_cols: int, bd: int):
    """Loop filter the N frames F [N, 3, ha, wa] int32 in place, frame k
    with lfm[k] ([n_sbs_pad, 2, 128] int16), thr[k] ([64, 4] int16) and
    lf_on[k] (a host int; 0 leaves frame k untouched); returns F.  One
    kernel launch filters every frame with a level.  CUDA tensors go to
    the kernel, CPU tensors to lf_frames_plain."""
    if F.device.type == "cpu":
        return lf_frames_plain(F, lfm, thr, lf_on, mi_rows=mi_rows,
                               mi_cols=mi_cols, bd=bd)
    if F.device.type != "cuda":
        raise ValueError(f"lf_frames: unsupported device {F.device}")
    _check_frames(F, lfm, thr, lf_on, mi_rows, mi_cols)
    on = [k for k, v in enumerate(lf_on) if v]
    if not on:
        return F
    global launches
    fn = _lib()
    streams = None
    if len(on) < len(lf_on):
        # the frames with a level, as an int32 device array; every frame
        # is the kernel's identity order and needs none
        streams = torch.tensor(on, dtype=torch.int32).pin_memory().to(
            F.device, non_blocking=True)
    ws = workspace(F, len(on))
    launches += _build.call(
        fn, F.device, F.data_ptr(), lfm.data_ptr(), lfm.stride(0),
        thr.data_ptr(), thr.stride(0),
        None if streams is None else streams.data_ptr(), len(on),
        ws.data_ptr(), F.shape[2], F.shape[3], bd)
    return F


def lf_frame(F, lfm, thr, lf_on: int, *, mi_rows: int, mi_cols: int,
             bd: int):
    """Loop filter F [3, ha, wa] int32 in place; returns F.

    lfm: [n_sbs_pad, 2, 128] int16 (pack_lfm_fields: bits | level << 4 per
    cell); thr: [64, 4] int16 level -> threshold table; lf_on: host int
    (0 skips all work).  The N = 1 call of lf_frames: CUDA tensors go to
    the kernel, CPU tensors to lf_frame_plain."""
    if F.device.type == "cpu":
        return lf_frame_plain(F, lfm, thr, lf_on, mi_rows=mi_rows,
                              mi_cols=mi_cols, bd=bd)
    if F.device.type != "cuda":
        raise ValueError(f"lf_frame: unsupported device {F.device}")
    lf_frames(F[None], lfm[None], thr[None], (lf_on,), mi_rows=mi_rows,
              mi_cols=mi_cols, bd=bd)
    return F
