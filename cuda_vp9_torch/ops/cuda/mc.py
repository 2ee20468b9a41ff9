"""Motion compensation (K3 and K6): the CUDA kernel and its plain torch
twins.

`mc_frame` runs the MC stage of A streams' frames in place on a frame
buffer (`runtime/fused.frame_buffer`: int32 [3A*ha*wa + 1], the stacked
planes [3A, ha, wa] and a trash element): the unscaled tile classes
mc4, mc8, mc16 and mc32 in that order, each with its compound averages,
then the scaled-reference 4x4 class mcs.  It is the counterpart of
`cuda_vp9_tpu/runtime/fused.py` `_mc_pass` (:163) over
`_mc_chunk_compute` (:69), and `_mcs_pass` (:388) over
`_mcs_chunk_compute` (:311), as the JAX step calls them
(fused.py:603-619); the batched step's vmap of them is written out as a
stream axis: stream k reads pool slots 8 active[k] + slot, and each
chunk is a first or a second prediction by its own stream's n_ref0, a
device int16 that the single-stream step passes the same way (A = 1).
Scaled frames leave the batch (`runtime/multistream.py`), so mcs has
the single-stream form only.

The records and chunk headers are the int16 wire.  On a CUDA tensor
`mc_frame` makes one call into `vp9_mc_pass` of `csrc/mc.cu`, which
enqueues one grid per class and landing phase with chunks on the
current stream, or raises; on a CPU tensor it runs the plain twins
below (`mc_pass`, `mcs_pass`).

`launches` counts the grids the kernel ran (K3's and K6's),
`scaled_launches` those of the scaled class (K6) among them, as the C
side reports them, `host_calls` the calls into the C entry point (one per
frame, or per round of the batched step) and `plain_calls` the calls of a
plain twin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..device.blocks import block_index, put_blocks

I32 = torch.int32

launches = 0
scaled_launches = 0
host_calls = 0
plain_calls = 0


def reset_counts():
    global launches, scaled_launches, host_calls, plain_calls
    launches = 0
    scaled_launches = 0
    host_calls = 0
    plain_calls = 0


# ----------------------------------------------------------------- plain


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


def _land(Fbuf, pred, plane, y0, x0, valid, first, ha: int, wa: int):
    """Land one MC class's predictions (fused._mc_pass): where `first`
    (a bool per tile) the tile is a first-reference prediction, and the
    destinations of those are distinct; the others are compound second
    predictions that average into them."""
    put_blocks(Fbuf, plane, y0, x0, valid & first, pred, ha, wa)
    second = valid & ~first
    cur = Fbuf[block_index(Fbuf, plane, y0, x0, second, pred.shape[1],
                           pred.shape[2], ha, wa)]
    put_blocks(Fbuf, plane, y0, x0, second, (cur + pred + 1) >> 1, ha, wa)


def mc_pass(Fbuf, pool, kernels, units, hdrs, n_chunks: int, r0, active,
            w: int, bd: int, ha: int, wa: int):
    """One unscaled MC tile class of A streams: units [A, >= n_chunks, CH,
    4] and hdrs [A, >= n_chunks, 8] (int16 wire or sign-extended int32;
    stream k's planes 3k + plane of Fbuf [3A*ha*wa + 1], its slots
    8 active[k] + slot of pool, or slot alone when active is None), r0
    [A] each stream's n_ref0: its chunks from there on are compound
    second predictions."""
    A, _, CH, _ = units.shape
    dev = Fbuf.device
    u = units[:, :n_chunks].reshape(-1, 4).to(I32)
    hd = hdrs[:, :n_chunks].to(I32)
    if active is not None:
        hd = torch.cat([hd[:, :, :1] + 8 * active.to(I32)[:, None, None],
                        hd[:, :, 1:]], 2)
    hd = hd.repeat_interleave(CH, 1).reshape(-1, 8)
    plane = hd[:, 1] + (3 * torch.arange(A, device=dev, dtype=I32)
                        ).repeat_interleave(n_chunks * CH)
    first = (torch.arange(n_chunks, device=dev)[None, :]
             < r0.to(I32)[:, None]).repeat_interleave(CH, 1).reshape(-1)
    pred = mc_predict(pool, kernels, hd, u, w, bd)
    _land(Fbuf, pred, plane, u[:, 1] - 1, u[:, 0] & 0x1FFF, u[:, 1] != 0,
          first, ha, wa)


def mcs_pass(Fbuf, pool, kernels, units, hdrs, n_chunks: int, r0, bd: int,
             ha: int, wa: int):
    """The scaled-reference 4x4 class of one stream (fused._mcs_pass):
    units [1, >= n_chunks, CH, 16] with (plane, dx, dy + 1) in columns
    0..2, hdrs [1, >= n_chunks, 4], r0 [1] its n_ref0.  Runs after the
    unscaled classes, so a compound average with a scaled first reference
    sees its first prediction."""
    CH = units.shape[2]
    u = units[0, :n_chunks].reshape(-1, 16).to(I32)
    hd = hdrs[0, :n_chunks].to(I32).repeat_interleave(CH, 0)
    pred = mcs_predict(pool, kernels, hd, u, bd)
    _land(Fbuf, pred, u[:, 0], u[:, 2] - 1, u[:, 1], u[:, 2] != 0,
          torch.arange(len(u), device=u.device) < r0.to(I32)[0] * CH, ha,
          wa)


def mc_frame_plain(Fbuf, pool, kernels, classes, scaled, active, bd: int,
                   ha: int, wa: int):
    """mc_frame's plain twin: mc_pass per class in order, then
    mcs_pass."""
    global plain_calls
    plain_calls += 1
    for w, units, hdrs, n, r0, _ in classes:
        mc_pass(Fbuf, pool, kernels, units, hdrs, n, r0, active, w, bd, ha,
                wa)
    if scaled is not None:
        mcs_pass(Fbuf, pool, kernels, *scaled[:4], bd, ha, wa)


# ----------------------------------------------------------------- kernel


def grid_bounds(counts, r0s):
    """The bounds (lo, hi) of one class of mc_frame, from each stream's
    host chunk count and n_ref0: the least n_ref0 of a stream with a
    compound chunk (the most chunks when none has one) and the most first
    chunks of a stream."""
    return (min([r for r, c in zip(r0s, counts) if c > r] or [max(counts)]),
            max(min(r, c) for r, c in zip(r0s, counts)))


def _check(Fbuf, pool, kernels, units, hdrs, r0, A: int, rw: int, hw: int,
           n_chunks: int, ha: int, wa: int):
    """Types and shapes: Fbuf int32 [3A*ha*wa + 1]; pool int32 [S, 3, pha,
    pwa] and kernels int32 [4, 16, 8], contiguous; units int16 [A,
    >= n_chunks, CH, rw] and hdrs int16 [A, >= n_chunks, hw] (any stride
    between streams, each stream's records and headers contiguous); r0
    int16 [A]; all on one device."""
    if Fbuf.dtype != I32 or Fbuf.dim() != 1 or not Fbuf.is_contiguous() \
            or Fbuf.numel() != 3 * A * ha * wa + 1:
        raise ValueError("Fbuf must be a contiguous int32 frame buffer "
                         f"[{3 * A}*ha*wa + 1]")
    if pool.dtype != I32 or pool.dim() != 4 or pool.shape[1] != 3 \
            or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous int32 [S, 3, pha, pwa] "
                         "tensor")
    if kernels.dtype != I32 or tuple(kernels.shape) != (4, 16, 8) \
            or not kernels.is_contiguous():
        raise ValueError("kernels must be the contiguous int32 [4, 16, 8] "
                         "filter table")
    ch = units.shape[2] if units.dim() == 4 else 0
    if units.dtype != torch.int16 or units.dim() != 4 \
            or units.shape[0] != A or units.shape[-1] != rw \
            or units.stride()[1:] != (ch * rw, rw, 1) \
            or units.shape[1] < n_chunks:
        raise ValueError(f"units must be int16 records [{A}, >= {n_chunks}, "
                         f"CH, {rw}], each stream's contiguous")
    if hdrs.dtype != torch.int16 or hdrs.dim() != 3 or hdrs.shape[0] != A \
            or hdrs.shape[-1] != hw or hdrs.stride()[1:] != (hw, 1) \
            or hdrs.shape[1] < n_chunks:
        raise ValueError(f"hdrs must be int16 chunk headers [{A}, "
                         f">= {n_chunks}, {hw}], each stream's contiguous")
    if r0.dtype != torch.int16 or tuple(r0.shape) != (A,):
        raise ValueError(f"r0 must be int16 [{A}]")
    if any(t.device != Fbuf.device for t in (pool, kernels, units, hdrs,
                                               r0)):
        raise ValueError("Fbuf, pool, kernels, units, hdrs and r0 must be "
                         "on one device")


def _lib():
    """The bound C entry point; builds csrc/mc.cu at first use."""
    fn = _build.load("mc").vp9_mc_pass
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [vp, i, i, i, vp, i, i, i, vp, vp, i, vp, i, i, vp,
                       ctypes.POINTER(i)]
    return fn


def _desc(kind, units, hdrs, r0, n_chunks, bounds):
    """One class descriptor of vp9_mc_pass: kind (w, or 0 for mcs), the
    wire's and r0's pointers and stream strides, CH, n_chunks and the
    bounds (lo, hi) of the two grids."""
    return [kind, units.data_ptr(), hdrs.data_ptr(), r0.data_ptr(),
            units.stride(0), hdrs.stride(0), r0.stride(0), units.shape[2],
            n_chunks, *bounds, 0]


def mc_frame(Fbuf, pool, kernels, classes, scaled, active, bd: int,
             ha: int, wa: int):
    """The MC stage of A streams' frames, in place on Fbuf [3A*ha*wa + 1]
    (frame k at planes 3k .. 3k + 2).  classes: the unscaled classes with
    chunks, in order, each (w, units int16 [A, >= n, CH, 4], hdrs int16
    [A, >= n, 8], n, r0, bounds): n a host int, the most chunks of any
    stream; r0 int16 [A] on the device, each stream's n_ref0 (its chunks
    from there on are compound second predictions); bounds host ints (lo,
    hi), lo at most the n_ref0 of every stream with a compound chunk and
    hi at least every stream's count of first chunks (`grid_bounds`),
    which only size the kernel's two grids.  scaled: the class mcs in the
    same form (units int16 [1, >= n, CH, 16], hdrs int16 [1, >= n, 4]),
    one stream only, or None.  active: int16 [A] on the device, stream k
    reading pool slots 8 active[k] + slot, or None for one stream reading
    slots 0..7.  pool [S, 3, pha, pwa] and kernels [4, 16, 8] int32, all
    on Fbuf's device.  CUDA tensors go to the kernel (one host call), CPU
    tensors to mc_frame_plain."""
    global launches, scaled_launches, host_calls
    if Fbuf.device.type == "cpu":
        return mc_frame_plain(Fbuf, pool, kernels, classes, scaled, active,
                              bd, ha, wa)
    if Fbuf.device.type != "cuda":
        raise ValueError(f"mc_frame: unsupported device {Fbuf.device}")
    A = 1
    if active is not None:
        A = active.shape[0]
        if active.dtype != torch.int16 or active.dim() != 1 \
                or active.device != Fbuf.device:
            raise ValueError("mc_frame: active must be int16 [A] on Fbuf's "
                             "device")
    descs = []
    for w, units, hdrs, n, r0, bounds in classes:
        if w not in (4, 8, 16, 32):
            raise ValueError(f"mc_frame: no tile class {w}")
        _check(Fbuf, pool, kernels, units, hdrs, r0, A, 4, 8, n, ha, wa)
        if n > 0:
            descs.append(_desc(w, units, hdrs, r0, n, bounds))
    if scaled is not None:
        if active is not None:
            raise ValueError("mc_frame: the scaled class has one stream's "
                             "form only")
        units, hdrs, n, r0, bounds = scaled
        _check(Fbuf, pool, kernels, units, hdrs, r0, 1, 16, 4, n, ha, wa)
        if n > 0:
            descs.append(_desc(0, units, hdrs, r0, n, bounds))
    if not descs:
        return
    desc = np.ascontiguousarray(descs, np.int64)
    host_calls += 1
    launches += _build.call(
        _lib(), Fbuf.device, Fbuf.data_ptr(), 3 * A, ha, wa,
        pool.data_ptr(), pool.shape[0], pool.shape[2], pool.shape[3],
        kernels.data_ptr(), None if active is None else active.data_ptr(),
        A, desc.ctypes.data, len(descs), bd)
    # word 11: the grids the C side enqueued for each class
    scaled_launches += int(desc[desc[:, 0] == 0, 11].sum())
