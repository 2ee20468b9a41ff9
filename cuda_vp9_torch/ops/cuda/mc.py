"""Motion compensation (K3 and K6) and the inter residual add: the CUDA
kernel and its plain torch twins.

`mc_frame` runs the inter stage of A streams' frames in place on a frame
buffer (`runtime/fused.frame_buffer`: int32 [3A*ha*wa + 1], the stacked
planes [3A, ha, wa] and a trash element): the unscaled tile classes
mc4, mc8, mc16 and mc32 in that order, each with its compound averages,
then the scaled-reference 4x4 class mcs, then F = clip(F + R) over the
non-skip inter mi cells.  It is the counterpart of
`cuda_vp9_tpu/runtime/fused.py` `_mc_pass` (:163) over
`_mc_chunk_compute` (:69), `_mcs_pass` (:388) over `_mcs_chunk_compute`
(:311) and the mask add (:620-633), as the JAX step calls them
(fused.py:603-633); the batched step's vmap of them is written out as a
stream axis: stream k reads pool slots 8 active[k] + slot, and each
chunk is a first or a second prediction by its own stream's n_ref0, a
word of its flat on the device that the single-stream step passes the
same way (A = 1).  Scaled frames leave the batch
(`runtime/multistream.py`), so mcs has the single-stream form only.

Each `McClass` names a class's segments by their offsets in each
stream's int16 flat (flats [A, nflat]: records, chunk headers and the
n_ref0 word) with host ints, and `Mask` the offset of mi_mask with the
chroma format.  On a CUDA tensor `mc_frame` makes one call into
`vp9_mc_pass` of `csrc/mc.cu` with a table of the phases built from
those host ints, which makes one persistent launch on the current
stream (none when there is no chunk and no mask), or raises; on a CPU
tensor it runs `mc_frame_plain`: the plain twins below (`mc_pass`,
`mcs_pass`, `mask_add`) over views of the flats.

`launches` counts the kernel's launches (one per host call),
`host_calls` the calls into the C entry point (at most one per frame, or
per round of the batched step), `phases` the phases those launches ran
(firsts and compound seconds of each class with chunks, and the mask),
`scaled_calls` the launches that ran the scaled class (K6),
`mask_calls` those that ran the mask phase, and `plain_calls` the calls
of the plain twin.
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

from . import _build
from ..device.blocks import block_index, put_blocks

I32 = torch.int32

launches = 0
host_calls = 0
phases = 0
scaled_calls = 0
mask_calls = 0
plain_calls = 0

# int32 words of one workspace line (128 bytes): the ticket and each
# phase's done counter have a line each (csrc/mc.cu kLine)
WS_LINE = 32
# int64 words of one phase descriptor of vp9_mc_pass (csrc/mc.cu
# kDescWords)
DESC_WORDS = 8
# words (int16) and records a chunk header and record of a class: the
# scaled class (w 0) has 4-word headers and 16-word records
HDR_WORDS = {0: 4, 4: 8, 8: 8, 16: 8, 32: 8}
REC_WORDS = {0: 16, 4: 4, 8: 4, 16: 4, 32: 4}


class McClass(NamedTuple):
    """One MC tile class of A streams, as segments of each stream's row of
    the int16 flats [A, nflat]: element offsets of the records [n, ch,
    rw] and chunk headers [n, hw] (rw, hw = 4, 8; the scaled class: 16,
    4), and of the n_ref0 word (the offset of misc plus its slot); n the
    most chunks of a stream, ch the records a chunk; the host bounds of
    its two phases, lo at most the n_ref0 of every stream with a
    compound chunk and hi at least every stream's count of first chunks
    (`grid_bounds`).  w is 4, 8, 16 or 32, or 0 for the scaled class."""
    w: int
    rec: int
    hdr: int
    r0: int
    n: int
    ch: int
    lo: int
    hi: int


class Mask(NamedTuple):
    """The mi_mask segment of each stream's flat: its element offset, the
    mi grid (rows, and columns: 16 a word) and the chroma subsampling."""
    off: int
    mi_rows: int
    mi_cols: int
    ssx: int
    ssy: int


def reset_counts():
    global launches, host_calls, phases, scaled_calls, mask_calls, \
        plain_calls
    launches = 0
    host_calls = 0
    phases = 0
    scaled_calls = 0
    mask_calls = 0
    plain_calls = 0


def grid_bounds(counts, r0s):
    """The bounds (lo, hi) of one class's two phases, from each stream's
    host chunk count and n_ref0: the least n_ref0 of a stream with a
    compound chunk (the most chunks when none has one) and the most first
    chunks of a stream."""
    return (min([r for r, c in zip(r0s, counts) if c > r] or [max(counts)]),
            max(min(r, c) for r, c in zip(r0s, counts)))


def mc_class(segs, w: int, counts, r0s, r0_slot: int) -> McClass:
    """The McClass of tile class w ("mc{w}"; w 0: "mcs") in a flat
    layout's segments {name: (offset, shape)}, from each stream's host
    chunk count and n_ref0 (misc[r0_slot])."""
    name = f"mc{w}" if w else "mcs"
    (rec, shape), hdr = segs[name], segs[name + "h"][0]
    return McClass(w, rec, hdr, segs["misc"][0] + r0_slot, max(counts),
                   shape[1], *grid_bounds(counts, r0s))


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


def class_views(flats, c: McClass):
    """(units [A, n, ch, rw], hdrs [A, n, hw], r0 [A]): class c's int16
    views of the flats [A, nflat]."""
    A = flats.shape[0]
    rw, hw = REC_WORDS[c.w], HDR_WORDS[c.w]
    return (flats[:, c.rec:c.rec + c.n * c.ch * rw].view(A, c.n, c.ch, rw),
            flats[:, c.hdr:c.hdr + c.n * hw].view(A, c.n, hw),
            flats[:, c.r0])


def mask_words(flats, mask: Mask):
    """The int16 view [A, mi_rows, words] of mi_mask in the flats."""
    words = -(-mask.mi_cols // 16)
    return flats[:, mask.off:mask.off + mask.mi_rows * words].view(
        flats.shape[0], mask.mi_rows, words)


def mc_frame_plain(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active,
                   bd: int, ha: int, wa: int):
    """mc_frame's plain twin: mc_pass (mcs_pass for the scaled class) per
    class in order over views of the flats, then mask_add."""
    global plain_calls
    plain_calls += 1
    for c in classes:
        units, hdrs, r0 = class_views(flats, c)
        if c.w:
            mc_pass(Fbuf, pool, kernels, units, hdrs, c.n, r0, active, c.w,
                    bd, ha, wa)
        else:
            mcs_pass(Fbuf, pool, kernels, units, hdrs, c.n, r0, bd, ha, wa)
    if mask is not None:
        A = flats.shape[0]
        mask_add(Fbuf[:-1].view(A, 3, ha, wa), Rbuf[:-1].view(A, 3, ha, wa),
                 mask_words(flats, mask).to(I32), mask.mi_rows, mask.mi_cols,
                 bd, (mask.ssx, mask.ssy))


# ----------------------------------------------------------------- kernel


def _lib(name="vp9_mc_pass"):
    """A bound C entry point of csrc/mc.cu, built at first use."""
    fn = getattr(_build.load("mc"), name)
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i
        fn.argtypes = [vp, vp, i, i, i, vp, i, i, i, vp, vp, i, ll, vp, i,
                       vp, i, i, i, i, i, vp, vp, ctypes.POINTER(i)]
    return fn


def mc_table(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active,
             ha: int, wa: int):
    """(table, n_phases, scaled): the int64 descriptors of the MC phases
    (array.array, DESC_WORDS each, in order: each class's firsts over
    chunks [0, min(hi, n)), then its seconds over [lo, n), where not
    empty), their count, and whether the scaled class runs.  Checks Fbuf
    and Rbuf (contiguous int32 [3A*ha*wa + 1]), flats (int16 [A, nflat],
    each row contiguous), pool (int32 [S, 3, pha, pwa]) and kernels
    (int32 [4, 16, 8]), contiguous, active (int16 [A] or None; None with
    the scaled class), all on one device, that every segment lies in
    a row of the flats, and, with a mask, that wa is a multiple of 4 and
    Fbuf and Rbuf 16-byte aligned; host ints only, no tensor per
    class."""
    if flats.dtype != torch.int16 or flats.dim() != 2 \
            or flats.stride(1) != 1:
        raise ValueError("mc_frame: flats must be int16 [A, nflat], each "
                         "row contiguous")
    A, L = flats.shape
    size = 3 * A * ha * wa + 1
    if Fbuf.dtype != I32 or Rbuf.dtype != I32 or Fbuf.dim() != 1 \
            or Rbuf.dim() != 1 or Fbuf.numel() != size \
            or Rbuf.numel() != size or not Fbuf.is_contiguous() \
            or not Rbuf.is_contiguous():
        raise ValueError("mc_frame: Fbuf and Rbuf must be contiguous int32 "
                         f"frame buffers [{3 * A}*ha*wa + 1]")
    if pool.dtype != I32 or pool.dim() != 4 or pool.shape[1] != 3 \
            or not pool.is_contiguous():
        raise ValueError("mc_frame: pool must be a contiguous int32 [S, 3, "
                         "pha, pwa] tensor")
    if kernels.dtype != I32 or kernels.shape != (4, 16, 8) \
            or not kernels.is_contiguous():
        raise ValueError("mc_frame: kernels must be the contiguous int32 "
                         "[4, 16, 8] filter table")
    if active is not None and (active.dtype != torch.int16
                               or active.shape != (A,)):
        raise ValueError(f"mc_frame: active must be int16 [{A}]")
    dev = Fbuf.device
    if Rbuf.device != dev or pool.device != dev or kernels.device != dev \
            or flats.device != dev \
            or (active is not None and active.device != dev):
        raise ValueError("mc_frame: every tensor must be on Fbuf's device")
    base = flats.data_ptr()
    table, n_phases, scaled = array.array("q"), 0, False
    for c in classes:
        if c.w not in HDR_WORDS or c.ch <= 0 or c.n < 0:
            raise ValueError(f"mc_frame: no tile class {c.w} of {c.ch} "
                             "records a chunk")
        if c.w == 0 and (active is not None or A != 1):
            raise ValueError("mc_frame: the scaled class has one stream's "
                             "form only")
        if min(c.rec, c.hdr, c.r0) < 0 or c.r0 >= L \
                or c.rec + c.n * c.ch * REC_WORDS[c.w] > L \
                or c.hdr + c.n * HDR_WORDS[c.w] > L:
            raise ValueError("mc_frame: a class's segments must lie in the "
                             "flats' rows")
        ptrs = (c.w, base + 2 * c.rec, base + 2 * c.hdr, base + 2 * c.r0,
                c.ch)
        hi, lo = min(c.hi, c.n), max(min(c.lo, c.n), 0)
        if hi > 0:
            table.extend(ptrs + (0, hi, 0))
            n_phases += 1
        if lo < c.n:
            table.extend(ptrs + (lo, c.n, 1))
            n_phases += 1
        scaled = scaled or c.w == 0 and c.n > 0
    if mask is not None:
        words = -(-mask.mi_cols // 16)
        if mask.off < 0 or mask.off + mask.mi_rows * words > L \
                or mask.mi_cols <= 0 or mask.mi_rows <= 0 \
                or (mask.ssx, mask.ssy) not in ((1, 1), (0, 0), (1, 0),
                                                (0, 1)) \
                or mask.mi_rows * 8 > ha or mask.mi_cols * 8 > wa:
            raise ValueError("mc_frame: mi_mask must lie in the flats' rows "
                             "and the frame, chroma 4:2:0, 4:4:4, 4:2:2 or "
                             "4:4:0")
        # the mask phase moves F and R 4 pixels (16 bytes) at a time
        if wa % 4 or Fbuf.data_ptr() % 16 or Rbuf.data_ptr() % 16:
            raise ValueError("mc_frame: with a mask, wa must be a multiple "
                             "of 4 and Fbuf and Rbuf 16-byte aligned")
    return table, n_phases, scaled


def workspace(n_phases: int, device):
    """The kernel's int32 scratch for n_phases phases: the ticket and one
    done counter per phase, a line each.  The C entry point zeroes it on
    the stream before its launch; the caching allocator keeps it with
    the stream."""
    return torch.empty(WS_LINE * (n_phases + 1), dtype=I32, device=device)


def _call(name, Fbuf, Rbuf, pool, kernels, flats, table, n_phases: int,
          mask, active, bd: int, ha: int, wa: int) -> int:
    """One call into the C entry point `name` (vp9_mc_pass or
    vp9_mc_chain_floor) with the MC phases of mc_table; returns its
    launches."""
    ws = workspace(n_phases + (mask is not None), Fbuf.device)
    m = mask or Mask(0, 0, 0, 0, 0)
    return _build.call(
        _lib(name), Fbuf.device, Fbuf.data_ptr(), Rbuf.data_ptr(),
        3 * flats.shape[0], ha, wa, pool.data_ptr(), pool.shape[0],
        pool.shape[2], pool.shape[3], kernels.data_ptr(),
        None if active is None else active.data_ptr(), flats.shape[0],
        flats.stride(0), table.buffer_info()[0], n_phases,
        None if mask is None else flats.data_ptr() + 2 * m.off, m.mi_rows,
        m.mi_cols, m.ssx, m.ssy, bd, ws.data_ptr())


def mc_frame(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active,
             bd: int, ha: int, wa: int):
    """The inter stage of A streams' frames, in place on Fbuf [3A*ha*wa +
    1] (frame k at planes 3k .. 3k + 2) with the residual Rbuf of the
    same shape.  flats: int16 [A, nflat] on the device, stream k's flat
    in row k.  classes: the `McClass`es with chunks, in the order they
    run (mc4 .. mc32, then the scaled class, one stream only).  mask: the
    `Mask` of mi_mask, or None when no stream's mask has a bit set.
    active: int16 [A] on the device, stream k reading pool slots
    8 active[k] + slot, or None for one stream reading slots 0..7.  pool
    [S, 3, pha, pwa] and kernels [4, 16, 8] int32, all on Fbuf's device.
    CUDA tensors go to the kernel (one host call and one launch; none
    when there is nothing to run), CPU tensors to mc_frame_plain."""
    global launches, host_calls, phases, scaled_calls, mask_calls
    if Fbuf.device.type == "cpu":
        return mc_frame_plain(Fbuf, Rbuf, pool, kernels, flats, classes,
                              mask, active, bd, ha, wa)
    if Fbuf.device.type != "cuda":
        raise ValueError(f"mc_frame: unsupported device {Fbuf.device}")
    table, n_phases, scaled = mc_table(Fbuf, Rbuf, pool, kernels, flats,
                                       classes, mask, active, ha, wa)
    if not n_phases and mask is None:
        return
    host_calls += 1
    n = _call("vp9_mc_pass", Fbuf, Rbuf, pool, kernels, flats, table,
              n_phases, mask, active, bd, ha, wa)
    launches += n
    phases += n * (n_phases + (mask is not None))
    scaled_calls += n * scaled
    mask_calls += n * (mask is not None)


def chain_floor(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active,
                bd: int, ha: int, wa: int) -> int:
    """Run vp9_mc_chain_floor on the arguments of a mc_frame call (CUDA
    tensors): the same launch, phases and items with no work, which
    leaves Fbuf as it is.  Returns its launches (1, or 0 with nothing to
    run); counts nothing."""
    table, n_phases, _ = mc_table(Fbuf, Rbuf, pool, kernels, flats,
                                  classes, mask, active, ha, wa)
    if not n_phases and mask is None:
        return 0
    return _call("vp9_mc_chain_floor", Fbuf, Rbuf, pool, kernels, flats,
                 table, n_phases, mask, active, bd, ha, wa)
