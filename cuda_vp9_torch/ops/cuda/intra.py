"""Intra wavefront (K4): the CUDA kernel and its plain torch twin.

`intra_pass` runs the intra chunks of one frame in order, in place on a
frame buffer (`runtime/fused.frame_buffer`: int32 [3*ha*wa + 1], the
frame and a trash element) with the residual R [3, ha, wa]: the
counterpart of `cuda_vp9_tpu/runtime/fused.py` `_intra_pass` (:452),
`_intra_chunk` (:433) and `ops/device/stages.py` `intra_wave` (:161).
`intra_pass_batched` is the batched step's form (that vmap written out
as a stream axis): chunk i of each of A streams is one step of the chain
over the frames' stacked planes [3A, ha, wa], each record with its own
stream's block size, and a stream with fewer chunks runs padding.

The chunks are the int16 wire records, 4 words each (`intra_chunk`).  On a
CUDA tensor both forms make one call into `vp9_intra_pass` of
`csrc/intra.cu`, which zeroes a workspace and makes one persistent
launch on the current stream: its blocks claim the chunks' items in
order and hand each chunk to the next through a done counter on the
device, with every block size read from chunk_bs on the device.  On a
CPU tensor they run `intra_pass_plain` / `intra_pass_batched_plain`, the
chunk loop over `stages.intra_wave`.

`launches` counts the kernel launches (one per host call), `chunks` the
chunks those launches ran (the grids of the design before this one),
`host_calls` the calls into the C entry point (one per frame, or per
round of the batched step) and `plain_calls` the calls of a plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..device import stages

I32 = torch.int32

launches = 0
chunks = 0
host_calls = 0
plain_calls = 0

# int32 words of one workspace line (128 bytes): the ticket and each
# chunk's done counter have a line each (csrc/intra.cu kLine)
WS_LINE = 32


def reset_counts():
    global launches, chunks, host_calls, plain_calls
    launches = 0
    chunks = 0
    host_calls = 0
    plain_calls = 0


# ----------------------------------------------------------------- plain


def intra_chunk(Fbuf, R, u, bs: int, bd: int, plane_off=None, keep=None):
    """One intra chunk through stages.intra_wave, all of block size bs,
    from its 4-int16 records (fused.py:433):
      w0 = x0/4 | plane << 14
      w1 = (y0/4 + 1) | have_up << 15      (all-zero record = padding)
      w2 = mode | n_above << 4 | n_left << 10
      w3 = tl_mode | have_left << 2
    u [CHUNK, 4], int16 or sign-extended int32.  For a stack of frames,
    plane_off [CHUNK] adds each record's frame offset 3s to its plane, and
    records where keep [CHUNK] is false are padding."""
    u = u.to(I32)
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


def intra_pass_plain(Fbuf, R, chunks, chunk_bs, n_chunks: int, bd: int):
    """Chunks 0 .. n_chunks - 1 in order, chunk i of block size
    4 << chunk_bs[i] (host ints)."""
    global plain_calls
    plain_calls += 1
    for i in range(n_chunks):
        intra_chunk(Fbuf, R, chunks[i], 4 << int(chunk_bs[i]), bd)


def intra_pass_batched_plain(Fbuf, R, chunks, chunk_bs, counts,
                             n_chunks: int, bd: int):
    """Chunk index i of every stream per step: one intra_chunk call per
    distinct block size among the streams that have a chunk i, the
    records of the other streams (and of streams without a chunk i) kept
    out as padding."""
    global plain_calls
    plain_calls += 1
    A, _, ich, _ = chunks.shape
    dev = Fbuf.device
    cbs = chunk_bs.to(I32)
    cnt = counts.to(I32)
    cbs_h = cbs.cpu().numpy()
    cnt_h = cnt.cpu().numpy()
    off = (3 * torch.arange(A, device=dev, dtype=I32)).repeat_interleave(ich)
    for i in range(n_chunks):
        has = cnt_h > i
        codes = sorted({int(c) for c in cbs_h[has, i]})
        u = chunks[:, i].reshape(-1, 4)
        for c in codes:
            keep = None if len(codes) == 1 and has.all() else (
                (cbs[:, i] == c) & (cnt > i))[:, None].expand(A, ich
                                                             ).reshape(-1)
            intra_chunk(Fbuf, R, u, 4 << c, bd, off, keep)


# ----------------------------------------------------------------- kernel


def _check(Fbuf, R, chunks, lead: int):
    """Types and shapes: Fbuf int32 [P*ha*wa + 1], R int32 [P, ha, wa],
    chunks int16 [..., ich, 4] with `lead` leading dimensions, each
    [ich, 4] chunk contiguous."""
    if Fbuf.dtype != torch.int32 or Fbuf.dim() != 1 \
            or not Fbuf.is_contiguous():
        raise ValueError("Fbuf must be a contiguous int32 frame buffer")
    if R.dtype != torch.int32 or R.dim() != 3 or not R.is_contiguous() \
            or Fbuf.numel() != R.numel() + 1:
        raise ValueError("R must be a contiguous int32 [P, ha, wa] tensor "
                         "with Fbuf [P*ha*wa + 1]")
    if chunks.dtype != torch.int16 or chunks.dim() != lead + 2 \
            or chunks.shape[-1] != 4 \
            or chunks.stride()[-2:] != (4, 1) \
            or chunks.stride(-3) != 4 * chunks.shape[-2]:
        raise ValueError("chunks must be int16 records [..., ich, 4], each "
                         "chunk contiguous")
    if R.device != Fbuf.device or chunks.device != Fbuf.device:
        raise ValueError("Fbuf, R and chunks must be on one device")


def _lib(name="vp9_intra_pass"):
    """A bound C entry point of csrc/intra.cu, built at first use."""
    fn = getattr(_build.load("intra"), name)
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i
        fn.argtypes = {
            "vp9_intra_pass": [vp, vp, vp, ll, vp, ll, vp, ll, i, i, i, i, i,
                               i, i, vp, vp, ctypes.POINTER(i)],
            "vp9_intra_chain_floor": [i, i, i, vp, vp, ctypes.POINTER(i)],
            "vp9_empty_launches": [i, vp]}[name]
    return fn


def workspace(n_chunks: int, device):
    """The kernel's int32 scratch for a chain of n_chunks chunks: the
    ticket and one done counter per chunk, a line each.  The C entry
    point zeroes it on the stream before its launch; the caching
    allocator keeps it with the stream."""
    return torch.empty(WS_LINE * (n_chunks + 1), dtype=torch.int32,
                       device=device)


def _launch(Fbuf, R, rec, rec_stride, cbs, cbs_stride, cnt, cnt_stride,
            n_streams, ich, n_chunks, bd):
    """One call into vp9_intra_pass (pointers and element strides as the
    C side takes them; cnt None: every stream has n_chunks chunks)."""
    global launches, chunks, host_calls
    P, ha, wa = R.shape
    ws = workspace(n_chunks, Fbuf.device)
    host_calls += 1
    launches += _build.call(
        _lib(), Fbuf.device, Fbuf.data_ptr(), R.data_ptr(), rec, rec_stride,
        cbs, cbs_stride, cnt, cnt_stride, n_streams, ich, n_chunks, P, ha,
        wa, bd, ws.data_ptr())
    chunks += n_chunks


def intra_pass(Fbuf, R, chunks, chunk_bs, n_chunks: int, bd: int):
    """Run intra chunks 0 .. n_chunks - 1 of one frame in order, in place
    on Fbuf.  chunks: int16 [>= n_chunks, ich, 4] wire records on Fbuf's
    device; chunk_bs: int16 [>= n_chunks] block size codes 0..3, on
    Fbuf's device (the twin also takes host ints).  CUDA tensors go to
    the kernel (one launch), CPU tensors to intra_pass_plain."""
    if Fbuf.device.type == "cpu":
        return intra_pass_plain(Fbuf, R, chunks, chunk_bs, n_chunks, bd)
    if Fbuf.device.type != "cuda":
        raise ValueError(f"intra_pass: unsupported device {Fbuf.device}")
    _check(Fbuf, R, chunks, 1)
    if getattr(chunk_bs, "device", None) != Fbuf.device \
            or chunk_bs.dtype != torch.int16 or chunk_bs.dim() != 1 \
            or chunk_bs.stride(0) != 1 or R.shape[0] != 3:
        raise ValueError("intra_pass: chunk_bs must be int16 [n] on Fbuf's "
                         "device, R [3, ha, wa]")
    if n_chunks <= 0:
        return
    if chunks.shape[0] < n_chunks or chunk_bs.shape[0] < n_chunks:
        raise ValueError("intra_pass: fewer chunks than n_chunks")
    _launch(Fbuf, R, chunks.data_ptr(), 0, chunk_bs.data_ptr(), 0, None, 0,
            1, chunks.shape[1], n_chunks, bd)


def intra_pass_batched(Fbuf, R, chunks, chunk_bs, counts, n_chunks: int,
                       bd: int):
    """The intra chunks of A streams' frames in one pass, in place on
    Fbuf [3A*ha*wa + 1] (frame k at planes 3k .. 3k + 2 of R [3A, ha,
    wa]): chunk index i of every stream, for i in 0 .. n_chunks - 1.
    chunks: int16 [A, >= n_chunks, ich, 4], chunk_bs: int16 [A, >=
    n_chunks] and counts: int16 [A] (each stream's chunk count, misc[3]),
    all on Fbuf's device, any stride between streams.  n_chunks: a host
    int, the most chunks of any stream.  CUDA tensors go to the kernel
    (one launch), CPU tensors to intra_pass_batched_plain."""
    if Fbuf.device.type == "cpu":
        return intra_pass_batched_plain(Fbuf, R, chunks, chunk_bs, counts,
                                        n_chunks, bd)
    if Fbuf.device.type != "cuda":
        raise ValueError(f"intra_pass_batched: unsupported device "
                         f"{Fbuf.device}")
    _check(Fbuf, R, chunks, 2)
    A = chunks.shape[0]
    if chunk_bs.dtype != torch.int16 or chunk_bs.dim() != 2 \
            or chunk_bs.stride(1) != 1 or counts.dtype != torch.int16 \
            or tuple(counts.shape) != (A,) or chunk_bs.shape[0] != A \
            or R.shape[0] != 3 * A or chunk_bs.device != Fbuf.device \
            or counts.device != Fbuf.device:
        raise ValueError("intra_pass_batched: chunk_bs must be int16 [A, n], "
                         "counts int16 [A], R [3A, ha, wa], on Fbuf's device")
    if n_chunks <= 0:
        return
    if chunks.shape[1] < n_chunks or chunk_bs.shape[1] < n_chunks:
        raise ValueError("intra_pass_batched: fewer chunks than n_chunks")
    _launch(Fbuf, R, chunks.data_ptr(), chunks.stride(0), chunk_bs.data_ptr(),
            chunk_bs.stride(0), counts.data_ptr(), counts.stride(0), A,
            chunks.shape[2], n_chunks, bd)


def chain_floor(n_streams: int, ich: int, n_chunks: int, device) -> int:
    """Run vp9_intra_chain_floor on `device`'s current stream: the chain
    of a pass of n_chunks chunks of n_streams x ich units with no work
    per item.  Returns its launches (1); counts nothing."""
    ws = workspace(n_chunks, device)
    return _build.call(_lib("vp9_intra_chain_floor"), device, n_streams,
                       ich, n_chunks, ws.data_ptr())
