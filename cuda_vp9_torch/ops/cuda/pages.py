"""Page expansion (K5's): the CUDA kernel and its plain torch twin.

`expand_pages` rebuilds capacity-padded int16 flats from their compacted
upload: the counterpart of the gather of `cuda_vp9_tpu/runtime/fused.py`
(:513-518), `flat = take(comb_pages, g, axis=0).reshape(-1)`, page map
0 meaning the all-zero page.  `buf` is the upload as it lies on the
device (uint8; `runtime/upload.py` writes it): a table of two int64 per
flat at offset 0, then each flat's int32 page map and its nonzero 1 KB
pages, or its whole flat when it was sent dense.  `flats` gives the same
table in host ints: a `Table`, checked once where the uploader makes it,
or any sequence of `Flat`s, checked at the call.  All flats of one call
have n_pages pages.

On a CUDA tensor `expand_pages` calls `vp9_expand_pages` of
`csrc/pages.cu` with the table's host ints (one launch for every
MAX_FLATS flats of the call: one for a frame or a round of up to 64
streams) or raises; on a CPU tensor it runs `expand_pages_plain`, which
is `comb.index_select(0, g)` per flat, comb the nonzero pages below one
zero page.  Both write `out` [n_flats, n_pages * PAGE] in place.

`launches` counts the kernel launches, `pages` the pages they wrote and
`plain_calls` the calls of the twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

PAGE = 512              # int16 elements of a page (1 KB)
PAGE_BYTES = 2 * PAGE
TABLE_BYTES = 16        # one table entry: two int64
MAX_FLATS = 64          # flats a launch takes (csrc/pages.cu kMaxFlats)

launches = 0
pages = 0
plain_calls = 0


class Flat(NamedTuple):
    """One flat of an upload, as byte offsets into its buffer: `map` of
    the int32 page map [n_pages] (-1: the flat was sent dense), `pages`
    of its `n` pages (int16 [n, PAGE]: the nonzero pages in order, or
    all n_pages pages of a dense flat)."""
    map: int
    pages: int
    n: int


def reset_counts():
    global launches, pages, plain_calls
    launches = 0
    pages = 0
    plain_calls = 0


class Table(tuple):
    """The flats of one upload, a tuple of `Flat`s, checked once: each map
    and page run lies inside the upload's first `nbytes` bytes, past the
    table's own bytes at its head, pages are 16-byte aligned and maps
    4-byte aligned, and a dense flat has all n_pages pages.  `words`
    holds the same offsets as int64 pairs (map, pages), the kernel's
    parameter, at host address `addr`."""

    def __new__(cls, flats, n_pages: int, nbytes: int):
        self = super().__new__(cls, flats)
        start = TABLE_BYTES * len(self)
        for f in self:
            dense = f.map < 0
            if f.pages % 16 or f.pages < start \
                    or f.pages + f.n * PAGE_BYTES > nbytes \
                    or (dense and f.n != n_pages) or (not dense and (
                        f.map % 4 or f.map < start
                        or f.map + 4 * n_pages > nbytes)):
                raise ValueError(f"expand_pages: table entry {f} does not "
                                 f"fit an upload of {nbytes} bytes")
        self.n_pages, self.nbytes = n_pages, nbytes
        self.words = (ctypes.c_int64 * (2 * len(self)))(
            *(v for f in self for v in (f.map, f.pages)))
        self.addr = ctypes.addressof(self.words)
        return self


def _table(out, buf, flats, n_pages: int) -> Table:
    """flats as a Table (checked now unless it is one already); raises
    unless out and buf suit the kernel and the table fits buf."""
    if out.dtype != torch.int16 or not out.is_contiguous() \
            or out.numel() != len(flats) * n_pages * PAGE:
        raise ValueError(f"out must be a contiguous int16 tensor of "
                         f"{len(flats)} x {n_pages} pages")
    if buf.dtype != torch.uint8 or buf.dim() != 1 \
            or not buf.is_contiguous() or buf.device != out.device:
        raise ValueError("buf must be a contiguous uint8 vector on out's "
                         "device")
    if not isinstance(flats, Table):
        flats = Table(flats, n_pages, buf.numel())
    if flats.n_pages != n_pages or flats.nbytes > buf.numel():
        raise ValueError(f"expand_pages: a table of {flats.n_pages} pages "
                         f"a flat over {flats.nbytes} bytes does not fit "
                         f"{n_pages} pages in {buf.numel()} bytes")
    return flats


def _rows(buf, off: int, n: int, width: int, dtype):
    """[n, width] view of buf at byte offset off."""
    nbytes = n * width * dtype.itemsize
    return buf[off:off + nbytes].view(dtype).view(n, width)


def expand_pages_plain(out, buf, flats, n_pages: int):
    """The twin: per flat, comb = [zero page; its pages] and
    out[k] = comb.index_select(0, g) (a dense flat is copied).  In place
    on out; returns out."""
    flats = _table(out, buf, flats, n_pages)
    global plain_calls
    plain_calls += 1
    dst = out.view(len(flats), n_pages, PAGE)
    for k, f in enumerate(flats):
        src = _rows(buf, f.pages, f.n, PAGE, torch.int16)
        if f.map < 0:
            dst[k].copy_(src)
        else:
            comb = torch.cat([src.new_zeros(1, PAGE), src])
            g = _rows(buf, f.map, 1, n_pages, torch.int32)[0]
            torch.index_select(comb, 0, g, out=dst[k])
    return out


def _lib():
    """The bound C entry point; builds csrc/pages.cu at first use."""
    fn = _build.load("pages").vp9_expand_pages
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
    return fn


def expand_pages(out, buf, flats, n_pages: int):
    """Rebuild len(flats) flats of n_pages pages into out [n_flats,
    n_pages * PAGE] int16, in place, from the upload buf (module
    docstring); returns out.  A CUDA out goes to the kernel (out and buf
    16-byte aligned), one launch for every MAX_FLATS flats, a CPU out to
    expand_pages_plain."""
    if out.device.type == "cpu":
        return expand_pages_plain(out, buf, flats, n_pages)
    if out.device.type != "cuda":
        raise ValueError(f"expand_pages: unsupported device {out.device}")
    table = _table(out, buf, flats, n_pages)
    o, b = out.data_ptr(), buf.data_ptr()
    if o % 16 or b % 16:
        raise ValueError("expand_pages: out and buf must be 16-byte "
                         "aligned")
    global launches, pages
    fn = _lib()
    for k in range(0, len(table), MAX_FLATS):
        a = min(MAX_FLATS, len(table) - k)
        n = _build.call(fn, out.device, b, table.addr + TABLE_BYTES * k, a,
                        n_pages, o + k * n_pages * PAGE_BYTES)
        launches += n
        pages += n * a * n_pages
    return out
