"""VP9 raw bit reader and superframe index.

Capability parity with the reference's `vpx_dsp/bitreader_buffer.{h,c}`
(MSB-first raw bit reader used for the uncompressed frame header) and
`vp9_parse_superframe_index`.  The tile bitstreams' bool decoder lives in
the C++ parser (native/).
"""

from __future__ import annotations


class BitReader:
    """MSB-first raw bit reader (vpx_read_bit_buffer equivalent)."""

    __slots__ = ("data", "bit", "size_bits")

    def __init__(self, data, start: int = 0):
        self.data = data
        self.bit = start * 8
        self.size_bits = len(data) * 8

    def read_bit(self) -> int:
        p = self.bit
        self.bit = p + 1
        if p >= self.size_bits:
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    read_literal = f

    def sf(self, n: int) -> int:
        """Literal then sign bit (vpx_rb_read_signed_literal)."""
        v = self.f(n)
        return -v if self.read_bit() else v

    def inv_sf(self, n: int) -> int:
        """Inverse signed literal used by delta-q etc (value then sign)."""
        return self.sf(n)

    def byte_offset(self) -> int:
        return (self.bit + 7) >> 3

    def overrun(self) -> bool:
        return self.bit > self.size_bits


def parse_superframe_index(data: bytes):
    """Split a VP9 superframe into its sub-frames.

    Mirrors `vp9_parse_superframe_index` (vp9/vp9_dx_iface.c:354): a trailing
    marker byte 110xxxxx encodes frame count and size-field width; the index
    sits at the end of the buffer, bracketed by two copies of the marker.
    Returns a list of (offset, size) spans; a plain frame yields one span.
    """
    if not data:
        return []
    marker = data[-1]
    if (marker & 0xE0) == 0xC0:
        frames = (marker & 0x7) + 1
        mag = ((marker >> 3) & 0x3) + 1
        index_sz = 2 + mag * frames
        if len(data) >= index_sz and data[-index_sz] == marker:
            spans = []
            off = 0
            p = len(data) - index_sz + 1
            for _ in range(frames):
                sz = int.from_bytes(data[p:p + mag], "little")
                p += mag
                if off + sz > len(data) - index_sz:
                    break
                spans.append((off, sz))
                off += sz
            if len(spans) == frames:
                return spans
    return [(0, len(data))]
