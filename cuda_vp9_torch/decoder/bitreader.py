"""VP9 raw bit reader and superframe index, and the bool decoder.

Capability parity with the reference's `vpx_dsp/bitreader_buffer.{h,c}`
(MSB-first raw bit reader used for the uncompressed frame header),
`vp9_parse_superframe_index`, and the bool decoder (`vpx_dsp/bitreader.
{h,c}`, VP8's `vp8/decoder/dboolhuff.{h,c}`), implemented from the
normative arithmetic-decoding process (VP9 spec §9.2 / RFC 6386 §7):
maintain an arbitrary-precision value window with `bits` live low-order
bits; `split = 1 + ((range - 1) * prob >> 8)` and renormalize `range`
into [128, 255].  The decoder bool-decodes VP9's tile bitstreams in the
C++ parser (native/); `BoolDecoder` here serves the VP8 decoder (vp8/)
and the Python parse helpers the encoder writes against (encoder/).
"""

from __future__ import annotations


class BoolDecoder:
    """The boolean (range) decoder over a byte buffer."""

    __slots__ = ("data", "pos", "end", "value", "range", "bits", "_virtual",
                 "marker_bad")

    def __init__(self, data, start: int = 0, size: int | None = None,
                 marker: bool = True):
        self.data = data
        self.pos = start
        self.end = start + (len(data) - start if size is None else size)
        self.value = 0
        self.range = 255
        self.bits = -8  # forces initial fill of at least one byte
        self._virtual = 0  # zero bytes synthesized past the end (overrun)
        self._fill()
        # vpx_reader_init consumes a marker bit that must decode to zero
        # (vpx_dsp/bitreader.c:38 `return vpx_read_bit(r) != 0`).  VP8's
        # bool decoder (RFC 6386 §7.1) has no marker bit: marker=False.
        self.marker_bad = (self.read_bit() != 0) if marker else False

    def _fill(self):
        # Load up to 7 bytes at a time into the low bits of the window.
        data, pos, end = self.data, self.pos, self.end
        v = self.value
        bits = self.bits
        while bits < 48:
            if pos < end:
                v = (v << 8) | data[pos]
                pos += 1
            else:
                v <<= 8
                self._virtual += 1
            bits += 8
        self.value = v
        self.bits = bits
        self.pos = pos

    def has_error(self) -> bool:
        """True if the decoder consumed synthesized bytes beyond real input."""
        return self._virtual * 8 > self.bits + 8

    def read(self, prob: int) -> int:
        """Decode one bool with P(0) = prob/256."""
        bits = self.bits
        if bits < 8:
            self._fill()
            bits = self.bits
        r = self.range
        split = 1 + (((r - 1) * int(prob)) >> 8)
        bigsplit = split << bits
        if self.value >= bigsplit:
            bit = 1
            r -= split
            self.value -= bigsplit
        else:
            bit = 0
            r = split
        # renormalize: range must land in [128, 255]
        shift = 8 - r.bit_length()
        self.range = r << shift
        self.bits = bits - shift
        return bit

    def read_bit(self) -> int:
        return self.read(128)

    def read_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read(128)
        return v

    def read_tree(self, tree, probs) -> int:
        """Walk a vpx token tree: negative/leaf values end the walk."""
        i = 0
        while True:
            i = int(tree[i + self.read(probs[i >> 1])])
            if i <= 0:
                return -i


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
