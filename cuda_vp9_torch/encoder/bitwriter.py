"""VP9 entropy encoders: the bool/range encoder and the raw bit writer.

Encoder-side mirror of `decoder/bitreader.py`, with capability parity to
the reference's `vpx_dsp/bitwriter.{h,c}` (vpx_start_encode / vpx_write /
vpx_stop_encode) and `vpx_dsp/bitwriter_buffer.{h,c}` (MSB-first raw bit
writer used for the uncompressed frame header).

Implemented from the normative arithmetic-coding process (VP9 bitstream
spec §9.2): `split = 1 + ((range - 1) * prob >> 8)`, renormalize range
into [128, 255], emit high bits of the low value with carry propagation.
"""

from __future__ import annotations


class BoolEncoder:
    """The VP9 boolean (range) encoder producing a byte buffer.

    The first bool written must be the zero marker bit consumed by
    `vpx_reader_init` (decoder/bitreader.py:36); `start()` handles it.
    """

    __slots__ = ("buf", "lowvalue", "range", "count")

    def __init__(self, marker: bool = True):
        self.buf = bytearray()
        self.lowvalue = 0
        self.range = 255
        self.count = -24
        if marker:
            self.write_bit(0)

    def write(self, bit: int, prob: int) -> None:
        """Encode one bool with P(0) = prob/256."""
        prob = int(prob)
        r = self.range
        split = 1 + (((r - 1) * prob) >> 8)
        if bit:
            self.lowvalue += split
            r -= split
        else:
            r = split
        shift = 8 - r.bit_length()
        self.range = r << shift
        count = self.count + shift
        lowvalue = self.lowvalue
        if count >= 0:
            offset = shift - count
            buf = self.buf
            if (lowvalue << (offset - 1)) & 0x80000000:
                # carry into already-emitted bytes
                x = len(buf) - 1
                while buf[x] == 0xFF:
                    buf[x] = 0
                    x -= 1
                buf[x] += 1
            buf.append((lowvalue >> (24 - offset)) & 0xFF)
            lowvalue = (lowvalue << offset) & 0xFFFFFF
            shift = count
            count -= 8
        self.lowvalue = (lowvalue << shift) & 0xFFFFFFFF
        self.count = count

    def write_bit(self, bit: int) -> None:
        self.write(bit, 128)

    def write_literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def write_tree(self, tree, probs, paths, value: int) -> None:
        """Emit the bits along a vpx token tree path to leaf `value`.

        `paths` is the per-leaf [(node_index, bit), ...] list produced by
        `tree_paths(tree)`; probs indexes by node_index >> 1 like
        BoolDecoder.read_tree.
        """
        for node, bit in paths[value]:
            self.write(bit, probs[node >> 1])

    def stop(self) -> bytes:
        """Flush (32 zero bits, mirroring vpx_stop_encode) and return bytes."""
        for _ in range(32):
            self.write_bit(0)
        # the decoder never reads past its window; trailing zeros are safe
        if not self.buf:
            self.buf.append(0)
        return bytes(self.buf)


def tree_paths(tree) -> dict:
    """Map each leaf value of a vpx tree to its [(node_index, bit)] path."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            j = int(tree[i + bit])
            p = path + [(i, bit)]
            if j <= 0:
                paths[-j] = p
            else:
                walk(j, p)

    walk(0, [])
    return paths


class BitWriter:
    """MSB-first raw bit writer (vpx_write_bit_buffer equivalent)."""

    __slots__ = ("bytes", "bit")

    def __init__(self):
        self.bytes = bytearray()
        self.bit = 0

    def write_bit(self, bit: int) -> None:
        p = self.bit
        if (p & 7) == 0:
            self.bytes.append(0)
        if bit:
            self.bytes[p >> 3] |= 1 << (7 - (p & 7))
        self.bit = p + 1

    def f(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    write_literal = f

    def sf(self, v: int, n: int) -> None:
        """Literal magnitude then sign bit (vpx_wb_write_signed_literal)."""
        self.f(abs(v), n)
        self.write_bit(1 if v < 0 else 0)

    def data(self) -> bytes:
        return bytes(self.bytes)
