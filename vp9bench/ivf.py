"""IVF container and VP9 superframe index, as the benchmark reads them.

The benchmark reads its corpus itself and hands the program whole packets,
so that what the program is given does not depend on the program's own
container code.
"""

from __future__ import annotations

import struct


def read_ivf(path: str):
    """(width, height, [packet bytes, ...]) of an IVF file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"DKIF":
        raise ValueError(f"{path}: not an IVF file")
    hdr_len = struct.unpack_from("<H", data, 6)[0]
    width, height = struct.unpack_from("<HH", data, 12)
    packets, pos = [], hdr_len
    while pos + 12 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 12
        if pos + size > len(data):
            raise ValueError(f"{path}: truncated packet at byte {pos}")
        packets.append(data[pos:pos + size])
        pos += size
    return width, height, packets


def superframe_spans(packet: bytes):
    """(offset, size) of each frame of a packet: the frames of a VP9
    superframe index (VP9 spec, Annex B), or the whole packet."""
    marker = packet[-1] if packet else 0
    if marker & 0xE0 == 0xC0:
        frames = (marker & 7) + 1
        mag = ((marker >> 3) & 3) + 1
        index_len = 2 + mag * frames
        if len(packet) >= index_len and packet[-index_len] == marker:
            spans, off, p = [], 0, len(packet) - index_len + 1
            for _ in range(frames):
                size = int.from_bytes(packet[p:p + mag], "little")
                p += mag
                spans.append((off, size))
                off += size
            if off <= len(packet) - index_len:
                return spans
    return [(0, len(packet))]
