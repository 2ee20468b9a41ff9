"""IVF container read/write.

Capability parity with the reference's IVF demux/mux
(`libvpx/ivfdec.c`, `libvpx/ivfenc.c`, `libvpx/video_reader.c`): 32-byte
file header ("DKIF"), 12-byte per-frame headers (LE frame size + 64-bit pts).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional, Tuple

IVF_FILE_HDR_SZ = 32
IVF_FRAME_HDR_SZ = 12
_DKIF = b"DKIF"

FOURCC_VP8 = b"VP80"
FOURCC_VP9 = b"VP90"


def is_ivf(buf: bytes) -> bool:
    return len(buf) >= 4 and buf[:4] == _DKIF


def is_vp8(path) -> bool:
    """Whether `path` is an IVF file whose fourcc is VP80 (vpxdec's codec
    probe); anything else, WebM included, is VP9."""
    try:
        with IvfReader(str(path)) as r:
            return r.fourcc == FOURCC_VP8
    except ValueError:          # not IVF
        return False


@dataclass
class IvfHeader:
    fourcc: bytes
    width: int
    height: int
    timebase_num: int  # "rate" field: timebase denominator in vpx terms
    timebase_den: int
    frame_count: int


class IvfReader:
    """Iterates (frame_bytes, pts) over an IVF file or file-like object."""

    def __init__(self, src):
        if isinstance(src, (str, bytes)) and not hasattr(src, "read"):
            self._f: BinaryIO = open(src, "rb")
            self._owns = True
        else:
            self._f = src
            self._owns = False
        hdr = self._f.read(IVF_FILE_HDR_SZ)
        if len(hdr) < IVF_FILE_HDR_SZ or hdr[:4] != _DKIF:
            raise ValueError("not an IVF file (missing DKIF signature)")
        (version, hdr_sz) = struct.unpack_from("<HH", hdr, 4)
        if version != 0:
            raise ValueError(f"unsupported IVF version {version}")
        fourcc = hdr[8:12]
        w, h = struct.unpack_from("<HH", hdr, 12)
        rate, scale = struct.unpack_from("<II", hdr, 16)
        (count,) = struct.unpack_from("<I", hdr, 24)
        self.header = IvfHeader(fourcc, w, h, rate, scale, count)
        if hdr_sz > IVF_FILE_HDR_SZ:
            self._f.read(hdr_sz - IVF_FILE_HDR_SZ)

    @property
    def fourcc(self) -> bytes:
        return self.header.fourcc

    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    def read_frame(self) -> Optional[Tuple[bytes, int]]:
        hdr = self._f.read(IVF_FRAME_HDR_SZ)
        if len(hdr) < IVF_FRAME_HDR_SZ:
            return None
        (size,) = struct.unpack_from("<I", hdr, 0)
        (pts,) = struct.unpack_from("<q", hdr, 4)
        data = self._f.read(size)
        if len(data) < size:
            return None
        return data, pts

    def __iter__(self) -> Iterator[Tuple[bytes, int]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IvfWriter:
    def __init__(self, dst, fourcc: bytes, width: int, height: int,
                 timebase_num: int = 30, timebase_den: int = 1):
        if isinstance(dst, (str, bytes)) and not hasattr(dst, "write"):
            self._f: BinaryIO = open(dst, "wb")
            self._owns = True
        else:
            self._f = dst
            self._owns = False
        self._fourcc = fourcc
        self._w, self._h = width, height
        self._tb = (timebase_num, timebase_den)
        self._count = 0
        self._write_header()

    def _write_header(self):
        self._f.seek(0)
        self._f.write(_DKIF)
        self._f.write(struct.pack("<HH", 0, IVF_FILE_HDR_SZ))
        self._f.write(self._fourcc)
        self._f.write(struct.pack("<HH", self._w, self._h))
        self._f.write(struct.pack("<II", self._tb[0], self._tb[1]))
        self._f.write(struct.pack("<II", self._count, 0))

    def write_frame(self, data: bytes, pts: int):
        self._f.write(struct.pack("<I", len(data)))
        self._f.write(struct.pack("<q", pts))
        self._f.write(data)
        self._count += 1

    def close(self):
        pos = self._f.tell()
        self._write_header()
        self._f.seek(pos)
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
