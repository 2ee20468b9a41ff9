"""Y4M (YUV4MPEG2) raw-video container.

Reader parity with the reference's `y4minput.{c,h}` (vpxenc's raw input
path) for the common subset: C420/C420jpeg/C420mpeg2/C420paldv (treated
as 4:2:0), C422, C444, and the 10/12-bit `p10`/`p12` variants.  Writer
mirrors vpxdec's `--y4m` output header.
"""

from __future__ import annotations

import re

import numpy as np

_MAGIC = b"YUV4MPEG2"


def is_y4m(buf: bytes) -> bool:
    return buf[:9] == _MAGIC


class Y4mReader:
    """Iterates (y, u, v) numpy planes from a .y4m file."""

    def __init__(self, src):
        self._f = open(src, "rb") if isinstance(src, (str, bytes)) else src
        header = self._f.readline()
        if not header.startswith(_MAGIC):
            raise ValueError("not a YUV4MPEG2 stream")
        self.width = 0
        self.height = 0
        self.fps = (30, 1)
        self.bit_depth = 8
        self.ss_x = self.ss_y = 1
        colorspace = "420"
        for tok in header.split()[1:]:
            tag, val = chr(tok[0]), tok[1:].decode("ascii", "replace")
            if tag == "W":
                self.width = int(val)
            elif tag == "H":
                self.height = int(val)
            elif tag == "F":
                m = re.match(r"(\d+):(\d+)", val)
                if m:
                    self.fps = (int(m.group(1)), int(m.group(2)))
            elif tag == "C":
                colorspace = val
        if self.width <= 0 or self.height <= 0:
            raise ValueError("y4m header missing W/H")
        m = re.match(r"(420|422|444)(jpeg|mpeg2|paldv)?(p(10|12))?",
                     colorspace)
        if not m:
            raise ValueError(f"unsupported y4m colorspace C{colorspace}")
        ss = m.group(1)
        self.ss_x = 1 if ss in ("420", "422") else 0
        self.ss_y = 1 if ss == "420" else 0
        if m.group(3):
            self.bit_depth = int(m.group(4))

    def _plane_shape(self, plane: int):
        if plane == 0:
            return self.height, self.width
        return ((self.height + self.ss_y) >> self.ss_y,
                (self.width + self.ss_x) >> self.ss_x)

    def read_frame(self):
        """Returns [y, u, v] planes or None at EOF."""
        line = self._f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("bad y4m FRAME marker")
        dt = np.uint16 if self.bit_depth > 8 else np.uint8
        bpp = 2 if self.bit_depth > 8 else 1
        planes = []
        for p in range(3):
            h, w = self._plane_shape(p)
            raw = self._f.read(h * w * bpp)
            if len(raw) < h * w * bpp:
                return None  # truncated tail frame
            planes.append(np.frombuffer(raw, dt).reshape(h, w))
        return planes

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RawYuvReader:
    """Headerless I420 .yuv reader (vpxenc's default input format)."""

    def __init__(self, src, width: int, height: int, bit_depth: int = 8):
        self._f = open(src, "rb") if isinstance(src, (str, bytes)) else src
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.ss_x = self.ss_y = 1
        self.fps = (30, 1)

    def read_frame(self):
        w, h = self.width, self.height
        cw, ch = (w + 1) >> 1, (h + 1) >> 1
        dt = np.uint16 if self.bit_depth > 8 else np.uint8
        bpp = 2 if self.bit_depth > 8 else 1
        need = (w * h + 2 * cw * ch) * bpp
        raw = self._f.read(need)
        if len(raw) < need:
            return None
        y = np.frombuffer(raw[:w * h * bpp], dt).reshape(h, w)
        u = np.frombuffer(raw[w * h * bpp:(w * h + cw * ch) * bpp],
                          dt).reshape(ch, cw)
        v = np.frombuffer(raw[(w * h + cw * ch) * bpp:], dt).reshape(ch, cw)
        return [y, u, v]

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_raw_video(path: str, width: int = 0, height: int = 0,
                   bit_depth: int = 8):
    """Open an uncompressed-video input for encoding: .y4m by probe,
    otherwise raw I420 (requires width/height)."""
    with open(path, "rb") as f:
        magic = f.read(9)
    if is_y4m(magic):
        return Y4mReader(path)
    if width <= 0 or height <= 0:
        raise ValueError("raw yuv input requires --width/--height")
    return RawYuvReader(path, width, height, bit_depth)
