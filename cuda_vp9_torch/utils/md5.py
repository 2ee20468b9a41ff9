"""Per-frame MD5 of decoded images.

Matches the reference's `decode_to_md5` flow (`libvpx/examples/decode_to_md5.c:44-76`,
`libvpx/md5_utils.c`): hash each plane's visible rows in order Y, U, V, then print
``<md5>  img-WxH-NNNN.i420``.  For high-bit-depth images each sample is two
little-endian bytes (as stored in the frame buffer), matching `vpxdec --md5`.
`frame_bytes` is that byte string, which `vpxdec -o` also writes, so a
frame's bytes in its output file hash to its --md5 line.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


def frame_bytes(planes: Sequence[np.ndarray]) -> bytes:
    """The visible area of each plane, rows in order, Y then U then V.

    `planes` are 2-D numpy arrays already cropped to the visible plane size,
    dtype uint8 (8-bit) or uint16 (high bit depth, written as LE16).
    """
    out = []
    for p in planes:
        a = np.ascontiguousarray(p)
        out.append(a.astype("<u2" if a.dtype == np.uint16 else np.uint8)
                   .tobytes())
    return b"".join(out)


def frame_md5(planes: Sequence[np.ndarray]) -> str:
    """MD5 of `frame_bytes(planes)`."""
    return hashlib.md5(frame_bytes(planes)).hexdigest()


def md5_lines(frames_planes, width: int, height: int) -> str:
    """Render the exact text emitted by decode_to_md5 for a sequence of frames."""
    out = []
    for i, planes in enumerate(frames_planes):
        out.append(f"{frame_md5(planes)}  img-{width}x{height}-{i + 1:04d}.i420")
    return "\n".join(out) + "\n"
