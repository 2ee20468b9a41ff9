"""Per-frame MD5 of decoded images.

Matches the reference's `decode_to_md5` flow (`libvpx/examples/decode_to_md5.c:44-76`,
`libvpx/md5_utils.c`): hash each plane's visible rows in order Y, U, V, then print
``<md5>  img-WxH-NNNN.i420``.  For high-bit-depth images each sample is two
little-endian bytes (as stored in the frame buffer), matching `vpxdec --md5`.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


def frame_md5(planes: Sequence[np.ndarray]) -> str:
    """MD5 over the visible area of each plane (rows hashed in order).

    `planes` are 2-D numpy arrays already cropped to the visible plane size,
    dtype uint8 (8-bit) or uint16 (high bit depth, hashed as LE16).
    """
    m = hashlib.md5()
    for p in planes:
        a = np.ascontiguousarray(p)
        if a.dtype == np.uint16:
            m.update(a.astype("<u2").tobytes())
        else:
            m.update(a.astype(np.uint8).tobytes())
    return m.hexdigest()


def md5_lines(frames_planes, width: int, height: int) -> str:
    """Render the exact text emitted by decode_to_md5 for a sequence of frames."""
    out = []
    for i, planes in enumerate(frames_planes):
        out.append(f"{frame_md5(planes)}  img-{width}x{height}-{i + 1:04d}.i420")
    return "\n".join(out) + "\n"
