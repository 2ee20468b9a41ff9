"""The corpus's content generator.

A copy of `synth_video` from the repository's fixture tools
(`tools/make_fixtures.py`), kept beside the corpus so that the yardstick
does not move with the tools: synthetic I420 frames with a moving
gradient and sinusoid, a translating noise texture (sub-pel motion), a
sharp moving square (edges, intra refresh), a static detailed corner
(skip blocks) and smooth chroma.  `seed` picks the noise texture.
"""

from __future__ import annotations

import numpy as np


def synth_video(w: int, h: int, n: int, bitdepth: int = 8, seed: int = 7) -> bytes:
    """Synthetic I420 content with gradients, motion, edges, noise, static areas."""
    rng = np.random.default_rng(seed)
    maxval = (1 << bitdepth) - 1
    dt = np.uint16 if bitdepth > 8 else np.uint8
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # a fixed noise texture that translates over time (sub-pel-friendly content)
    tex = rng.normal(0, 1, (h * 2, w * 2)).astype(np.float32)
    # smooth big blobs
    out = bytearray()
    cw, ch = (w + 1) // 2, (h + 1) // 2
    cyy, cxx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    for t in range(n):
        # moving diagonal gradient + moving sinusoid + translating texture window
        g = 0.35 * (xx + 1.7 * yy) / (w + h) + 0.2 * np.sin(
            (xx * 0.05 + t * 0.37)) * np.cos(yy * 0.043 - t * 0.21)
        dx = (t * 2.5) % w
        dy = (t * 1.25) % h
        ix = (np.arange(w) + int(dx)) % (2 * w - w)
        iy = (np.arange(h) + int(dy)) % (2 * h - h)
        window = tex[np.ix_(iy, ix)]
        y = 0.55 + 0.3 * g + 0.05 * window
        # sharp moving square (forces intra refresh / edges)
        sx = int((t * 7) % max(1, w - 24))
        sy = int((t * 5) % max(1, h - 24))
        y[sy:sy + 24, sx:sx + 24] = 0.15 + 0.02 * window[:24, :24]
        # static high-detail corner (skip blocks once coded)
        y[: h // 4, : w // 4] = 0.5 + 0.12 * tex[: h // 4, : w // 4]
        yq = np.clip(y * maxval, 0, maxval).astype(dt)
        u = 0.5 + 0.2 * np.sin(cxx * 0.07 + t * 0.11)
        v = 0.5 + 0.2 * np.cos(cyy * 0.09 - t * 0.07)
        uq = np.clip(u * maxval, 0, maxval).astype(dt)
        vq = np.clip(v * maxval, 0, maxval).astype(dt)
        for p in (yq, uq, vq):
            out += (p.astype("<u2") if bitdepth > 8 else p).tobytes()
    return bytes(out)
