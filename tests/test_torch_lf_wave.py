"""The port's 4:2:2 chroma loop filter (cuda_vp9_torch/ops/device/lf_wave.py).

`lf_plane_tiles` filters one 4:2:2 chroma plane in the order of the luma
superblocks: tiles of 32 x 64 pixels (gx = 4, gy = 8 cells) in raster
order, each tile's vertical edges, then its horizontal ones.  The same
seeded plane and per-cell maps go through:

  * the NumPy oracle's window filters (`cuda_vp9_tpu/ops/ref/loopfilter`
    `_apply_vertical` / `_apply_horizontal`) applied in that order;
  * the JAX package's `lf_plane_tiles` (marked slow: its tile loop
    compiles for about 20 s on XLA:CPU).

Pixels are 8x8 blocks of random level and noise amplitude, so every
filter width engages; the edge masks are those of test_pallas_lf (no
edge on the plane's top and left borders).  Tolerance 0: integer math."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.device import lf_wave as TW
from cuda_vp9_tpu.ops.ref import loopfilter as ref_lf

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

GX, GY = 4, 8           # 4:2:2 chroma: a luma SB is 4 x 8 chroma cells


def _plane_inputs(rng, Hp, Wp, bd):
    """(P [Hp, Wp] int32, vbits, hbits, mb, lm, hv [Hp/8, Wp/8] int32,
    per-cell level, threshold tables)."""
    s = bd - 8
    R, C = Hp // 8, Wp // 8
    lvl = rng.integers(0, 256 << s, (R, C))
    amp = rng.choice([1, 3, 9, 40], (R, C)) << s
    noise = rng.integers(-64 << s, (64 << s) + 1, (Hp, Wp)) % np.repeat(
        np.repeat(amp, 8, 0), 8, 1)
    P = np.clip(np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0,
                (1 << bd) - 1).astype(np.int32)

    def bits(top):
        kind = rng.integers(0, 4, (R, C))
        m16, m8, m4 = kind == 1, kind == 2, kind == 3
        m4i = (rng.random((R, C)) < 0.4) & ~m16
        for m in (m16, m8, m4):
            if top:
                m[0, :] = False
            else:
                m[:, 0] = False
        return (m16 | m8 << 1 | m4 << 2 | m4i << 3).astype(np.int32)

    vb, hb = bits(False), bits(True)
    thr = ref_lf.make_thresholds(int(rng.integers(0, 8)))
    lv = rng.integers(0, 64, (R, C))
    mb, lm, hv = (np.asarray(t)[lv].astype(np.int32) for t in thr)
    return P, vb, hb, mb, lm, hv


def _oracle(P, vb, hb, mb, lm, hv, bd):
    """The oracle window filters in luma-SB tile raster order."""
    plane = P.astype(np.int64)
    R, C = vb.shape
    for tr in range(R // GY):
        for tc in range(C // GX):
            rows = range(tr * GY, tr * GY + GY)
            cols = range(tc * GX, tc * GX + GX)
            for apply, bits in ((ref_lf._apply_vertical, vb),
                                (ref_lf._apply_horizontal, hb)):
                vertical = apply is ref_lf._apply_vertical
                for a in (cols if vertical else rows):
                    for b in (rows if vertical else cols):
                        r, c = (b, a) if vertical else (a, b)
                        k = int(bits[r, c])
                        args = (int(mb[r, c]), int(lm[r, c]), int(hv[r, c]),
                                bd)
                        kind = 16 if k & 1 else 8 if k & 2 else \
                            4 if k & 4 else 0
                        if kind:
                            apply(plane, r * 8, c * 8, kind, *args)
                        if k & 8:
                            if vertical:
                                apply(plane, r * 8, c * 8 + 4, 4, *args)
                            else:
                                apply(plane, r * 8 + 4, c * 8, 4, *args)
    return plane


def _port(P, vb, hb, mb, lm, hv, bd, lf_on=1):
    t = [torch.from_numpy(a) for a in (P, vb, hb, mb, lm, hv)]
    return TW.lf_plane_tiles(*t, lf_on, gx=GX, gy=GY, bd=bd).numpy()


@pytest.mark.parametrize("bd", [8, 10])
def test_lf_plane_tiles_matches_oracle_order(bd):
    rng = np.random.default_rng(4220 + bd)
    ins = _plane_inputs(rng, 128, 96, bd)       # 2 x 3 tiles
    got = _port(*ins, bd)
    assert (got != ins[0]).any()
    assert np.array_equal(got, _oracle(*ins, bd))


def test_lf_plane_tiles_off_is_identity():
    rng = np.random.default_rng(7)
    ins = _plane_inputs(rng, 64, 64, 8)
    assert np.array_equal(_port(*ins, 8, lf_on=0), ins[0])


@pytest.mark.slow
@pytest.mark.parametrize("bd", [8, 10])
def test_lf_plane_tiles_matches_jax(bd):
    """Slow: the JAX tile loop compiles for about 20 s on XLA:CPU."""
    import jax.numpy as jnp
    from cuda_vp9_tpu.ops.device import lf_wave as JW
    rng = np.random.default_rng(4230 + bd)
    ins = _plane_inputs(rng, 128, 64, bd)       # 2 x 2 tiles
    want = np.asarray(JW.lf_plane_tiles(
        *(jnp.asarray(a) for a in ins), jnp.int32(1), gx=GX, gy=GY, bd=bd))
    got = _port(*ins, bd)
    assert (got != ins[0]).any()
    assert np.array_equal(got, want)
