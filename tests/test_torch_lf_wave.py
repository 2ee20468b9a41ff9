"""The port's 4:2:2 and 4:4:0 chroma loop filter
(cuda_vp9_torch/ops/device/lf_wave.py).

`lf_plane_tiles` filters one chroma plane in the order of the luma
superblocks: tiles of 32 x 64 pixels at 4:2:2 (gx = 4, gy = 8 cells) or
64 x 32 at 4:4:0 (gx = 8, gy = 4), in raster order, each tile's vertical
edges, then its horizontal ones.  The same seeded plane and per-cell maps
go through:

  * the NumPy oracle's window filters (`cuda_vp9_tpu/ops/ref/loopfilter`
    `_apply_vertical` / `_apply_horizontal`) applied in that order;
  * the JAX package's `lf_plane_tiles` (marked slow: its tile loop
    compiles for about 20 s a bit depth on XLA:CPU; at 4:4:0 in a fresh
    process with a clean cache, as fault F1 asks);
  * at 4:4:0 on real data, the whole twin route (`lf_chroma_tiles_plain`,
    both planes stacked) on the chroma of p1_05's keyframe before its loop
    filter, with the maps the port's packer writes, against the NumPy
    oracle's `filter_frame` with ss = (0, 1).

Pixels are 8x8 blocks of random level and noise amplitude, so every
filter width engages; the edge masks are those of test_pallas_lf (no
edge on the plane's top and left borders).  Tolerance 0: integer math."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.device import lf_wave as TW
from cuda_vp9_tpu.ops.ref import loopfilter as ref_lf

from conftest import FIXTURES

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

GX, GY = 4, 8           # 4:2:2 chroma: a luma SB is 4 x 8 chroma cells
GX440, GY440 = 8, 4     # 4:4:0 chroma: 8 x 4 cells


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


def _oracle(P, vb, hb, mb, lm, hv, bd, gx=GX, gy=GY):
    """The oracle window filters in luma-SB tile raster order (tiles of gy
    x gx cells)."""
    plane = P.astype(np.int64)
    R, C = vb.shape
    for tr in range(R // gy):
        for tc in range(C // gx):
            rows = range(tr * gy, tr * gy + gy)
            cols = range(tc * gx, tc * gx + gx)
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


def _port(P, vb, hb, mb, lm, hv, bd, lf_on=1, gx=GX, gy=GY):
    t = [torch.from_numpy(a) for a in (P, vb, hb, mb, lm, hv)]
    return TW.lf_plane_tiles(*t, lf_on, gx=gx, gy=gy, bd=bd).numpy()


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_lf_plane_tiles_matches_oracle_order(bd):
    rng = np.random.default_rng(4220 + bd)
    ins = _plane_inputs(rng, 128, 96, bd)       # 2 x 3 tiles
    got = _port(*ins, bd)
    assert (got != ins[0]).any()
    assert np.array_equal(got, _oracle(*ins, bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_lf_plane_tiles_440_matches_oracle_order(bd):
    rng = np.random.default_rng(4400 + bd)
    ins = _plane_inputs(rng, 64, 192, bd)       # 2 x 3 tiles of 32 x 64
    got = _port(*ins, bd, gx=GX440, gy=GY440)
    assert (got != ins[0]).any()
    assert np.array_equal(got, _oracle(*ins, bd, gx=GX440, gy=GY440))


@pytest.mark.parametrize("gx,gy", [(GX, GY), (GX440, GY440)],
                         ids=["422", "440"])
def test_stacked_planes_match_one_by_one(gx, gy):
    """Two planes that share the maps, filtered as one [2, Hp, Wp] call,
    equal each plane filtered alone."""
    rng = np.random.default_rng(90 + gx)
    P, *maps = _plane_inputs(rng, 128, 128, 10)
    Q = _plane_inputs(rng, 128, 128, 10)[0]
    t = [torch.from_numpy(m) for m in maps]
    both = TW.lf_plane_tiles(torch.from_numpy(np.stack([P, Q])), *t, 1,
                             gx=gx, gy=gy, bd=10).numpy()
    for k, plane in enumerate((P, Q)):
        assert np.array_equal(both[k], _port(plane, *maps, 10, gx=gx, gy=gy))


def test_twin_matches_filter_frame_440(monkeypatch):
    """The 4:4:0 route on real data: p1_05's keyframe (8-bit 4:4:0, level
    4), its chroma before the loop filter and after it as the JAX
    package's NumPy oracle gives them (`filter_frame` with ss = (0, 1),
    spied on in `reconstruct_frame`), and the five maps the port's packer
    writes for the frame (its own parser)."""
    from cuda_vp9_torch.containers import IvfReader
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.ops.cuda.lf422 import lf_chroma_tiles_plain
    from cuda_vp9_torch.runtime import fused, pack
    from cuda_vp9_tpu.decoder.frame import NativeVp9Decoder as JaxDecoder

    with IvfReader(str(FIXTURES / "large" / "p1_05_176x144_440.ivf")) as r:
        key = next(iter(r))[0]
    seen = {}
    filter_frame = ref_lf.filter_frame

    def spy(planes, mi, seg_map, hdr, *a):
        assert (hdr.subsampling_x, hdr.subsampling_y) == (0, 1)
        seen["pre"] = [np.array(p, np.int32) for p in planes]
        filter_frame(planes, mi, seg_map, hdr, *a)
        seen["post"] = [np.array(p, np.int32) for p in planes]

    monkeypatch.setattr(ref_lf, "filter_frame", spy)
    JaxDecoder().decode(key)
    maps = {}

    def port_pack(plan, refs):
        h = plan.hdr
        _, caps, layout = fused.get_frame_step(h.mi_rows, h.mi_cols, "full",
                                               ss=(0, 1))
        flat = pack.pack_frame(plan, refs, caps, layout)
        for nm in ("lfw_v", "lfw_h", "lfw_mb", "lfw_lm", "lfw_hv"):
            maps[nm] = torch.from_numpy(layout.view(flat, nm).copy())
        return [np.zeros((8, 8), np.uint16)] * 3

    NativeVp9Decoder(recon_fn=port_pack).decode(key)
    hc, wc = seen["pre"][1].shape
    F = torch.zeros((3, 2 * hc, wc), dtype=torch.int32)
    for p in (1, 2):
        F[p, :hc] = torch.from_numpy(seen["pre"][p])
    lf_chroma_tiles_plain(F, *maps.values(), 1, bd=8, ss=(0, 1))
    for p in (1, 2):
        assert (seen["post"][p] != seen["pre"][p]).any()
        assert np.array_equal(F[p, :hc].numpy(), seen["post"][p]), p
    assert not F[0].any() and not F[1:, hc:].any()


def compare_jax_440():
    """The 4:4:0 twin against JAX's lf_plane_tiles at gx = 8, gy = 4, at bit
    depths 8, 10 and 12 (run in a fresh process: see the slow test)."""
    import jax.numpy as jnp
    from cuda_vp9_tpu.ops.device import lf_wave as JW
    for bd in (8, 10, 12):
        rng = np.random.default_rng(4410 + bd)
        ins = _plane_inputs(rng, 64, 128, bd)   # 2 x 2 tiles of 32 x 64
        want = np.asarray(JW.lf_plane_tiles(
            *(jnp.asarray(a) for a in ins), jnp.int32(1), gx=GX440,
            gy=GY440, bd=bd))
        got = _port(*ins, bd, gx=GX440, gy=GY440)
        assert (got != ins[0]).any(), bd
        assert np.array_equal(got, want), bd
        print(f"bd {bd}: equal")


@pytest.mark.slow
def test_lf_plane_tiles_440_matches_jax():
    """Slow: the JAX tile loop compiles for about 20 s a bit depth on
    XLA:CPU.  The JAX calls run in a fresh process (fault F1), as
    test_torch_step's _compare_in_subprocess does."""
    tests = Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-c", "import test_torch_lf_wave as t; "
         "t.compare_jax_440()"],
        cwd=tests, capture_output=True, text=True, timeout=1800,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(
                 [str(tests.parent), os.environ.get("PYTHONPATH", "")])})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("equal") == 3


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
