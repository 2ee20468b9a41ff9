"""The port's frame step against the JAX frame step on the same input.

One packed flat (the port's native packer on the parser's live state
for 4:2:0, its `runtime/pack.pack_frame` otherwise, as the pipelines
choose) and one starting pool and ring go through JAX
`runtime/fused.get_frame_step` and through
`cuda_vp9_torch.runtime.fused.get_frame_step`; the pool and the output
ring after the step must be equal byte for byte.

  * kf01_64x64 frame 0 (full tier, keyframe from an empty pool).  A cold
    XLA:CPU compile of this step takes about 90 s; the persistent cache
    (utils/jaxcache) keeps later runs short.
  * frame 0 of p2_01 (10-bit 4:2:0), of p3_01 (10-bit 4:4:4) and of ll01
    (lossless: the WHT on bucket tx0, the only bucket of its layout), each
    in a fresh subprocess (the JAX step has crashed in-process at 10 bits:
    ROADMAP fault F1) and marked slow: each compiles a JAX step cold.
  * in01_176x144 frame 1 (tight tier, inter), starting from the state
    that JAX TpuReconFused left after frame 0, carried over by
    cuda_vp9_torch/convert.state_from_tpu.  Marked slow: it compiles the
    keyframe and the inter steps of the JAX backend (minutes on XLA:CPU).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_vp9_torch import convert
from cuda_vp9_torch.decoder.frame import NativeVp9Decoder as TorchDecoder
from cuda_vp9_torch.runtime import fused as TF
from cuda_vp9_torch.runtime import pack as TP
from cuda_vp9_tpu import models as M
from cuda_vp9_tpu.containers import IvfReader
from cuda_vp9_tpu.decoder.frame import NativeVp9Decoder
from cuda_vp9_tpu.ops.ref import recon as ref_recon
from cuda_vp9_tpu.runtime import fused as JF
from cuda_vp9_tpu.utils.jaxcache import enable_persistent_cache

from conftest import FIXTURES

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

KERNELS = np.asarray(M.FILTER_KERNELS, np.int32)


def _decode(name, recon_fn, n, decoder=NativeVp9Decoder):
    """Feed the first n packets of a fixture to a native decoder."""
    dec = decoder(recon_fn=recon_fn)
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        for i, (data, _) in enumerate(r):
            if i == n:
                break
            dec.decode(data)


def _torch_step(plan, refs, tier, pool, ring, ring_slot):
    """Pack with the port's layout and run the port's step in place;
    returns the layout and caps for comparison with the JAX ones."""
    h = plan.hdr
    step, caps, layout = TF.get_frame_step(h.mi_rows, h.mi_cols, tier)
    flat = plan.native_parser.pack(plan, refs, caps, layout,
                                   ring_slot=ring_slot)
    step(pool, ring, torch.from_numpy(KERNELS), flat)
    return caps, layout, flat


def compare_keyframe_step(name):
    """Frame 0 of `name` through both steps from an empty pool and ring;
    asserts that the pools and the rings are byte-equal."""
    out = {}

    def recon_fn(plan, refs):
        h = plan.hdr
        bd, ss = h.bit_depth, (h.subsampling_x, h.subsampling_y)
        lossless = bool(h.lossless)
        jstep, caps, layout = JF.get_frame_step(h.mi_rows, h.mi_cols, "full",
                                                lossless, bd=bd, ss=ss)
        step, tcaps, tlayout = TF.get_frame_step(h.mi_rows, h.mi_cols,
                                                 "full", lossless, bd, ss)
        assert tcaps == caps and tlayout.segs == layout.segs
        if ss == (1, 1):
            flat = plan.native_parser.pack(plan, refs, tcaps, tlayout)
        else:
            flat = TP.pack_frame(plan, refs, tcaps, tlayout)
        ha, wa = ((h.mi_rows + 7) & ~7) * 8, ((h.mi_cols + 7) & ~7) * 8
        nout = ha * wa + 2 * (ha >> ss[1]) * (wa >> ss[0])
        pool = torch.zeros((8, 3, ha, wa), dtype=torch.int32)
        ring = torch.zeros((32, nout), dtype=TF.ring_dtype(bd))
        step(pool, ring, torch.from_numpy(KERNELS), flat)
        jpool, jring = jstep(jnp.zeros((8, 3, ha, wa), jnp.int32),
                             jnp.zeros((32, nout), np.asarray(ring).dtype),
                             jnp.asarray(KERNELS), jnp.asarray(flat))
        out.update(pool=pool.numpy(), ring=ring.numpy(),
                   jpool=np.asarray(jpool), jring=np.asarray(jring))
        return ref_recon.reconstruct_frame(plan, refs)

    _decode(name, recon_fn, 1, TorchDecoder)
    assert out["ring"][0].any()
    assert out["ring"].dtype == out["jring"].dtype
    assert np.array_equal(out["pool"], out["jpool"])
    assert np.array_equal(out["ring"], out["jring"])


def test_keyframe_step_matches_jax():
    enable_persistent_cache()
    compare_keyframe_step("kf01_64x64")


def _compare_in_subprocess(name):
    tests = Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-c", "import test_torch_step as t; "
         f"t.compare_keyframe_step({name!r})"],
        cwd=tests, capture_output=True, text=True, timeout=1800,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(
                 [str(tests.parent), os.environ.get("PYTHONPATH", "")])})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["p2_01_176x144_10b",
                                  "p3_01_176x144_444_10b"])
def test_keyframe_step_matches_jax_high_bitdepth(name):
    """Slow: a fresh process compiles the JAX step cold (fault F1 keeps
    10-bit JAX steps out of the test process)."""
    _compare_in_subprocess(name)


@pytest.mark.slow
def test_lossless_keyframe_step_matches_jax():
    """Slow: frame 0 of ll01 through the lossless steps, in a fresh
    process as above."""
    _compare_in_subprocess("ll01_176x144_lossless")


@pytest.mark.slow
def test_inter_step_matches_jax():
    """Slow: compiles two JAX steps (keyframe and tight-tier inter) on
    XLA:CPU, minutes cold."""
    from cuda_vp9_tpu.runtime.pipeline import TpuReconFused
    jrec = TpuReconFused()
    out = {}

    def recon_fn(plan, refs):
        if plan.hdr.frame_is_intra_only:
            return jrec(plan, refs)
        pool, ring = convert.state_from_tpu(jrec, "cpu")
        _torch_step(plan, refs, "tight", pool, ring, jrec._ring_slot)
        planes = jrec(plan, refs)
        jpool, jring = convert.state_from_tpu(jrec, "cpu")
        out.update(pool=pool, ring=ring, jpool=jpool, jring=jring)
        return planes

    _decode("in01_176x144", recon_fn, 2)
    assert jrec.frames_on_device == 2
    assert torch.equal(out["pool"], out["jpool"])
    assert torch.equal(out["ring"], out["jring"])
