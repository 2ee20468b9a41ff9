"""Whole streams through the port on the CPU: TorchRecon("cpu") behind the
native parser and packer, every frame's MD5 against the golden files.

The streams cover what the slice runs: keyframes (kf02, mn02), inter
frames (in01), compound prediction with scaled references (cp01),
inter frames made of intra blocks (dn01), and inter frames that overflow
the tight tier and escalate to the wide one (io01).  Frames outside the
slice raise NotImplementedError naming their ROADMAP item.  A subprocess
decodes kf02 through `python -m cuda_vp9_torch.tools.vpxdec` with `jax`
blocked, as on a machine without JAX."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuda_vp9_torch import convert
from cuda_vp9_torch.runtime.pipeline import TorchRecon
from cuda_vp9_tpu.decoder.frame import (NativeVp9Decoder,
                                        native_decode_stream_md5)

from conftest import FIXTURES

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# (stream, frames checked)
STREAMS = [("kf02_176x144", 5), ("mn02_32x24", 6), ("in01_176x144", 4),
           ("cp01_352x288_compound", 8), ("dn01_176x144_dense", 4),
           ("io01_176x144_intraonly", 6)]


def _golden(name):
    return [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]


@pytest.mark.parametrize("name,n", STREAMS, ids=[s[0] for s in STREAMS])
def test_torch_recon_md5(name, n):
    golden = _golden(name)
    rec = TorchRecon("cpu")
    got = [d for _, d in native_decode_stream_md5(
        str(FIXTURES / f"{name}.ivf"), max_frames=n, recon_fn=rec, lag=0)]
    assert got == golden[:n]
    assert rec.frames_on_host == 0 and rec.frames_on_device >= n - 1
    if name.startswith("io01"):
        assert rec.frames_wide > 0, "no frame escalated to the wide tier"


@pytest.mark.parametrize("name,item", [
    ("ll01_176x144_lossless", "item 7"), ("p2_01_176x144_10b", "item 6"),
    ("p1_01_176x144_444", "item 9")])
def test_frames_outside_the_slice_raise(name, item):
    with pytest.raises(NotImplementedError, match=item):
        for _ in native_decode_stream_md5(str(FIXTURES / f"{name}.ivf"),
                                          max_frames=1,
                                          recon_fn=TorchRecon("cpu")):
            pass


def test_pool_from_refs_matches_device_pool():
    """After a stream decoded wholly on the device, the pool rebuilt
    from the decoder's reference slots equals the device pool."""
    rec = TorchRecon("cpu")
    dec = NativeVp9Decoder(recon_fn=rec)
    from cuda_vp9_tpu.containers import IvfReader
    with IvfReader(str(FIXTURES / "kf02_176x144.ivf")) as r:
        for data, _ in r:
            dec.decode(data)
    assert rec.frames_on_host == 0
    pool = convert.pool_from_refs(dec.ref_slots, rec._geom, "cpu")
    assert torch.equal(pool, rec._pool)


def test_cli_decodes_without_jax():
    ivf = FIXTURES / "kf02_176x144.ivf"
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.argv = ['vpxdec', {str(ivf)!r}, '--md5', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('cuda_vp9_torch.tools.vpxdec',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "jax = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib'))\n"
        "print('jax modules:', jax, file=sys.stderr)\n"
        "assert not jax\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "OMP_NUM_THREADS": "1"},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout == (FIXTURES / "kf02_176x144.md5").read_text()
