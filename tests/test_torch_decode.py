"""Whole streams through the port on the CPU: TorchRecon("cpu") behind the
port's own native parser and packer, every frame's MD5 against the golden
files.

The streams cover what the port runs: keyframes (kf02, mn02), inter
frames (in01), the smallest geometries (mn01 16x16, mn03 18x10),
extended motion vectors far outside the frame (mv01, mv02 at an odd
98x66), compound prediction with scaled references (cp01),
inter frames made of intra blocks (dn01), inter frames that overflow
the tight tier and escalate to the wide one (io01), 10- and 12-bit
4:2:0 (p2_01, p2_02, p2_04), 4:4:4 at 8 and 10 bits (p1_01, p3_01),
4:2:2 (p1_02, p1_04) and lossless frames (ll01 intra, ll02 inter: the
WHT).  Each high-bit-depth or non-4:2:0 stream is decoded up to its first
frame with the loop filter on, or its first inter frame.  Frames outside
the port (4:4:0, scaled references with chroma other than 4:2:0) raise
NotImplementedError naming their ROADMAP item.  A subprocess decodes
kf02 and p2_01 through `python -m cuda_vp9_torch.tools.vpxdec` with `jax`
and `cuda_vp9_tpu` blocked, as on a machine without them.  The 1080p
10-bit stream hb01 is decoded (frame 0) in the slow tier."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuda_vp9_torch import convert
from cuda_vp9_torch.decoder.frame import (NativeVp9Decoder,
                                          native_decode_stream_md5)
from cuda_vp9_torch.runtime.pipeline import TorchRecon

from conftest import FIXTURES

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them (the decode tests ran about 50x slower).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# (stream, frames checked)
STREAMS = [("kf02_176x144", 5), ("mn02_32x24", 6), ("in01_176x144", 4),
           ("cp01_352x288_compound", 8), ("dn01_176x144_dense", 4),
           ("io01_176x144_intraonly", 6),
           ("p2_01_176x144_10b", 2), ("p2_02_176x144_12b", 1),
           ("p2_04_176x144_12b_inter", 2), ("p3_01_176x144_444_10b", 5),
           ("p1_01_176x144_444", 5), ("p1_02_176x144_422", 2),
           ("p1_04_176x144_422_long", 2), ("ll01_176x144_lossless", 6),
           ("ll02_96x64_lossless_inter", 8), ("mn01_16x16", 6),
           ("mn03_odd_18x10", 6), ("mv01_176x144_extmv", 4),
           ("mv02_odd_98x66_extmv", 4)]


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
    if name.startswith("ll"):
        assert rec.frames_on_device == n
    if name.startswith("io01"):
        assert rec.frames_wide > 0, "no frame escalated to the wide tier"


def _as_440(hdr):
    hdr.subsampling_y = 1            # 4:4:4 -> 4:4:0


def _scaled_refs(hdr):
    if not hdr.frame_is_intra_only:
        hdr.width += 8               # every reference now has another size


@pytest.mark.parametrize("name,n,patch,item", [
    ("p1_01_176x144_444", 1, _as_440, "item 9"),
    ("p1_01_176x144_444", 2, _scaled_refs, "item 8")],
    ids=["440", "scaled_444"])
def test_frames_outside_the_slice_raise(name, n, patch, item):
    """4:4:0 chroma and scaled references with chroma other than 4:2:0
    raise, naming their ROADMAP item, and never go to the host.  No
    fixture is 4:4:0 or scales a 4:4:4 reference, so both cases change
    the header of p1_01 (8-bit 4:4:4) after the parse."""
    rec = TorchRecon("cpu")

    def recon_fn(plan, refs):
        if patch is not None:
            patch(plan.hdr)
        return rec(plan, refs)

    with pytest.raises(NotImplementedError, match=item):
        for _ in native_decode_stream_md5(str(FIXTURES / f"{name}.ivf"),
                                          max_frames=n, recon_fn=recon_fn,
                                          lag=0):
            pass
    assert rec.frames_on_host == 0 and rec.frames_on_device == n - 1


def test_pool_from_refs_matches_device_pool():
    """After a stream decoded wholly on the device, the pool rebuilt
    from the decoder's reference slots equals the device pool."""
    rec = TorchRecon("cpu")
    dec = NativeVp9Decoder(recon_fn=rec)
    from cuda_vp9_torch.containers import IvfReader
    with IvfReader(str(FIXTURES / "kf02_176x144.ivf")) as r:
        for data, _ in r:
            dec.decode(data)
    assert rec.frames_on_host == 0
    pool = convert.pool_from_refs(dec.ref_slots, rec._geom, "cpu")
    assert torch.equal(pool, rec._pool)


def test_pool_from_refs_matches_device_pool_10bit_444():
    """The same after frame 0 of p3_01 (10-bit 4:4:4): uint16 reference
    planes, full-size chroma planes, and an int16 output ring."""
    from cuda_vp9_torch.containers import IvfReader
    rec = TorchRecon("cpu")
    dec = NativeVp9Decoder(recon_fn=rec)
    with IvfReader(str(FIXTURES / "p3_01_176x144_444_10b.ivf")) as r:
        dec.decode(next(iter(r))[0])
    assert rec.frames_on_device == 1 and rec._ring.dtype == torch.int16
    assert dec.ref_slots[0].planes[1].shape == dec.ref_slots[0].planes[0].shape
    pool = convert.pool_from_refs(dec.ref_slots, rec._geom, "cpu")
    assert torch.equal(pool, rec._pool)
    assert pool.max() > 255


def test_cli_decodes_without_jax():
    """kf02 (8-bit) and p2_01 (10-bit: LE16 MD5s) through the CLI, in one
    process where `jax` and `cuda_vp9_tpu` cannot be imported."""
    names = ("kf02_176x144", "p2_01_176x144_10b")
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cuda_vp9_tpu'] = None\n"
        f"for ivf in {[str(FIXTURES / f'{n}.ivf') for n in names]!r}:\n"
        "    sys.argv = ['vpxdec', ivf, '--md5', '--device', 'cpu']\n"
        "    try:\n"
        "        runpy.run_module('cuda_vp9_torch.tools.vpxdec',"
        " run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', "
        "'cuda_vp9_tpu'))\n"
        "print('jax modules:', bad, file=sys.stderr)\n"
        "assert not bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "OMP_NUM_THREADS": "1"},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout == "".join((FIXTURES / f"{n}.md5").read_text()
                               for n in names)


@pytest.mark.slow
def test_hb01_frame0_matches_golden():
    """Slow: a 1080p 10-bit keyframe through the plain torch step on the
    CPU (about 10 s)."""
    rec = TorchRecon("cpu")
    got = [d for _, d in native_decode_stream_md5(
        str(FIXTURES / "large" / "hb01_1920x1080_10b.ivf"), max_frames=1,
        recon_fn=rec, lag=0)]
    assert got == _golden("large/hb01_1920x1080_10b")[:1]
    assert rec.frames_on_device == 1 and rec.frames_on_host == 0
