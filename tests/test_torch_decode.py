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
frame with the loop filter on, or its first inter frame.  The 4:4:0
streams (large/p1_05 8-bit, large/p3_02 10-bit) and the scaled-reference
4:4:4 and 4:2:2 streams (large/sc02, large/sc03) are decoded whole, and
the packer's scaled sub-8x8 branch is held against the JAX package's host
oracle at 4:4:4 and 4:2:2 (frame 1 of p1_01 and p1_02, with references
made 8 columns wider).  TorchRecon's modes: validate_against_oracle
passes on the first frames of kf02 and in01 and names the plane, rows and
columns of a one-pixel difference; defer_output fetches nothing, reads a
frame whose ring row still holds it and refuses one whose row was reused,
and sync() returns the ring's checksum.  A subprocess decodes
kf02 and p2_01 through `python -m cuda_vp9_torch.tools.vpxdec` with `jax`
and `cuda_vp9_tpu` blocked, as on a machine without them.  The 1080p
10-bit stream hb01 (frame 0) and the 640x360 4:4:0 stream p1_06 are
decoded in the slow tier."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_vp9_torch import convert
from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.decoder.constants import BLOCK_8X8
from cuda_vp9_torch.decoder.frame import (NativeVp9Decoder,
                                          native_decode_stream_md5)
from cuda_vp9_torch.ops.ref import recon as ref_recon
from cuda_vp9_torch.runtime.pipeline import TorchRecon
from cuda_vp9_torch.utils.md5 import frame_md5

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


# (stream in tests/fixtures/large, what each one needs of the port, the
# frames that need it): the 4:4:0 streams filter every frame's chroma
# through the 4:4:0 twin of the tile filter, and the scaled 4:4:4 and 4:2:2
# streams run the scaled MC class (mcs) on their three inter frames of
# another size than the keyframe (the 176x144 one is unscaled)
LARGE = [("large/p1_05_176x144_440", "lf440", 10),
         ("large/p3_02_176x144_440_10b", "lf440", 6),
         ("large/sc02_176x144_444_scaled", "mcs", 3),
         ("large/sc03_176x144_422_scaled", "mcs", 3)]


@pytest.mark.parametrize("name,needs,n", LARGE, ids=[s[0][6:] for s in LARGE])
def test_torch_recon_md5_whole(name, needs, n, monkeypatch):
    """Every frame on the device (here the twins), MD5-exact, and through
    the module the stream exists for: the 4:4:0 tile filter on each frame
    (each has a level), or the scaled class on each scaled frame."""
    from cuda_vp9_torch.ops.cuda import lf422 as L4
    from cuda_vp9_torch.ops.cuda import mc as MC
    calls = {"mcs": 0, "lf440": 0}
    mcs_pass, tiles_plain = MC.mcs_pass, L4.lf_chroma_tiles_plain

    def count_mcs(*a, **k):
        calls["mcs"] += 1
        return mcs_pass(*a, **k)

    def count_tiles(*a, ss, **k):
        calls["lf440"] += tuple(ss) == (0, 1)
        return tiles_plain(*a, ss=ss, **k)

    monkeypatch.setattr(MC, "mcs_pass", count_mcs)
    monkeypatch.setattr(L4, "lf_chroma_tiles_plain", count_tiles)
    golden = _golden(name)
    rec = TorchRecon("cpu")
    got = [d for _, d in native_decode_stream_md5(
        str(FIXTURES / f"{name}.ivf"), recon_fn=rec, lag=0)]
    assert got == golden
    assert rec.frames_on_host == 0 and rec.frames_on_device == len(golden)
    assert calls[needs] == n


@pytest.mark.slow
def test_p1_06_440_matches_golden():
    """Slow: the 640x360 4:4:0 stream whole through the plain torch step on
    the CPU (about 20 s)."""
    rec = TorchRecon("cpu")
    got = [d for _, d in native_decode_stream_md5(
        str(FIXTURES / "large" / "p1_06_640x360_440.ivf"), recon_fn=rec,
        lag=0)]
    assert got == _golden("large/p1_06_640x360_440")
    assert rec.frames_on_host == 0


def test_scaled_tier_at_444_escalates_not_truncates(monkeypatch):
    """The scaled tier's mcs capacity at 4:4:4 holds every 4x4 cell of
    all three full-size planes predicted twice (compound); a frame that
    overflows a smaller capacity goes to the host oracle whole (its MD5
    still exact), never into a truncated flat."""
    from cuda_vp9_torch.runtime import pack
    for mi_rows, mi_cols in ((18, 22), (25, 30)):
        caps = pack.compute_caps(mi_rows, mi_cols, "scaled", ss=(0, 0))
        cells = (2 * mi_rows) * (2 * mi_cols)
        assert caps["mcs"] * pack.CHUNK_MCS >= 2 * 3 * cells
        assert caps["mcs"] > pack.compute_caps(mi_rows, mi_cols, "scaled",
                                               ss=(1, 1))["mcs"]
    compute_caps = pack.compute_caps

    def small(*a, **k):
        caps = compute_caps(*a, **k)
        if caps["tier"] == "scaled":
            caps["mcs"] = 2
        return caps

    monkeypatch.setattr(pack, "compute_caps", small)
    name = "large/sc02_176x144_444_scaled"
    rec = TorchRecon("cpu")
    got = [d for _, d in native_decode_stream_md5(
        str(FIXTURES / f"{name}.ivf"), recon_fn=rec, lag=0)]
    assert got == _golden(name)
    assert (rec.frames_on_host, rec.frames_on_device) == (3, 2)
    assert rec.frames_out_of_scale == 0 and pack.last_overflow[0] == "mcs"


def _wider(rb, cls):
    """A copy of RefBuffer rb 8 luma columns wider: the 8 (chroma: 8 >>
    ss_x) columns past its crop mirror the last ones."""
    planes = []
    for p, pl in enumerate(rb.planes):
        sx = rb.ss_x if p else 0
        cw, e = (rb.width + sx) >> sx, 8 >> sx
        a = np.array(pl, copy=True)
        a[:, cw:cw + e] = a[:, cw - e:cw][:, ::-1]
        planes.append(a)
    return cls(planes, rb.width + 8, rb.height, rb.bit_depth, rb.ss_x,
               rb.ss_y)


def _frame_with_wider_refs(name, k, decoder, recon, last):
    """Decode `name` with `decoder(recon_fn=...)`, frames before k through
    the host oracle module `recon`; frame k through `last(plan, refs)`
    with every reference 8 columns wider (_wider).  Returns (frame k's
    header, its planes, its sub-8x8 inter blocks)."""
    from cuda_vp9_torch.containers import IvfReader
    out = {}

    class Done(Exception):
        pass

    def recon_fn(plan, refs):
        if len(out) < k:
            out[len(out)] = None
            return recon.reconstruct_frame(plan, refs)
        b = np.array([[x.mi_row, x.mi_col, x.bsize] for x in plan.blocks])
        out["sub8x8"] = int(((b[:, 2] < BLOCK_8X8) & (
            plan.mi.ref[b[:, 0], b[:, 1], 0] > 0)).sum())
        out["hdr"] = plan.hdr
        out["planes"] = last(plan, {f: None if rb is None else
                                    _wider(rb, recon.RefBuffer)
                                    for f, rb in refs.items()})
        raise Done

    dec = decoder(recon_fn=recon_fn)
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        try:
            for data, _ in r:
                dec.decode(data)
        except Done:
            pass
    return out["hdr"], out["planes"], out["sub8x8"]


@pytest.mark.parametrize("name", ["p1_01_176x144_444", "p1_02_176x144_422"])
def test_scaled_sub8x8_matches_jax_oracle(name):
    """The packer's scaled sub-8x8 branch at 4:4:4 and 4:2:2, which no
    fixture reaches (the scaled fixtures' writer codes 64x64 blocks):
    frame 1 of p1_01 (4:4:4) or p1_02 (4:2:2) holds sub-8x8 inter blocks;
    with references 8 columns wider than the frame every inter block is
    scaled.  The port's TorchRecon (its own parser) and the JAX package's
    host oracle `reconstruct_frame` (its parser) give equal planes."""
    from cuda_vp9_torch.ops.ref import recon as port_ref
    from cuda_vp9_tpu.decoder.frame import NativeVp9Decoder as JaxDecoder
    from cuda_vp9_tpu.ops.ref import recon as jax_ref
    rec = TorchRecon("cpu")
    hdr, got, sub = _frame_with_wider_refs(name, 1, NativeVp9Decoder,
                                           port_ref, rec)
    _, want, jsub = _frame_with_wider_refs(
        name, 1, JaxDecoder, jax_ref,
        lambda plan, refs: jax_ref.reconstruct_frame(plan, refs))
    assert sub == jsub > 0
    assert rec.frames_on_device == 1 and rec.frames_on_host == 0
    assert [k[2] for k in rec._steps] == ["scaled"]
    for p in range(3):
        sx = hdr.subsampling_x if p else 0
        sy = hdr.subsampling_y if p else 0
        h, w = (hdr.height + sy) >> sy, (hdr.width + sx) >> sx
        assert np.array_equal(np.asarray(got[p])[:h, :w],
                              np.asarray(want[p])[:h, :w]), f"plane {p}"


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


def _frames(recon, name, n):
    """The first n packets of a fixture through NativeVp9Decoder(recon):
    its DecodedFrames, nothing read yet."""
    dec = NativeVp9Decoder(recon_fn=recon)
    frames = []
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        for data, _ in list(r)[:n]:
            dec.decode(data)
            frames.extend(dec.frames())
    return frames


@pytest.mark.parametrize("name,n", [("kf02_176x144", 2),
                                    ("in01_176x144", 3)])
def test_validate_against_oracle_passes_on_real_streams(name, n):
    rec = TorchRecon("cpu", validate_against_oracle=True)
    frames = _frames(rec, name, n)
    assert [frame_md5(f.visible_planes()) for f in frames] == \
        _golden(name)[:n]
    assert rec.frames_on_device == n and rec.frames_on_host == 0


def test_validate_against_oracle_names_the_first_difference(monkeypatch):
    """The oracle moved by one pixel (plane 1, row 5, column 7): the device
    frame no longer equals it, and the message names where."""
    oracle = ref_recon.reconstruct_frame

    def moved(plan, refs):
        planes = oracle(plan, refs)
        planes[1][5, 7] += 1
        return planes

    monkeypatch.setattr(ref_recon, "reconstruct_frame", moved)
    with pytest.raises(AssertionError, match=r"fused recon mismatch plane 1: "
                                             r"1 px, first rows \[5\] "
                                             r"cols \[7\]"):
        _frames(TorchRecon("cpu", validate_against_oracle=True),
                "kf01_64x64", 1)


def test_defer_output_reads_live_rows_and_refuses_reused_ones(monkeypatch):
    """A ring of 4 rows over in01's first 6 frames: frames 4 and 5 reuse
    rows 0 and 1.  Nothing is fetched at the wrap; frames 3 and 5 read
    back from the live ring, MD5-exact; frame 0 raises."""
    monkeypatch.setattr(TorchRecon, "RING", 4)
    rec = TorchRecon("cpu", defer_output=True)
    frames = _frames(rec, "in01_176x144", 6)
    assert len(frames) == 6
    assert all(f.planes._planes is None for f in frames)
    golden = _golden("in01_176x144")
    for k in (5, 3):
        assert frame_md5(frames[k].visible_planes()) == golden[k]
    for k in (0, 1):
        with pytest.raises(RuntimeError, match="defer_output"):
            frames[k].visible_planes()
    check = rec.sync()
    assert isinstance(check, int) and check > 0
    assert rec.frames_on_host == 0 and rec.frames_on_device == 6


def test_sync_before_any_frame_is_zero():
    assert TorchRecon("cpu", defer_output=True).sync() == 0


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
