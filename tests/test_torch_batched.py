"""The port's multi-stream decoders (cuda_vp9_torch/runtime/multistream.py)
and the stream axis of the loop-filter kernel.

  * `lf_frames_plain` equals `lf_frame_plain` on each stream, with mixed
    `lf_on` (a stream with 0 stays untouched) and metadata strided between
    streams as the batched step passes it, at bit depths 8 and 10;
  * `BatchedTorchDecoder("cpu")` on in01 and sf01 (superframes; its
    resized frames leave the batch): after every round, each stream's
    slice of the batched pool equals the pool of a `TorchRecon("cpu")` fed
    the same packets (in every slot the batched pool holds: a slot that a
    frame outside the batch refreshed is resynced only when a batched
    frame reads it), every frame's output row equals that frame's
    single-stream row (by frame, not by ring slot: a superframe runs an
    extra round), and every MD5 equals the golden file.  The single-stream
    step is held against JAX in test_torch_step.py, which closes the
    chain;
  * a packet with two frames of one stream (a superframe) runs the round
    in flight before its second frame;
  * 10-bit streams batch (hi/lo coefficients, an int16 ring), and a
    12-bit stream beside them leaves the batch;
  * with defer_output the rounds run and the rings hold the same bytes,
    but no frame is fetched;
  * a round where a stream sits out leaves the earlier rounds' output
    rows as they were and writes nothing for that stream;
  * frames sent out of the batch and back: the per-stream TorchRecon and
    the batched pool each resync the slots the other route refreshed;
  * validate_against_oracle reaches the per-stream TorchRecon of a frame
    that leaves the batch, and leaves the batched rounds unchecked;
  * `MultiStreamDecoder` on kf01 and kf03 with `TorchRecon("cpu")`;
  * on the card (marked `cuda`; skips without a device): the stream-axis
    kernel against `lf_frames_plain` at N = 16 on the 640x384 canvas,
    bit depth 10, one launch.

Slow tier: the batched step against JAX `BatchedFusedDecoder` (2 streams
of in01, 2 rounds; pool and ring byte-equal through
`convert.batched_state_from_tpu`, in a fresh process: ROADMAP F1), and
in02 with sf01's resizing sibling sc01 through `BatchedTorchDecoder`.

This file imports no JAX at module level, so on the card's machine it
runs with `python -m pytest --noconftest -m cuda
tests/test_torch_batched.py`.  Tolerance 0: integer math."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
from cuda_vp9_torch.ops.cuda import loopfilter as LF
from cuda_vp9_torch.runtime import multistream as MS
from cuda_vp9_torch.runtime.pipeline import TorchRecon
from cuda_vp9_torch.utils.md5 import frame_md5

from test_torch_loopfilter import _inputs

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores.
torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).resolve().parent
FIXTURES = TESTS / "fixtures"


def _packets(name, n):
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r][:n]


def _golden(name):
    return [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]


def _stack_inputs(rng, n, mi_rows, mi_cols, bd):
    """N frames [N, 3, ha, wa], their lfm as a strided [N, n_sbs, 2, 128]
    view (each stream's row padded, as the stacked flats are) and thr
    [N, 64, 4]."""
    ins = [_inputs(rng, mi_rows, mi_cols, bd) for _ in range(n)]
    F = np.stack([i[0] for i in ins])
    lfm = np.stack([i[4] for i in ins])
    rows = np.zeros((n, lfm[0].size + 512), np.int16)
    rows[:, :lfm[0].size] = lfm.reshape(n, -1)
    lfm_t = torch.from_numpy(rows)[:, :lfm[0].size].view(n, *lfm.shape[1:])
    thr = np.stack([i[5] for i in ins])
    return F, lfm_t, torch.from_numpy(thr)


@pytest.mark.parametrize("bd", [8, 10])
def test_lf_frames_plain_matches_per_stream(bd):
    rng = np.random.default_rng(40 + bd)
    F, lfm, thr = _stack_inputs(rng, 3, 8, 8, bd)
    lf_on = (1, 0, 5)
    calls, launches = LF.plain_calls, LF.launches
    got = LF.lf_frames(torch.from_numpy(F.copy()), lfm, thr, lf_on,
                       mi_rows=8, mi_cols=8, bd=bd)
    assert LF.plain_calls == calls + 3 and LF.launches == launches
    for k, on in enumerate(lf_on):
        want = LF.lf_frame_plain(torch.from_numpy(F[k].copy()),
                                 lfm[k].contiguous(), thr[k], on,
                                 mi_rows=8, mi_cols=8, bd=bd)
        assert torch.equal(got[k], want)
        assert torch.equal(got[k], torch.from_numpy(F[k])) == (not on)


class _Recorder:
    """A recon_fn that records each frame's planes in decode order."""

    def __init__(self, inner):
        self.inner = inner
        self.frames = []

    def __call__(self, plan, refs):
        planes = self.inner(plan, refs)
        self.frames.append(planes)
        return planes


def _rows(planes):
    """A frame's output row, as it came back from the ring."""
    return np.concatenate([np.asarray(p).ravel() for p in planes])


def test_batched_matches_single_stream_per_round():
    names = ("in01_176x144", "sf01_176x144_super3")
    packets = [_packets(nm, 4) for nm in names]
    bd = MS.BatchedTorchDecoder(2, "cpu")
    for s in range(2):
        bd.decs[s]._recon_fn = _Recorder(bd.recons[s])
    singles = [TorchRecon("cpu") for _ in names]
    sdecs = [NativeVp9Decoder(recon_fn=_Recorder(r)) for r in singles]
    for i in range(4):
        bd.decode_round([p[i] for p in packets])
        for s in range(2):
            sdecs[s].decode(packets[s][i])
        bd.flush()
        ha, wa = bd._geom[:2]
        for s in range(2):
            clean = [j for j in range(8) if not bd._slot_dirty[s][j]]
            assert clean
            single = singles[s]._pool[:, :, :ha, :wa]
            assert torch.equal(bd._pool[s][clean], single[clean]), (i, s)
    outs = [[] for _ in names]
    for s, fr in bd.drain():
        outs[s].append(frame_md5(fr.visible_planes()))
    for s, nm in enumerate(names):
        got = bd.decs[s]._recon_fn.frames
        want = sdecs[s]._recon_fn.frames
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(_rows(a), _rows(b))
        assert outs[s] == _golden(nm)[:len(outs[s])]
    # sf01's resized frames left the batch, and its third frame of each
    # superframe joined the round
    assert bd.rounds == 4 and bd.recons[1].frames_unbatched == 6
    assert all(r.frames_on_host == 0 for r in bd.recons)


def _superframe(frames):
    """One packet holding `frames` behind a superframe index (4-byte
    sizes)."""
    marker = bytes([0xc0 | 3 << 3 | (len(frames) - 1)])
    index = marker + b"".join(len(f).to_bytes(4, "little") for f in frames)
    return b"".join(frames) + index + marker


def test_second_frame_of_a_packet_runs_the_round_first():
    """Stream 0 gets frames 1 and 2 of in01 in one packet: its second
    frame waits for the round in flight, which runs with stream 1's frame
    1, so the three packets take four rounds."""
    p = _packets("in01_176x144", 4)
    bd = MS.BatchedTorchDecoder(2, "cpu")
    bd.decode_round([p[0], p[0]])
    bd.decode_round([_superframe(p[1:3]), p[1]])
    assert bd.rounds == 3
    bd.decode_round([p[3], p[2]])
    got = [[], []]
    for s, fr in bd.drain():
        got[s].append(frame_md5(fr.visible_planes()))
    assert got == [_golden("in01_176x144")[:4], _golden("in01_176x144")[:3]]
    assert bd.rounds == 4


def test_stream_sitting_out_keeps_the_ring():
    packets = _packets("in01_176x144", 3)
    bd = MS.BatchedTorchDecoder(2, "cpu")
    bd.decode_round([packets[0], packets[0]])
    before = bd._ring[:, 0].clone()
    bd.decode_round([packets[1], None])
    assert torch.equal(bd._ring[:, 0], before)
    assert not bd._ring[1, 1].any() and bd._ring[0, 1].any()
    bd.decode_round([packets[2], packets[1]])
    assert torch.equal(bd._ring[:, 0], before)
    got = [[], []]
    for s, fr in bd.drain():
        got[s].append(frame_md5(fr.visible_planes()))
    assert got == [_golden("in01_176x144")[:3], _golden("in01_176x144")[:2]]
    assert bd.rounds == 3


def test_batched_high_bitdepth():
    """10-bit streams batch with their (lo, hi) coefficient words and an
    int16 ring; a 12-bit stream of the same geometry leaves the batch."""
    names = ("p2_01_176x144_10b", "p2_01_176x144_10b",
             "p2_04_176x144_12b_inter")
    packets = [_packets(nm, 3) for nm in names]
    bd = MS.BatchedTorchDecoder(3, "cpu")
    for i in range(3):
        bd.decode_round([p[i] for p in packets])
    got = [[], [], []]
    for s, fr in bd.drain():
        got[s].append(frame_md5(fr.visible_planes()))
    assert got == [_golden(nm)[:3] for nm in names]
    assert bd._ring.dtype == torch.int16
    assert [r["unbatched"] for r in bd.stats()] == [0, 0, 3]


def test_deferred_output_stays_on_the_device():
    """defer_output: sync() runs every round and returns the rings'
    checksum, which equals that of a decoder that fetches its frames;
    a deferred frame cannot be read."""
    packets = _packets("in01_176x144", 2)
    ref = MS.BatchedTorchDecoder(2, "cpu")
    dec = MS.BatchedTorchDecoder(2, "cpu", defer_output=True)
    for p in packets:
        ref.decode_round([p, p])
        dec.decode_round([p, p])
    assert [len(f.visible_planes()[0]) for _, f in ref.drain()] == [144] * 4
    assert dec.sync() == ref.sync() > 0
    frames = list(dec.drain())
    assert len(frames) == 4 and not dec._pending
    with pytest.raises(RuntimeError, match="defer_output"):
        frames[0][1].visible_planes()


def test_frames_leaving_the_batch_and_returning(monkeypatch):
    """Frames 1 and 3 of in01 leave the batch (as a frame the batch cannot
    take would), frames 0, 2 and 4 stay.  Frame 2 reads a slot that frame
    1 refreshed outside the batched pool, and frame 3 one that frame 2
    refreshed outside the per-stream TorchRecon's pool: both must be
    resynced."""
    packets = _packets("in01_176x144", 5)
    count = {"n": 0}
    can_batch = MS.BatchedTorchDecoder._can_batch

    def only_even(self, hdr, refs):
        count["n"] += 1
        return count["n"] % 2 == 1 and can_batch(self, hdr, refs)

    monkeypatch.setattr(MS.BatchedTorchDecoder, "_can_batch", only_even)
    bd = MS.BatchedTorchDecoder(1, "cpu")
    for p in packets:
        bd.decode_round([p])
    got = [frame_md5(fr.visible_planes()) for _, fr in bd.drain()]
    assert got == _golden("in01_176x144")[:5]
    rec = bd.recons[0]
    assert (rec.frames_unbatched, rec.frames_on_device, bd.rounds) == (2, 5, 3)


def test_validate_reaches_the_frames_that_leave_the_batch(monkeypatch):
    """validate_against_oracle goes to the stream's own TorchRecon: with
    the oracle moved by one pixel, in01's frame 1, sent out of the batch,
    raises; frame 0, batched, is not checked (as in JAX, whose batched
    decoder never reads the flag)."""
    from cuda_vp9_torch.ops.ref import recon as ref_recon
    oracle = ref_recon.reconstruct_frame

    def moved(plan, refs):
        planes = oracle(plan, refs)
        planes[0][3, 4] += 1
        return planes

    can_batch = MS.BatchedTorchDecoder._can_batch
    monkeypatch.setattr(ref_recon, "reconstruct_frame", moved)
    monkeypatch.setattr(
        MS.BatchedTorchDecoder, "_can_batch",
        lambda self, hdr, refs: hdr.frame_is_intra_only
        and can_batch(self, hdr, refs))
    packets = _packets("in01_176x144", 2)
    bd = MS.BatchedTorchDecoder(1, "cpu", validate_against_oracle=True)
    bd.decode_round([packets[0]])
    with pytest.raises(AssertionError, match=r"plane 0: 1 px, first rows "
                                             r"\[3\] cols \[4\]"):
        bd.decode_round([packets[1]])
    assert bd.rounds == 1 and bd._solo[0].validate


def test_multistream_decoder_round_robin():
    names = ("kf01_64x64", "kf03_odd_98x66")
    packets = [_packets(nm, 100) for nm in names]
    msd = MS.MultiStreamDecoder(2, lag=2,
                                recon_factory=lambda: TorchRecon("cpu"))
    got = [[], []]
    for i in range(max(map(len, packets))):
        for s in range(2):
            if i < len(packets[s]):
                msd.put(s, packets[s][i])
        for s, f in msd.ready():
            got[s].append(frame_md5(f.visible_planes()))
    for s, f in msd.flush():
        got[s].append(frame_md5(f.visible_planes()))
    for s, nm in enumerate(names):
        assert got[s] == _golden(nm)
    assert [st["device"] + st["host"] for st in msd.stats()] == \
        [len(p) for p in packets]
    assert all(st["host"] == 0 for st in msd.stats())


@pytest.mark.cuda
def test_lf_frames_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1616)
    F, lfm, thr = _stack_inputs(rng, 16, 45, 80, 10)
    lf_on = [int(v) for v in rng.integers(0, 2, 16)]
    lf_on[3] = 0
    lf_on[5] = 1
    lfm, thr = lfm.to(dev), thr.to(dev)
    kw = dict(mi_rows=45, mi_cols=80, bd=10)
    Fk = torch.from_numpy(F).to(dev)
    Fp = Fk.clone()
    launches = LF.launches
    LF.lf_frames(Fk, lfm, thr, lf_on, **kw)
    LF.lf_frames_plain(Fp, lfm, thr, lf_on, **kw)
    assert LF.launches == launches + 1
    assert torch.equal(Fk, Fp)
    for k, on in enumerate(lf_on):
        assert torch.equal(Fk[k].cpu(), torch.from_numpy(F[k])) == (not on)


@pytest.mark.slow
def test_batched_step_matches_jax_subprocess():
    """Slow: a fresh process compiles JAX's batched step cold."""
    r = subprocess.run(
        [sys.executable, "-c", "import test_torch_batched as t; "
         "t.compare_batched_step_with_jax()"],
        cwd=TESTS, capture_output=True, text=True, timeout=3000,
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.pathsep.join(
                 [str(TESTS.parent), os.environ.get("PYTHONPATH", "")])})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


def compare_batched_step_with_jax():
    """Two streams of in01 for two rounds through JAX BatchedFusedDecoder
    and BatchedTorchDecoder("cpu"): after each round the pools and the
    rings are byte-equal, JAX's state carried over by
    convert.batched_state_from_tpu."""
    from cuda_vp9_torch import convert
    from cuda_vp9_tpu.runtime.multistream import BatchedFusedDecoder
    from cuda_vp9_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    packets = _packets("in01_176x144", 2)
    jdec = BatchedFusedDecoder(2)
    tdec = MS.BatchedTorchDecoder(2, "cpu")
    for p in packets:
        jdec.decode_round([p, p])
        tdec.decode_round([p, p])
        pool, ring = convert.batched_state_from_tpu(jdec, "cpu")
        assert torch.equal(tdec._pool, pool)
        assert torch.equal(tdec._ring, ring)
    assert tdec.rounds == 2


@pytest.mark.slow
def test_batched_geometry_change_survives():
    """in02 and sc01 (which resizes): the resized frames leave the batch
    for the single-stream step on the same device, all bit-exact, and sc01
    sends to the host what a TorchRecon alone sends there."""
    names = ("in02_352x288", "sc01_352x288_scaled")
    packets = [_packets(nm, 6) for nm in names]
    bd = MS.BatchedTorchDecoder(2, "cpu")
    for i in range(6):
        bd.decode_round([p[i] for p in packets])
    got = [[], []]
    for s, fr in bd.drain():
        got[s].append(frame_md5(fr.visible_planes()))
    for s, nm in enumerate(names):
        assert got[s] == _golden(nm)[:6]
    assert bd.recons[1].frames_unbatched > 0
    alone = TorchRecon("cpu")
    dec = NativeVp9Decoder(recon_fn=alone)
    for p in packets[1]:
        dec.decode(p)
    assert bd.recons[1].frames_on_host == alone.frames_on_host
