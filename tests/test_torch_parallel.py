"""The port's multi-card path (cuda_vp9_torch/parallel): one worker process
per mesh entry, each a `BatchedTorchDecoder` on its block of streams.

  * `stream_sharding` lays streams out as P("data") lays out a leading
    axis (blocks differ by at most one, the first ones larger), and
    `data_mesh` lists devices, raising ValueError with too few cards; a
    mesh with more entries than streams is refused before any worker
    starts;
  * `ShardedBatchedDecoder(4, data_mesh(2, "cpu"))` on lg01, the first 3
    packets of in01, lg01 and in01, for 5 rounds: every frame's MD5 equals
    its golden prefix, every frame is byte-equal to `BatchedTorchDecoder(4,
    "cpu")` on the same packets (tolerance 0: integer math), `stats()`
    uses global indices, and after `close()` no worker is alive;
  * with defer_output, `sync()` returns an int and reading a frame raises;
  * a packet that makes one worker's decoder raise makes the parent raise,
    naming that worker and its device, and stops every worker.

Slow tier: the same check on kf02, in01's first 5 packets, kf02 and in01
(kf02's intra frames make the CPU reference slow), and, each in a fresh
process (ROADMAP F1), the port's
`python -m cuda_vp9_torch.parallel.dryrun 3 --device cpu` whole, and JAX
`BatchedFusedDecoder(2, mesh=data_mesh(2))` on a virtual CPU mesh against
`ShardedBatchedDecoder(2, data_mesh(2, "cpu"))`, frame for frame.

This file imports no JAX at module level."""

import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.parallel import (ShardedBatchedDecoder, data_mesh,
                                     stream_sharding)
from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
from cuda_vp9_torch.utils.md5 import frame_md5

# xdist runs several workers on the same cores: one torch thread each here,
# and so one in each decoder worker too.
torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).resolve().parent
FIXTURES = TESTS / "fixtures"
ROUNDS = 5


def _packets(name, n=None):
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r][:n]


def _golden(name):
    return [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]


def _rounds(packets, n_rounds):
    return [[p[i] if i < len(p) else None for p in packets]
            for i in range(n_rounds)]


@pytest.mark.parametrize("n_mesh, n_streams, want", [
    (2, 5, [(0, 3), (3, 5)]),
    (2, 4, [(0, 2), (2, 4)]),
    (3, 8, [(0, 3), (3, 6), (6, 8)]),
    (1, 3, [(0, 3)]),
])
def test_stream_sharding_lays_out_blocks_as_p_data(n_mesh, n_streams, want):
    blocks = stream_sharding(data_mesh(n_mesh, "cpu"), n_streams)
    assert [(b.start, b.stop) for b in blocks] == want


def test_data_mesh_lists_devices_and_refuses_missing_cards():
    assert data_mesh(2, "cpu") == [torch.device("cpu")] * 2
    assert data_mesh(device_type="cpu") == [torch.device("cpu")]
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} devices, "
                                         f"have {have}"):
        data_mesh(have + 1)
    if have == 0:
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            data_mesh()


def test_sharded_decoder_refuses_a_mesh_it_cannot_fill():
    """Fewer streams than mesh entries: refused before any worker
    starts."""
    with pytest.raises(ValueError, match="1 streams cannot fill a mesh of 2"):
        ShardedBatchedDecoder(1, data_mesh(2, "cpu"))


def _batched_frames(packets):
    dec = BatchedTorchDecoder(len(packets), "cpu")
    for r in _rounds(packets, ROUNDS):
        dec.decode_round(r)
    return [(s, [np.asarray(p) for p in fr.planes]) for s, fr in dec.drain()]


def _check_sharded_against_batched(names, cut):
    """ShardedBatchedDecoder(4) over two CPU workers on the streams, stream
    1 cut to its first `cut` packets, for ROUNDS rounds, against golden
    and against BatchedTorchDecoder(4, "cpu") on the same packets."""
    packets = [_packets(nm) for nm in names]
    packets[1] = packets[1][:cut]
    # the in-process reference runs beside the workers
    with ThreadPoolExecutor(1) as ex:
        ref = ex.submit(_batched_frames, packets)
        dec = ShardedBatchedDecoder(4, data_mesh(2, "cpu"))
        procs = list(dec._procs)
        with dec:
            assert len(procs) == 2 and all(p.is_alive() for p in procs)
            for r in _rounds(packets, ROUNDS):
                dec.decode_round(r)
            got = list(dec.drain())
            st = dec.stats()
        want = ref.result(timeout=600)
    assert not any(p.is_alive() for p in procs)
    assert [s for s, _ in got] == [s for s, _ in want]
    md5s = [[] for _ in names]
    for (s, fr), (_, planes) in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(fr.planes, planes))
        md5s[s].append(frame_md5(fr.visible_planes()))
    for s, nm in enumerate(names):
        assert md5s[s] == _golden(nm)[:min(ROUNDS, len(packets[s]))]
    assert len(st["streams"]) == 4
    assert [r["device"] for r in st["streams"]] == [
        min(ROUNDS, len(p)) for p in packets]
    assert [(w["streams"], w["rounds"]) for w in st["workers"]] == [
        (range(0, 2), ROUNDS), (range(2, 4), ROUNDS)]
    for w in st["workers"]:
        # the CPU has no kernel: every stage ran its plain version
        assert w["device"] == "cpu"
        assert w["kernels"]["loopfilter"]["plain_calls"] > 0
        assert not any(c["launches"] for c in w["kernels"].values())


def test_sharded_decoder_matches_golden_and_the_batched_decoder():
    """lg01 and in01 (keyframes, then inter frames), stream 1 sitting the
    last two rounds out."""
    _check_sharded_against_batched(("lg01_176x144_48f", "in01_176x144",
                                    "lg01_176x144_48f", "in01_176x144"), 3)


@pytest.mark.slow
def test_sharded_decoder_on_intra_frames_matches_the_batched_decoder():
    """Slow: kf02's five intra frames beside in01 (the plain batched intra
    pass of the CPU reference takes about 15 s here)."""
    _check_sharded_against_batched(("kf02_176x144", "in01_176x144",
                                    "kf02_176x144", "in01_176x144"), 5)


def test_sharded_defer_output_syncs_and_keeps_frames_on_the_device():
    packets = [_packets("kf01_64x64", 2)] * 4
    with ShardedBatchedDecoder(4, data_mesh(2, "cpu"),
                               defer_output=True) as dec:
        for r in _rounds(packets, 2):
            dec.decode_round(r)
        check = dec.sync()
        frames = list(dec.drain())
    assert isinstance(check, int) and check > 0
    assert [s for s, _ in frames] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(RuntimeError, match="defer_output"):
        frames[0][1].visible_planes()


def test_a_worker_failure_raises_in_the_parent_naming_the_worker():
    packet = _packets("kf01_64x64", 1)[0]
    dec = ShardedBatchedDecoder(4, data_mesh(2, "cpu"))
    procs = list(dec._procs)
    dec.decode_round([packet] * 4)
    with pytest.raises(RuntimeError, match=r"worker 1 on cpu .*failed:\n"
                                           r"Traceback(.|\n)*corrupted"):
        # stream 3 is worker 1's: a packet that is no keyframe, with no
        # decoder state to resync from
        dec.decode_round([packet] * 3 + [b"\0" * 10])
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        dec.flush()


def _fresh_process(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=TESTS, capture_output=True,
        text=True, timeout=3000,
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
             **(env or {}), "PYTHONPATH": os.pathsep.join(
                 [str(TESTS.parent), os.environ.get("PYTHONPATH", "")])})


@pytest.mark.slow
def test_dryrun_multichip_on_three_cpu_workers():
    r = subprocess.run(
        [sys.executable, "-m", "cuda_vp9_torch.parallel.dryrun", "3",
         "--device", "cpu"], cwd=TESTS.parent, capture_output=True,
        text=True, timeout=3000, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "dryrun_multichip: mesh ['cpu', 'cpu', 'cpu'] ok" in r.stdout


@pytest.mark.slow
def test_sharded_decoder_matches_jax_on_a_virtual_mesh():
    r = _fresh_process(
        "import test_torch_parallel as t; t.compare_with_jax_mesh()",
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


def compare_with_jax_mesh():
    """Two streams of in01 for two rounds through JAX BatchedFusedDecoder
    sharded over a 2-device virtual CPU mesh and through
    ShardedBatchedDecoder over two CPU workers: every frame's planes are
    byte-equal."""
    from cuda_vp9_tpu.parallel import data_mesh as jax_mesh
    from cuda_vp9_tpu.runtime.multistream import BatchedFusedDecoder
    from cuda_vp9_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    packets = [_packets("in01_176x144", 2)] * 2
    jdec = BatchedFusedDecoder(2, mesh=jax_mesh(2))
    for r in _rounds(packets, 2):
        jdec.decode_round(r)
    want = list(jdec.drain())
    with ShardedBatchedDecoder(2, data_mesh(2, "cpu")) as tdec:
        for r in _rounds(packets, 2):
            tdec.decode_round(r)
        got = list(tdec.drain())
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 0, 1, 1]
    for (_, a), (_, b) in zip(got, want):
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a.planes, b.planes))
    print("sharded decoder equals JAX's on the mesh:", len(got), "frames")
