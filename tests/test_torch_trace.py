"""The host path's counters and the entry points' spans, on the CPU.

  * The native parse and pack counters (`native.counters()`) advance on
    the first frames of tl01 (two tile columns) parsed with two tile
    threads, and hold their order: the tile section within the parse,
    the tiles' busy time within the threads' slots (two workers: the
    slots are twice the section), the zero-fill within the pack; the
    fill's bytes are the flat's.
  * The read-back's bytes (`runtime/pipeline.readback_bytes`) are the
    ring rows fetched, rows times row bytes, by a `TorchRecon` and by a
    2-stream `BatchedTorchDecoder` (every stream's row of each fetched
    slot), and the widening of those rows is timed.
  * The api.* spans of the codec API and of the batched decoder
    enclose every vp9.* span of the work they call (the parse inside the
    decode's); no span lies inside another of its family.  The ranges as
    torch.profiler records them are checked in
    `vp9bench/tests/test_vp9bench_api_spans.py`.
"""

import time
from contextlib import contextmanager

import pytest

from conftest import FIXTURES
from cuda_vp9_torch import native
from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.runtime import pipeline


def _packets(name, n):
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r][:n]


def test_native_counters_advance_in_order():
    from cuda_vp9_torch.runtime import pack
    parser = native.NativeParser(threads=2)
    c0 = native.counters()
    flats = []
    for i, data in enumerate(_packets("tl01_640x360_t2", 3)):
        plan = parser.parse(data)
        assert plan.hdr.log2_tile_cols == 1
        if i == 0:
            h = plan.hdr
            caps = pack.compute_caps(h.mi_rows, h.mi_cols, "full", False)
            layout = pack.build_layout(caps, h.mi_rows, h.mi_cols, False,
                                       h.bit_depth)
            flats.append(parser.pack(plan, {}, caps, layout))
    d = {k: v - c0[k] for k, v in native.counters().items()}
    assert set(d) == set(native.COUNTERS)
    assert all(v > 0 for v in d.values()), d
    assert d["parse_tiles_ns"] <= d["parse_ns"]
    assert d["parse_tile_busy_ns"] <= d["parse_tile_slots_ns"]
    assert d["parse_tile_slots_ns"] == 2 * d["parse_tiles_ns"]
    assert d["pack_fill_ns"] <= d["pack_ns"]
    assert d["pack_fill_bytes"] == flats[0].nbytes


def _readback(make):
    """(bytes counted, bytes of the rows fetched, widening ns) of make(),
    which decodes and reads and returns the rows it fetched."""
    b0, w0 = pipeline.readback_bytes, pipeline.readback_widen_ns
    want = make()
    return (pipeline.readback_bytes - b0, want,
            pipeline.readback_widen_ns - w0)


def _recon_rows():
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    recon = pipeline.TorchRecon("cpu")
    dec = NativeVp9Decoder(recon_fn=recon)
    frames = []
    for data in _packets("kf01_64x64", 2):
        dec.decode(data)
        frames += dec.frames()
    row = recon._ring[0].nbytes
    for f in frames:
        f.visible_planes()
    return len(frames) * row


def _batched_rows():
    from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
    bd = BatchedTorchDecoder(2, "cpu")
    packets = _packets("kf01_64x64", 2)
    for p in packets:
        bd.decode_round([p, p])
    row = bd._ring[0, 0].nbytes
    got = [fr.visible_planes() for _, fr in bd.drain()]
    assert len(got) == 2 * len(packets)
    return 2 * len(packets) * row


@pytest.mark.parametrize("make", [_recon_rows, _batched_rows],
                         ids=["recon", "batched"])
def test_readback_bytes_are_the_rows_fetched(make):
    counted, want, widen_ns = _readback(make)
    assert counted == want > 0
    assert widen_ns > 0


def _recorded(run, monkeypatch):
    """(the api.* names run() expects, [(name, start, end)] of every span
    it opened), with a clock in place of `spans.span`: every span of the
    port opens through it, and a profiler's record_function ranges on
    the CPU twins' ops would take seconds to read back."""
    from cuda_vp9_torch.utils import spans
    got = []

    @contextmanager
    def clock(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            got.append((name, t0, time.perf_counter_ns()))

    monkeypatch.setattr(spans, "span", clock)
    return run(), got


def _codec_api():
    from cuda_vp9_torch import codec
    ctx = codec.CodecCtx()
    assert codec.vpx_codec_dec_init(ctx, codec.vp9_dx_torch("cpu"),
                                    codec.DecCfg(threads=1)) == 0
    for data in _packets("kf01_64x64", 2):
        assert codec.vpx_codec_decode(ctx, data) == 0
        it = codec.FrameIter()
        while (img := codec.vpx_codec_get_frame(ctx, it)) is not None:
            img.planes
    codec.vpx_codec_destroy(ctx)
    return {"api.vpx_codec_decode", "api.vpx_codec_get_frame",
            "api.visible_planes"}


def _batched():
    from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
    bd = BatchedTorchDecoder(2, "cpu")
    for p in _packets("kf01_64x64", 2):
        bd.decode_round([p, p])
    for _, fr in bd.drain():
        fr.visible_planes()
    return {"api.decode_round", "api.drain", "api.visible_planes"}


@pytest.mark.parametrize("run", [_codec_api, _batched],
                         ids=["codec_api", "batched"])
def test_api_spans_enclose_the_work(run, monkeypatch):
    names, got = _recorded(run, monkeypatch)
    api = sorted((a, b, n) for n, a, b in got if n.startswith("api."))
    work = sorted((a, b, n) for n, a, b in got if n.startswith("vp9."))
    assert {n for _, _, n in api} == names
    assert {"vp9.parse", "vp9.pack", "vp9.readback"} <= {n for *_, n in work}
    for family in (api, work):
        for (_, b, _), (a, _, _) in zip(family, family[1:]):
            assert a >= b, "a span inside another of its family"
    decode = {"api.vpx_codec_decode", "api.decode_round"}
    for a, b, n in work:
        inside = {m for x, y, m in api if x <= a and b <= y}
        assert inside, f"{n} outside every api.* span"
        if n == "vp9.parse":
            assert inside <= decode, inside
