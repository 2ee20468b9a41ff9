"""The program's api.* spans round its entry points leave every accepted
reading of a traced run as it was, and enclose its vp9.* spans as
torch.profiler records them.

  * On a synthetic event list (a stretch, vp9.* spans, device
    operations, counters), the api.* ranges added around the work change
    nothing that a per-layer reader of BENCHMARK.json or `breakdown()`
    returns: `Stretch` reads vp9.* ranges only.
  * Under torch.profiler on the CPU, a step of each driver on the tests'
    tiny corpus (`tiny.json`) yields api.* ranges on the main thread that
    enclose every vp9.* range there, with no range inside another of its
    family.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from vp9bench.metrics import reader
from vp9bench.run import ROOT, Run
from vp9bench.trace import STRETCH, Stretch
from vp9bench.traffic import Item, load_traffic

HERE = Path(__file__).resolve().parent
TINY = json.loads((HERE / "tiny.json").read_text())
PER_LAYER = [m["name"] for m in
             json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]
WORK = ("vp9.parse", "vp9.pack", "vp9.compact", "vp9.upload",
        "vp9.readback")


def _event(name, start_ms, end_ms, device=False, thread=1):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, thread=thread,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start_ms * 1e3, end=end_ms * 1e3))


def _events(with_api: bool):
    """A 1-s stretch of 10 frames of 100 ms: per frame the host's work
    spans, a device kernel after the upload and a copy in the read-back;
    with_api adds a decode's api.* range round the parse to the upload, a
    visible_planes range round the read-back, and one on another
    thread."""
    ev = [_event(STRETCH, 0, 1000)]
    for i in range(10):
        t = 100 * i
        for k, name in enumerate(WORK):
            ev.append(_event(name, t + 5 + 15 * k, t + 15 + 15 * k))
        ev.append(_event("mc_pass_kernel_true_", t + 70, t + 74,
                         device=True))
        ev.append(_event("intra_pass_kernel_true_", t + 74, t + 76,
                         device=True))
        ev.append(_event("Memcpy_DtoH", t + 65, t + 69, device=True))
        if with_api:
            ev.append(_event("api.vpx_codec_decode", t + 2, t + 63))
            ev.append(_event("api.visible_planes", t + 64, t + 80))
            ev.append(_event("api.drain", t + 1, t + 99, thread=2))
    return ev


def _run(with_api: bool, streams) -> Run:
    c0 = {"launches": 0, "plain_calls": 0, "sent_bytes": 0,
          "dense_frames": 0, "frames_on_device": 0, "frames_on_host": 0,
          "frames_unbatched": 0, "rounds": 0, "slots": 4}
    c1 = dict(c0, launches=21, sent_bytes=512000, frames_on_device=10,
              frames_unbatched=2, rounds=4)
    fed = [Item(i % 2, i // 2, i // 2) for i in range(10)]
    run = Run(TINY, streams, "NVIDIA H100 80GB HBM3")
    run.trace = Stretch(_events(with_api), 10, fed, c0, c1)
    return run


def test_api_ranges_move_no_reading():
    from vp9bench import corpus
    streams = corpus.load(TINY)
    bare, traced = _run(False, streams), _run(True, streams)
    got = {n: reader(n)(traced) for n in PER_LAYER}
    assert got == {n: reader(n)(bare) for n in PER_LAYER}
    assert all(v is not None for v in got.values()), got
    assert traced.trace.breakdown() == bare.trace.breakdown()
    assert traced.trace.glue_s == pytest.approx(0.5)


TRAFFIC = {
    "batched": dict(load_traffic("batch16_staggered"), slots=2,
                    warmup_rounds=1, drain_every=1),
    "codec_api": dict(load_traffic("stream1_lag16"), read_lag=1,
                      warmup_frames=1),
}
API = {"batched": {"api.decode_round", "api.drain", "api.visible_planes"},
       "codec_api": {"api.vpx_codec_decode", "api.vpx_codec_get_frame",
                     "api.visible_planes"}}


@pytest.mark.parametrize("driver", sorted(TRAFFIC))
def test_profiler_sees_api_ranges_round_the_work(driver):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vp9bench import corpus
    from vp9bench.drivers import DRIVERS
    streams = corpus.load(TINY)
    drv = DRIVERS[driver](TINY, TRAFFIC[driver], streams, 7, "cpu")
    drv.warm_up()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert drv.step()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    api = sorted((e.time_range.start, e.time_range.end, e.name, e.thread)
                 for e in cpu if e.name.startswith("api."))
    work = sorted((e.time_range.start, e.time_range.end, e.name, e.thread)
                  for e in cpu if e.name.startswith("vp9."))
    assert {n for *_, n, _ in api} == API[driver]
    assert {"vp9.parse", "vp9.pack", "vp9.readback"} <= \
        {n for *_, n, _ in work}
    assert len({t for *_, t in api + work}) == 1, "not all on one thread"
    for family in (api, work):
        for (_, b, _, _), (a, _, _, _) in zip(family, family[1:]):
            assert a >= b, "a range inside another of its family"
    for a, b, n, _ in work:
        assert any(x <= a and b <= y for x, y, _, _ in api), \
            f"{n} outside every api.* range"
