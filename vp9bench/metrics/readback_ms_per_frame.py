"""readback_ms_per_frame: milliseconds of the program's `vp9.readback` spans on the
main thread in the traced stretch, per frame delivered in it
(torch.profiler; the spans of `cuda_vp9_torch/utils/spans.py`)."""

from vp9bench.metrics import per_frame


def read(run):
    tr = run.trace
    return per_frame(run, None if tr is None else 1e3 * tr.span_s("vp9.readback"))
