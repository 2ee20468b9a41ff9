"""glue_ms_per_frame: milliseconds of the main thread in the traced stretch
outside every vp9.* span of the program (the codec API, the frame driver,
the batched decoder's bookkeeping and the harness's delivery), per frame
delivered in it (torch.profiler)."""

from vp9bench.metrics import per_frame


def read(run):
    tr = run.trace
    return per_frame(run, None if tr is None else 1e3 * tr.glue_s)
