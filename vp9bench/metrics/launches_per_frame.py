"""launches_per_frame: kernel launches of the program in the traced
stretch (the sum of the `launches` counters of `cuda_vp9_torch/ops/cuda`:
pages, residual, mc, intra, loopfilter, lf422), per frame delivered in
it."""

from vp9bench.metrics import per_frame


def read(run):
    tr = run.trace
    return per_frame(run, None if tr is None else tr.delta("launches"))
