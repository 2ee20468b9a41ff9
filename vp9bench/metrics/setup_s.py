"""setup_s: seconds from the start of the process to the start of the
window: imports, the CUDA context, the kernels' build or load, the
corpus, the decoder and its warm-up (host clock)."""


def read(run):
    return run.setup_s
