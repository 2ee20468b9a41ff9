"""batch_fill_pct: frames reconstructed in batched steps over the batched
steps' slots (steps times the decoder's streams), in the traced stretch,
in percent (`BatchedTorchDecoder.stats()` and `rounds`).  A batched frame
is one on the device or the host that did not leave the batch."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    rounds = tr.delta("rounds")
    if not rounds:
        return None
    batched = (tr.delta("frames_on_device") + tr.delta("frames_on_host")
               - tr.delta("frames_unbatched"))
    return 100.0 * batched / (rounds * tr.c1["slots"])
