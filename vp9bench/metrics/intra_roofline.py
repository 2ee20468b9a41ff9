"""intra_roofline: the least bytes of the intra prediction of the
frames fed in the traced stretch, over the intra kernel's device time
there (`intra_pass_kernel`, csrc/intra.cu), against the card's peak
bandwidth, in percent."""

from vp9bench.roofline import share


def intra_bytes(frame: dict, bytes_per_sample: int) -> int:
    """Each intra-predicted sample written once, and each neighbour a
    transform block reads (the row above, the column to the left and the
    corner, where the spec makes them available) read once."""
    n = 0
    for p, (_, above, left, corner) in enumerate(frame.get("intra_edges",
                                                           ())):
        n += 16 * frame["intra_4x4"][p] + above + left + corner
    return n * bytes_per_sample


def read(run):
    return share(run, intra_bytes, "intra_pass_kernel")
