"""mc_roofline: the least bytes of the inter prediction of the frames
fed in the traced stretch, over the MC kernel's device time there
(`mc_pass_kernel`, csrc/mc.cu), against the card's peak bandwidth, in
percent."""

from vp9bench.roofline import share

TAPS_APRON = 7        # an 8-tap filter reads 3 samples before, 4 after


def mc_bytes(frame: dict, bytes_per_sample: int) -> int:
    """Each reference block read once, with the filter's apron in each
    axis where the vector is sub-pel there (twice for a compound unit: the
    facts list each reference's read), and each predicted sample written
    once."""
    n = 0
    for p, reads in enumerate(frame.get("mc_reads", ())):
        for key, (n0, nx, ny, nxy) in reads.items():
            w, h = (int(v) for v in key.split("x"))
            a = TAPS_APRON
            n += (n0 * w * h + nx * (w + a) * h + ny * w * (h + a)
                  + nxy * (w + a) * (h + a))
        n += 16 * frame["inter_4x4"][p]
    return n * bytes_per_sample


def read(run):
    return share(run, mc_bytes, "mc_pass_kernel")
