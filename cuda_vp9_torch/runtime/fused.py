"""One VP9 frame step on torch tensors.

Counterpart of `cuda_vp9_tpu/runtime/fused.py` (`make_frame_step`,
`get_frame_step`) for the slice this package covers: bit depths 8, 10 and
12, chroma 4:2:0, 4:4:4 and 4:2:2, and lossless frames (the WHT on
bucket tx0, the only bucket of a lossless layout).  It reads the flat
int16 wire of `runtime/pack.py` or of the native packer, the same bytes
the JAX step reads, uploaded page-compacted (`runtime/upload.py`) and
rebuilt on the device as the JAX step's page-tier branch does
(fused.py:513-518).

`make_batched_step` / `get_batched_step` are the multi-stream step (the
counterpart of JAX's vmapped `get_batched_step`): the same stages, once
per round for the 4:2:0 frames of N streams of one geometry, with the
loop filter as one launch of the stream-axis kernel (`lf_frames`).

step(pool, ring, kernels, flat) reconstructs one frame and updates
`pool` and `ring` in place (JAX donates them; here the update is in
place to keep one copy of the pool on the device):

  upload (page compaction on the host, one host-to-device copy, the
  page expansion: `ops/cuda/pages.py`, one launch) -> residual
  transforms of every coefficient bucket -> MC (mc4, mc8,
  mc16, mc32, then the scaled-reference class mcs; compound averages
  from each class's n_ref0 chunk on) -> inter residual add under mi_mask
  -> intra wavefront, chunk by chunk -> loop filter -> pool refresh
  (misc[5:13]) and ring row misc[13].

On a CUDA pool the page expansion, the residual transforms
(`ops/cuda/residual.py`, one launch per frame for every bucket), MC with the inter residual add
(`ops/cuda/mc.py`, one persistent launch per frame whose last phase is
the mask add), the intra wavefront (`ops/cuda/intra.py`, one persistent
launch per frame that runs the chunks as a chain) and the loop filter
are hand-written kernels; the refresh and the ring are torch ops.  On a
CPU pool each kernel's plain torch twin runs instead.

Above 8 bits the coefficients ship as (lo, hi) int16 pairs and the
transforms run in the int32 WRAPLOW domain; the ring is int16.  The loop
filter follows the chroma format: 4:2:0 is one `lf_frame` call; 4:4:4
filters each chroma plane through the kernel's luma path on the chroma
cell grid; 4:2:2 filters the chroma planes with `lf_chroma_422`, in the
order of the luma superblocks (fused.py:638-682).

The pool canvas [pha, pwa] may exceed the frame canvas [ha, wa] when
scaled references are live; each slot then holds its frame in the
top-left corner, as in JAX.  MC reads the pool directly with the
normative edge clamps (ops/ref/inter.convolve_block semantics); the
TPU's one-hot band formulation (and with it the headers' row band) is
not ported.

`flat` is the HOST numpy buffer.  The step uploads it once, through the
caller's `upload.Uploader` (the `uploader` keyword; by default one the
step keeps), whose spans are vp9.compact (host), vp9.upload (the copy)
and vp9.expand (the kernel), and reads every loop bound (the misc trip
counts, lf_on, the refresh flags and the ring slot) from the host copy,
so it never waits on the device for a number.

Padding.  The packer pads records with y = 0 on the wire; JAX drops
their writes (`mode="drop"`) and clamps their reads.  Torch wraps
negative indices and a CUDA device asserts on an out-of-range one, so
here every gather index is clamped into range and every scatter goes to
a frame buffer with one trash element past its end, where padded
records land.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import models as M
from ..ops.cuda.intra import intra_pass, intra_pass_batched
from ..ops.cuda.lf422 import lf_chroma_422
from ..ops.cuda.loopfilter import lf_frame, lf_frames
from ..ops.cuda.mc import Mask, mc_class, mc_frame
from ..ops.cuda.residual import Bucket, residual_frame
from ..utils import spans
from . import pack
from .upload import Uploader

I32 = torch.int32

# (tile size, misc slot of the chunk count, misc slot of the first
# compound-average chunk) per MC class, in the JAX step's order
MC_CLASSES = ((4, 0, 23), (8, 1, 24), (16, 2, 25), (32, 33, 34))
# chroma subsampling (ss_x, ss_y) the step runs: 4:2:0, 4:4:4, 4:2:2
CHROMA_FORMATS = ((1, 1), (0, 0), (1, 0))


def cdiv(a, b):
    return (a + b - 1) // b


def require_slice(ss=(1, 1), scaled: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP queue-1 item, for a
    frame outside the slice this package ports; such a frame never goes
    to the host oracle."""
    if tuple(ss) not in CHROMA_FORMATS:
        raise NotImplementedError(
            f"chroma subsampling {tuple(ss)} (4:4:0): ROADMAP queue 1 "
            "item 9")
    if scaled and tuple(ss) != (1, 1):
        raise NotImplementedError(
            "scaled references with chroma other than 4:2:0: ROADMAP "
            "queue 1 item 8")


def frame_buffer(ha: int, wa: int, device) -> torch.Tensor:
    """int32 [3*ha*wa + 1]: a [3, ha, wa] frame plus one trash element
    that padded records write to."""
    return torch.zeros(3 * ha * wa + 1, dtype=I32, device=device)


# ----------------------------------------------------------------- inter


def inter_args(segs, flats, miscs, mi_rows: int, mi_cols: int, ss=(1, 1)):
    """(classes, mask) of the mc_frame call of a frame (or of a round's
    frames) from the host flats and their misc rows, in the JAX step's
    order (fused.py:603-633): the `McClass` of each tile class with
    chunks in some stream (mc4 .. mc32, then mcs), and the `Mask` of
    mi_mask, or None when no flat's mask has a bit set."""
    def counts(slot):
        return [int(m[slot]) for m in miscs]

    classes = [mc_class(segs, w, counts(n_slot), counts(r0_slot), r0_slot)
               for w, n_slot, r0_slot in MC_CLASSES if max(counts(n_slot))]
    if "mcs" in segs and max(counts(14)):
        classes.append(mc_class(segs, 0, counts(14), counts(15), 15))
    off, shape = segs["mi_mask"]
    size = int(np.prod(shape))
    mask = Mask(off, mi_rows, mi_cols, *ss) if any(
        f[off:off + size].any() for f in flats) else None
    return classes, mask


# ----------------------------------------------------------------- residual


def residual_buckets(trips, segs, bd: int, lossless: bool):
    """The `Bucket`s of a frame (or of a round's frames), in the step's
    order (fused.py:533-602), as segments of the flat: each coefficient
    bucket with trips, then the coo buckets.  trips(slot) is a misc trip
    count (the round's most in the batched step)."""
    out = []
    for name, tx, _ in pack.COEFF_BUCKETS:
        n = trips(pack.MISC_TRIP[name]) * pack.COEFF_CHUNK[name]
        # a lossless layout holds bucket tx0 only (fused.py:541)
        if not n or f"coeff_{name}" not in segs:
            continue
        off, shape = segs[f"coeff_{name}"]
        # above 8 bits the high words: v = (hi << 15) + lo (fused.py:557)
        out.append(Bucket(off, segs[f"coeffh_{name}"][0] if bd > 8 else None,
                          segs[f"cpos_{name}"][0], n, shape[1], tx,
                          1 if lossless else 0))
    for name, chunk, trip in (
            ("tx3c", pack.CHUNK_TX3C, pack.MISC_TRIP_TX3C),
            ("tx3cs", pack.CHUNK_TX3CS, pack.MISC_TRIP_TX3CS)):
        # 8-bit only: the layout has no coo buckets above 8 bits nor in a
        # lossless frame
        n = trips(trip) * chunk
        if n and f"coeff_{name}" in segs:
            off, shape = segs[f"coeff_{name}"]
            out.append(Bucket(off, None, segs[f"cpos_{name}"][0], n,
                              shape[1], 3, 2))
    return out


def residual_stage(Rbuf, flats, trips, segs, ha: int, wa: int, bd: int,
                   lossless: bool, run=residual_frame):
    """The residual transforms of a frame (or of a round's frames) into the
    frame buffer Rbuf: its buckets (`residual_buckets`), segments of the
    int16 flats [A, nflat] on Rbuf's device, in one `run` call, by
    default the kernel's wrapper (one launch on the card; the twins
    bucket by bucket on the CPU)."""
    run(Rbuf, flats, residual_buckets(trips, segs, bd, lossless), ha, wa,
        bd)


# ----------------------------------------------------------------- frame step


def loop_filter(F, seg, lf_on: int, mi_rows: int, mi_cols: int, bd: int,
                ss):
    """Deblock F [3, ha, wa] in place by chroma format (fused.py:638-682);
    `seg(name, dtype=...)` gives the device view of a wire segment."""
    thr = seg("lf_thr", dtype=torch.int16)
    ha, wa = F.shape[1:]
    ssx, ssy = ss
    hcc, wcc = ha >> ssy, wa >> ssx
    # the lfm of a 4:4:4 or 4:2:2 frame ships zeroed chroma fields, so
    # this call leaves the chroma planes as they are; they are filtered
    # after it
    lf_frame(F, seg("lfm", dtype=torch.int16), thr, lf_on, mi_rows=mi_rows,
             mi_cols=mi_cols, bd=bd)
    if ss == (1, 1) or not lf_on:
        return
    if ss == (0, 0):
        # 4:4:4: each chroma plane through the kernel's luma path on the
        # chroma plane's own cell grid, as plane 0 of a [3, hac, wac] canvas
        rc, cc = cdiv(mi_rows, 1 << ssy), cdiv(mi_cols, 1 << ssx)
        hac, wac = ((rc + 7) & ~7) * 8, ((cc + 7) & ~7) * 8
        lfm_c = seg("lfm_c", dtype=torch.int16)
        for p in (1, 2):
            Cp = torch.zeros((3, hac, wac), dtype=I32, device=F.device)
            Cp[0, :hcc, :wcc] = F[p, :hcc, :wcc]
            lf_frame(Cp, lfm_c, thr, lf_on, mi_rows=rc, mi_cols=cc, bd=bd)
            F[p, :hcc, :wcc] = Cp[0, :hcc, :wcc]
    else:
        # 4:2:2: both chroma planes in place, 64x32 tiles in luma-SB order
        lf_chroma_422(F, *(seg(nm, dtype=torch.int16) for nm in (
            "lfw_v", "lfw_h", "lfw_mb", "lfw_lm", "lfw_hv")), lf_on, bd=bd)


def upload(up: Uploader, flats, aux=None):
    """The host flats (a sequence of A) and the int16 aux on the device
    through `up`, in its three spans: vp9.compact, vp9.upload and
    vp9.expand.  Returns the device flats [A, nflat] int16 and the aux
    (None without one), both valid until up's next call."""
    with spans.span("vp9.compact"):
        st = up.stage(flats, aux)
    with spans.span("vp9.upload"):
        buf = up.send(st)
    with spans.span("vp9.expand"):
        flats_d = up.expand(st, buf)
    return flats_d, None if aux is None else up.aux(st, buf)


def _own_uploader(own: dict, dev) -> Uploader:
    """The step's own Uploader for dev, made at first use."""
    up = own.get(dev)
    if up is None:
        up = own[dev] = Uploader(dev)
    return up


def make_frame_step(mi_rows: int, mi_cols: int, layout, bd: int = 8,
                    ss=(1, 1), lossless: bool = False):
    """The step for one frame geometry, bit depth, chroma format, capacity
    tier and lossless flag (see the module docstring).  step(pool, ring,
    kernels, flat, uploader=None) -> None."""
    ss = tuple(ss)
    if ss not in CHROMA_FORMATS or bd not in (8, 10, 12):
        raise ValueError(f"no frame step for bd {bd}, chroma {ss}")
    ha = ((mi_rows + 7) & ~7) * 8
    wa = ((mi_cols + 7) & ~7) * 8
    hc, wc = ha >> ss[1], wa >> ss[0]
    segs = layout.segs

    own = {}

    def step(pool, ring, kernels, flat: np.ndarray, uploader=None):
        dev = pool.device
        pha, pwa = pool.shape[2], pool.shape[3]
        if pha < ha or pwa < wa:
            raise ValueError(f"pool canvas {(pha, pwa)} is smaller than "
                             f"the frame canvas {(ha, wa)}")
        flat_d = upload(uploader or _own_uploader(own, dev), [flat])[0][0]

        def host(name):
            off, shape = segs[name]
            return flat[off:off + int(np.prod(shape))].reshape(shape)

        def seg(name, rows=None, dtype=I32):
            """Device view of a segment (first `rows` rows), sign-extended
            to int32 unless dtype is int16."""
            off, shape = segs[name]
            if rows is not None:
                shape = (rows,) + tuple(shape[1:])
            a = flat_d[off:off + int(np.prod(shape))].view(shape)
            return a if dtype == torch.int16 else a.to(dtype)

        misc = host("misc").astype(np.int64)
        Fbuf = frame_buffer(ha, wa, dev)
        Rbuf = frame_buffer(ha, wa, dev)
        F = Fbuf[:-1].view(3, ha, wa)
        R = Rbuf[:-1].view(3, ha, wa)

        with spans.span("vp9.residual"):
            # one stream: the flat as [1, nflat]; every bucket in one call
            residual_stage(Rbuf, flat_d[None], lambda slot: int(misc[slot]),
                           segs, ha, wa, bd, lossless)

        with spans.span("vp9.inter"):
            # every class with chunks, then mcs, then the mask add: one
            # kernel launch over the flat as a batch of one stream
            classes, mask = inter_args(segs, [flat], [misc], mi_rows,
                                       mi_cols, ss)
            mc_frame(Fbuf, Rbuf, pool, kernels, flat_d[None], classes, mask,
                     None, bd, ha, wa)

        with spans.span("vp9.intra"):
            n_intra = int(misc[3])
            if n_intra:
                intra_pass(Fbuf, R, seg("intra", n_intra, torch.int16),
                           seg("chunk_bs", n_intra, torch.int16), n_intra,
                           bd)

        with spans.span("vp9.loopfilter"):
            loop_filter(F, seg, int(misc[4]), mi_rows, mi_cols, bd, ss)

        with spans.span("vp9.refresh"):
            for i in range(8):
                if misc[5 + i] > 0:
                    if (pha, pwa) != (ha, wa):
                        pool[i].zero_()
                    pool[i, :, :ha, :wa].copy_(F)
            # the ring row's dtype (uint8, or int16 above 8 bits) is the
            # ring's: copy_ narrows the int32 pixels
            out = torch.cat([F[0].reshape(-1), F[1, :hc, :wc].reshape(-1),
                             F[2, :hc, :wc].reshape(-1)])
            row = ring[int(misc[13])]
            row[:out.numel()].copy_(out)
            row[out.numel():].zero_()

    return step


def get_frame_step(mi_rows: int, mi_cols: int, tier: str,
                   lossless: bool = False, bd: int = 8, ss=(1, 1),
                   pool_ha: int | None = None):
    """(step, caps, layout) for one frame geometry and capacity tier
    ("full", "tight", "wide" or "scaled"; fused.get_frame_step).
    pool_ha: the reference pool's canvas height when it exceeds the
    frame's (scaled references).  Uncached: the caller keeps the result,
    because the native packer caches per layout object."""
    ss = tuple(ss)
    require_slice(ss, tier == "scaled")
    caps = pack.compute_caps(mi_rows, mi_cols, tier, lossless,
                             pool_ha=pool_ha, ss=ss)
    layout = pack.build_layout(caps, mi_rows, mi_cols, lossless, bd, ss=ss)
    return (make_frame_step(mi_rows, mi_cols, layout, bd, ss, lossless),
            caps, layout)


# ----------------------------------------------------------------- batched


def make_batched_step(n_streams: int, mi_rows: int, mi_cols: int, layout,
                      bd: int = 8, lossless: bool = False):
    """The step of N same-geometry 4:2:0 streams decoded in lockstep: the
    counterpart of the vmapped step of `fused.get_batched_step`
    (fused.py:724-766), with the vmap written out as a stream axis.

    step(pool, ring, kernels, flats, active, uploader=None) -> None.  pool
    [N, 8, 3, ha, wa] int32 and ring [N, RING, nout] are updated in place;
    flats holds A HOST int16 flats [nflat] (an array [A, nflat] or a
    sequence), the flat of each stream in `active` (a host sequence of A
    distinct stream indices: the streams with a frame this round, in any
    order).  A stream outside `active` sits the round out: no records, no
    refresh, no ring write.  Every loop bound comes from the host flats,
    as in the single-frame step.  The round is one upload (`upload`: the
    A compacted flats and the int16 aux of the active list and the
    refresh pairs, one copy, one expansion launch).

    The A frames share one frame buffer of 3A planes (plus the trash
    element), frame k at planes 3k .. 3k + 2, and every stage runs once
    for all of them: the coefficient buckets (one call for the round),
    each MC class (landed in two steps, so that every compound average
    sees its first prediction) and the mask add in one call, the intra
    chunks (one call for the round: chunk index i of every stream is one
    step of the chain, each record with its own stream's block size), one
    `lf_frames` launch, one indexed pool refresh and one indexed ring
    write.  A stream whose count in a bucket, class or chunk
    list is below the round's most runs the rest as padding records (the
    wire is zero there), as JAX's shared round-max trip counts do."""
    ha = ((mi_rows + 7) & ~7) * 8
    wa = ((mi_cols + 7) & ~7) * 8
    hc, wc = ha >> 1, wa >> 1
    segs = layout.segs
    nflat = cdiv(layout.size, pack.PAGE) * pack.PAGE

    own = {}

    def step(pool, ring, kernels, flats, active, uploader=None):
        dev = pool.device
        A = len(active)
        if tuple(pool.shape) != (n_streams, 8, 3, ha, wa) \
                or len(flats) != A or not A \
                or any(f.shape != (nflat,) for f in flats):
            raise ValueError("batched step: pool, flats or active do not "
                             "match the step's geometry")
        miscs = [layout.view(f, "misc").astype(np.int64) for f in flats]
        # pool refresh pairs: (slot 8s + i of the stacked pool, frame k)
        refresh = [(8 * s + i, k) for k, (s, m) in enumerate(
            zip(active, miscs)) for i in range(8) if m[5 + i] > 0]
        aux = np.array(list(active) + [d for d, _ in refresh]
                       + [k for _, k in refresh], np.int16)
        flat_d, aux16 = upload(uploader or _own_uploader(own, dev), flats,
                               aux)
        aux_d = aux16.long()
        act_d = aux_d[:A]

        def most(slot):
            return max(int(m[slot]) for m in miscs)

        def seg(name, rows=None, dtype=I32):
            """[A, ...] device view of a segment of every flat (first
            `rows` rows), sign-extended to int32 unless dtype is int16."""
            off, shape = segs[name]
            if rows is not None:
                shape = (rows,) + tuple(shape[1:])
            a = flat_d[:, off:off + int(np.prod(shape))].view(A, *shape)
            return a if dtype == torch.int16 else a.to(dtype)

        Fbuf = torch.zeros(3 * A * ha * wa + 1, dtype=I32, device=dev)
        Rbuf = torch.zeros_like(Fbuf)
        F = Fbuf[:-1].view(A, 3, ha, wa)
        pool_s = pool.view(n_streams * 8, 3, ha, wa)
        misc16 = seg("misc", dtype=torch.int16)

        with spans.span("vp9.residual"):
            # every bucket in one call over every stream's records;
            # stream k's units land in planes 3k + plane
            residual_stage(Rbuf, flat_d, most, segs, ha, wa, bd, lossless)

        with spans.span("vp9.inter"):
            # every class with chunks, then the mask add, in one kernel
            # launch; chunks before each stream's own n_ref0 (read on the
            # device) are first predictions, the others compound second
            # ones
            classes, mask = inter_args(segs, flats, miscs, mi_rows, mi_cols)
            mc_frame(Fbuf, Rbuf, pool_s, kernels, flat_d, classes, mask,
                     aux16[:A], bd, ha, wa)

        with spans.span("vp9.intra"):
            n_intra = most(3)
            if n_intra:
                intra_pass_batched(
                    Fbuf, Rbuf[:-1].view(3 * A, ha, wa),
                    seg("intra", n_intra, torch.int16),
                    seg("chunk_bs", n_intra, torch.int16),
                    misc16[:, 3], n_intra, bd)

        with spans.span("vp9.loopfilter"):
            lf_frames(F, seg("lfm", dtype=torch.int16),
                      seg("lf_thr", dtype=torch.int16),
                      [int(m[4]) for m in miscs], mi_rows=mi_rows,
                      mi_cols=mi_cols, bd=bd)

        with spans.span("vp9.refresh"):
            if refresh:
                nr = len(refresh)
                pool_s[aux_d[A:A + nr]] = F[aux_d[A + nr:]]
            out = torch.cat([F[:, 0].reshape(A, -1),
                             F[:, 1, :hc, :wc].reshape(A, -1),
                             F[:, 2, :hc, :wc].reshape(A, -1)], 1)
            # every stream of a round writes the round's ring slot
            ring[act_d, int(miscs[0][13])] = out.to(ring.dtype)

    return step


def get_batched_step(n_streams: int, mi_rows: int, mi_cols: int,
                     lossless: bool = False, bd: int = 8,
                     tier: str = "wide"):
    """(step, caps, layout) of the batched step for N same-geometry 4:2:0
    streams at one capacity tier ("tight" or "wide", as
    fused.get_batched_step; or "full", for rounds of intra-only frames
    that overflow the wide tier, which JAX decodes on its host oracle).
    The tight and wide tiers pin the 64-unit intra chunk, so that a tight
    flat escalates to the wide layout by a prefix copy per segment.
    Uncached, as get_frame_step."""
    caps = pack.compute_caps(mi_rows, mi_cols, tier, lossless)
    if tier != "full":
        caps["intra_chunk"] = pack.CHUNK_INTRA
    layout = pack.build_layout(caps, mi_rows, mi_cols, lossless, bd)
    return (make_batched_step(n_streams, mi_rows, mi_cols, layout, bd,
                              lossless), caps, layout)


def ring_dtype(bd: int) -> torch.dtype:
    """The output ring's dtype: uint8 at 8 bits, int16 above (pixels are
    at most 4095)."""
    return torch.uint8 if bd == 8 else torch.int16


def entry(device):
    """(fn, example_args): the step at one 64x64 superblock on an
    all-zero tight-tier flat, the counterpart of `__graft_entry__.entry`
    as a check that the step builds and runs on `device`."""
    step, caps, layout = get_frame_step(8, 8, "tight")
    ha = wa = 64
    pool = torch.zeros((8, 3, ha, wa), dtype=I32, device=device)
    ring = torch.zeros((32, ha * wa + 2 * (ha >> 1) * (wa >> 1)),
                       dtype=ring_dtype(8), device=device)
    kernels = torch.as_tensor(np.asarray(M.FILTER_KERNELS, np.int32),
                              device=device)
    flat = np.zeros(cdiv(layout.size, pack.PAGE) * pack.PAGE, np.int16)
    return step, (pool, ring, kernels, flat)
