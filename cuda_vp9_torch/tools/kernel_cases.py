"""Seeded inputs that drive the intra, residual and MC kernels down every
path, for holding each kernel against its plain twin bit for bit
(`chip_smoke.py`, the `cuda`-marked tests).  Each case is host numpy
arrays that the caller moves to the device it tests.

Intra (`intra_frame`, `intra_streams`): random frames and residuals with
units of every block size 4..32 on a block grid, one chunk list per
plane in wave order (wave 2y + x, so no unit reads a pixel another unit
of its chunk writes, as the packer guarantees), all 10 modes, random
availability (n_above < 2 bs and n_left < bs replicate the last valid
pixel; have_up and have_left drawn apart from them), the three tl_modes,
units on the canvas' right and bottom edges and straddling them, and
padded records (chunks are zero-filled to ich records).

Residual (`residual_bucket_case`, `residual_coo_case`, and
`residual_frame_case` for a frame's whole bucket set, no two units of it
at one position; `pack_buckets` lays cases out as the segments of a
flat): random units of one bucket at distinct block positions
of A streams' planes, random
tx_types, some padded records (cpos all zero), coefficients sparse and
moderate or extreme (the full int16 range at 8 bits; up to the bd +
8-bit WRAPLOW range above, and raw random high and low words), and for
the coo buckets (index, value) pairs with (0, 0) padding pairs.

MC (`mc_case`, `mc_args`, `mc_phases`, `phase_overlap`, `MC_CASES`): the
flats of 1 to 4 streams holding, per stream, the four unscaled tile
classes and (one stream) the scaled class mcs as the packer lays them
out (records, chunk headers, the chunk counts and first compound chunks
in misc), and an mi_mask, over a random pool whose canvas may exceed
the frame's and whose slots have random crops below it; destinations
on the tile grid of planes 0..2 of a 4:2:0, 4:4:4, 4:2:2 or 4:4:0 layout,
distinct within a landing phase and drawn for each class on its own (so
two phases may land on the same pixels); sources inside, near and past
the crop on every side (negative sr and sc), every filter and phase, q4
steps 8..32 for mcs; padded records (dy + 1 == 0, other fields random)
inside chunks, an all-zero chunk, compound chunks past n_ref0 that
average into first predictions, random values in the header fields the
port does not read; streams with different chunk counts and n_ref0, and
the active streams a random subset of the pool's; random mask words
over the full int16 range (bit 15 set in about half, bits past the last
mi column) and residuals that carry F + R past 0 and past 2^bd - 1.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

from ..ops.cuda.mc import HDR_WORDS, REC_WORDS, Mask, mc_class
from ..ops.cuda.residual import Bucket
from ..runtime import pack


def _record(x0, y0, plane, mode, n_above, n_left, tl_mode, have_up,
            have_left):
    """The 4 int16 words of one intra record (fused.py:433-446)."""
    w = [(x0 >> 2) | plane << 14, ((y0 >> 2) + 1) | have_up << 15,
         mode | n_above << 4 | n_left << 10, tl_mode | have_left << 2]
    return np.asarray(w, np.uint16).astype(np.int16)


def _unit(rng, bs, x0, y0, plane, mode):
    """A record with random availability fields."""
    have_up = int(rng.integers(0, 2))
    have_left = int(rng.integers(0, 2))
    n_above = int(rng.integers(0, min(2 * bs, 63) + 1))
    n_left = int(rng.integers(0, bs + 1))
    return _record(x0, y0, plane, mode, n_above, n_left,
                   int(rng.integers(0, 3)), have_up, have_left)


def _plane_chunks(rng, plane, code, ha, wa, ich):
    """One plane's chunk list: the block grid of size 4 << code in wave
    order, at most ich units a chunk, then (bs >= 8) one chunk of units
    straddling the right and the bottom edges."""
    bs = 4 << code
    rows, cols = ha // bs, wa // bs
    chunks = []
    mode = int(rng.integers(0, 10))
    for w in range(cols + 2 * (rows - 1)):
        units = []
        for y in range(rows):
            x = w - 2 * y
            if 0 <= x < cols:
                units.append(_unit(rng, bs, x * bs, y * bs, plane,
                                   mode % 10))
                mode += 1
        for i in range(0, len(units), ich):
            chunks.append(units[i:i + ich])
    if bs >= 8:
        half = bs // 2
        chunks.append([_unit(rng, bs, wa - half, 0, plane, 9),
                       _unit(rng, bs, 0, ha - half, plane, 3)])
    return [(code, c) for c in chunks]


def intra_chunks(rng, codes, ha, wa, ich):
    """(records int16 [n, ich, 4], chunk_bs int16 [n]): plane p's grid of
    block size code codes[p], the planes' chunk lists interleaved (each
    in its own wave order)."""
    lists = [_plane_chunks(rng, p, c, ha, wa, ich)
             for p, c in enumerate(codes)]
    order = []
    while any(lists):
        for lst in lists:
            if lst:
                order.append(lst.pop(0))
    rec = np.zeros((len(order), ich, 4), np.int16)
    for i, (_, units) in enumerate(order):
        rec[i, :len(units)] = units
    return rec, np.asarray([c for c, _ in order], np.int16)


def intra_frame(rng, ha, wa, bd, ich, codes=(0, 1, 2), planes=3):
    """(F [planes, ha, wa], R [planes, ha, wa], records, chunk_bs): random
    pixels and residuals, and the chunks of intra_chunks."""
    F = rng.integers(0, 1 << bd, (planes, ha, wa)).astype(np.int32)
    R = rng.integers(1 - (1 << bd), 1 << bd, (planes, ha, wa)).astype(
        np.int32)
    rec, cbs = intra_chunks(rng, codes, ha, wa, ich)
    return F, R, rec, cbs


def intra_streams(rng, n, ha, wa, bd, ich, cap=None):
    """A streams' frames for the batched form: (F [3n, ha, wa], R, flats
    int16 [n, nflat], (off_misc, off_cbs, off_rec, cap)).  Each stream's
    flat holds its chunk count at misc[3], its chunk_bs and its records
    [cap, ich, 4], zero past its count; the streams' block sizes differ
    (stream k plane p: code (k + p) % 4), so chunk index i mixes sizes."""
    F, R, lists = [], [], []
    for k in range(n):
        f, r, rec, cbs = intra_frame(rng, ha, wa, bd, ich,
                                     codes=[(k + p) % 4 for p in range(3)])
        F.append(f)
        R.append(r)
        lists.append((rec, cbs))
    cap = cap or max(len(c) for _, c in lists)
    off_misc, off_cbs = 0, 48
    off_rec = off_cbs + cap
    nflat = off_rec + cap * ich * 4 + 256
    flats = np.zeros((n, nflat), np.int16)
    for k, (rec, cbs) in enumerate(lists):
        flats[k, off_misc + 3] = len(cbs)
        flats[k, off_cbs:off_cbs + len(cbs)] = cbs
        flats[k, off_rec:off_rec + rec.size] = rec.reshape(-1)
    return (np.concatenate(F), np.concatenate(R), flats,
            (off_misc, off_cbs, off_rec, cap))


def _positions(rng, n_units, n, planes, ha, wa):
    """cpos int16 [n_units, 4] = (plane, y + 1, x, tx_type) at distinct
    n x n block positions of `planes` planes, about 1 in 8 and the last
    one padded (all zero)."""
    slots = planes * (ha // n) * (wa // n)
    if n_units > slots:
        raise ValueError("more units than block positions")
    pick = rng.choice(slots, n_units, replace=False)
    p, rest = np.divmod(pick, (ha // n) * (wa // n))
    y, x = np.divmod(rest, wa // n)
    pos = np.stack([p, y * n + 1, x * n, rng.integers(0, 4, n_units)], 1)
    pos[rng.random(n_units) < 0.125] = 0
    pos[-1] = 0
    return pos.astype(np.int16)


def _values(rng, shape, bd, extreme):
    """int64 coefficients: sparse and moderate, or dense and extreme."""
    if extreme:
        lim = 1 << (15 if bd == 8 else bd + 7)
        return rng.integers(-lim, lim, shape)
    c = rng.integers(-(1 << (bd + 2)), (1 << (bd + 2)) + 1, shape)
    return c * (rng.random(shape) < 0.3)


def residual_bucket_case(rng, A, n_units, tx, ncoef, bd, ha, wa,
                         extreme=False):
    """(coef, coefh or None, pos): int16 [A, n_units, ncoef] coefficient
    words (the first ncoef in scan order), their high words above 8 bits
    (v = (hi << 15) + lo; for extreme inputs a quarter of the units carry
    raw random words), and cpos int16 [A, n_units, 4] (stream k's planes
    are its own 0..2)."""
    n = 4 << tx
    v = _values(rng, (A, n_units, ncoef), bd, extreme)
    pos = np.stack([_positions(rng, n_units, n, 3, ha, wa)
                    for _ in range(A)])
    if bd == 8:
        return v.astype(np.int16), None, pos
    hi = (v >> 15).astype(np.int16)
    lo = (v & 0x7FFF).astype(np.int16)
    if extreme:
        raw = rng.random((A, n_units)) < 0.25
        hi[raw] = rng.integers(-32768, 32768, hi[raw].shape)
        lo[raw] = rng.integers(-32768, 32768, lo[raw].shape)
    return lo, hi, pos


def residual_coo_case(rng, A, n_units, npairs, ha, wa, extreme=False):
    """(pairs, pos): int16 [A, n_units, 2 npairs] interleaved (raster
    index, value) pairs of 32x32 units, distinct indices per unit, some
    (0, 0) padding pairs (a DC pair (0, v != 0) is real), and cpos int16
    [A, n_units, 4]."""
    pairs = np.zeros((A, n_units, 2 * npairs), np.int64)
    for k in range(A):
        for u in range(n_units):
            m = int(rng.integers(0, npairs + 1))
            idx = rng.choice(1024, m, replace=False)
            val = _values(rng, m, 8, extreme)
            val[val == 0] = 1
            pairs[k, u, 0:2 * m:2] = idx
            pairs[k, u, 1:2 * m:2] = val
    pos = np.stack([_positions(rng, n_units, 32, 3, ha, wa)
                    for _ in range(A)])
    return pairs.astype(np.int16), pos


def residual_frame_case(rng, A, bd, ha, wa, n_units, extreme=False):
    """A frame's bucket set for one call of the residual kernel: [(coef,
    coefh or None, pos, tx, kind)], every bucket of pack.COEFF_BUCKETS
    (kind 0), the WHT on a tx0 bucket of 16 coefficients (kind 1) and, at
    8 bits, the coo buckets of COO_PAIRS and COO16_PAIRS pairs (kind 2),
    each with up to n_units units as residual_bucket_case and
    residual_coo_case make them.  Each bucket owns its own share of the
    32x32 tiles of each stream's 3 planes, so no two units of the set
    write one pixel, as a frame's units never do."""
    specs = [(tx, nc, 0) for _, tx, nc in pack.COEFF_BUCKETS] + [(0, 16, 1)]
    if bd == 8:
        specs += [(3, pack.COO_PAIRS, 2), (3, pack.COO16_PAIRS, 2)]
    tcols = wa // 32
    tiles = 3 * (ha // 32) * tcols
    share = tiles // len(specs)
    perm = [rng.permutation(tiles) for _ in range(A)]
    out = []
    for b, (tx, nc, kind) in enumerate(specs):
        n = 4 << tx
        per_tile = (32 // n) ** 2
        m = min(n_units, share * per_tile)
        pos = np.zeros((A, m, 4), np.int64)
        for k in range(A):
            tile, sub = np.divmod(rng.choice(share * per_tile, m,
                                             replace=False), per_tile)
            p, rest = np.divmod(perm[k][b * share + tile], tiles // 3)
            ty, tx_ = np.divmod(rest, tcols)
            sy, sx = np.divmod(sub, 32 // n)
            pos[k] = np.stack([p, ty * 32 + sy * n + 1, tx_ * 32 + sx * n,
                               rng.integers(0, 4, m)], 1)
            pad = rng.random(m) < 0.125
            pad[-1] = True
            pos[k, pad] = 0
        if kind == 2:
            coef, coefh = residual_coo_case(rng, A, m, nc, ha, wa,
                                            extreme)[0], None
        else:
            coef, coefh, _ = residual_bucket_case(rng, A, m, tx, nc, bd, ha,
                                                  wa, extreme)
        out.append((coef, coefh, pos.astype(np.int16), tx, kind))
    return out


def pack_buckets(cases):
    """(src int16 [A, L], [residual.Bucket]): the arrays of bucket cases
    [(coef, coefh or None, pos, tx, kind)], each [A, n, k], laid one
    after another in each stream's row of src, as the wire's segments lie
    in a flat, and the buckets that name them."""
    parts, out, off = [], [], 0
    for coef, coefh, pos, tx, kind in cases:
        A, n, k = coef.shape
        offs = []
        for a in (coef, coefh, pos):
            if a is None:
                offs.append(None)
                continue
            offs.append(off)
            parts.append(a.reshape(A, -1))
            off += a.shape[1] * a.shape[2]
        out.append(Bucket(offs[0], offs[1], offs[2], n, k, tx, kind))
    return np.concatenate(parts, 1).astype(np.int16), out


# ----------------------------------------------------------------- MC

# (tile size, misc slot of the chunk count, misc slot of the first
# compound chunk) per unscaled class, as runtime/fused.MC_CLASSES; the
# scaled class's slots are 14 and 15
MC_SLOTS = ((4, 0, 23), (8, 1, 24), (16, 2, 25), (32, 33, 34))
MC_CHUNKS = (256, 128, 64, 32, 128)   # pack.CHUNK_MC4..32, CHUNK_MCS

# (bd, chroma (ss_x, ss_y), ha, wa, pool canvas padding (rows, cols),
# streams, chunk lengths or None for MC_CHUNKS, scaled class)
MC_CASES = [
    (8, (1, 1), 64, 64, (0, 0), 1, (16, 8, 4, 4, 8), True),
    (10, (0, 0), 96, 64, (16, 32), 1, (16, 8, 4, 4, 8), True),
    (12, (1, 0), 64, 96, (8, 8), 1, (16, 8, 4, 4, 8), True),
    (8, (1, 1), 144, 176, (32, 48), 1, None, True),
    (10, (1, 1), 64, 64, (0, 0), 3, (16, 8, 4, 4, 8), False),
    (8, (1, 1), 96, 96, (0, 0), 4, None, False),
    (10, (0, 1), 96, 64, (8, 16), 1, (16, 8, 4, 4, 8), True),
]


def mc_seg(flats, segs, name, rows):
    """The [A, rows, ...] view of the first `rows` rows of a segment of
    every flat; numpy or torch (flats on a device)."""
    off, shape = segs[name]
    size = rows * int(np.prod(shape[1:]))
    return flats[:, off:off + size].reshape(flats.shape[0], rows,
                                            *shape[1:])


def mc_args(case, flats, k=None):
    """(classes, mask) for ops/cuda/mc.mc_frame: the `McClass`es with
    chunks (with k, stream k's alone, the scaled class included, for
    flats[k:k + 1]; with k None, every stream's, n the most chunks, no
    scaled class) and the `Mask` of mi_mask.  flats: case.flats or that
    array on a device; the offsets do not depend on it."""
    misc = case.misc if k is None else case.misc[k:k + 1]

    def cls(w, ns, rs):
        return mc_class(case.segs, w, [int(x) for x in misc[:, ns]],
                        [int(x) for x in misc[:, rs]], rs)

    classes = [cls(w, ns, rs) for w, ns, rs in MC_SLOTS if misc[:, ns].max()]
    if k is not None and "mcs" in case.segs and misc[0, 14]:
        classes.append(cls(0, 14, 15))
    off, (rows, _) = case.segs["mi_mask"]
    return classes, Mask(off, rows, case.mi_cols, *case.ss)


def mc_phases(classes, mask) -> tuple:
    """(phases, scaled): the phases vp9_mc_pass runs for these arguments
    of mc_frame (per class, its firsts if any stream has a first chunk
    and its seconds if any has a compound one; the mask phase), and
    whether the scaled class is among them."""
    n = sum((min(c.hi, c.n) > 0) + (max(min(c.lo, c.n), 0) < c.n)
            for c in classes)
    return n + (mask is not None), any(c.w == 0 for c in classes)


class Overlap(NamedTuple):
    """Pixels of the frames [3A, ha, wa] that more than one phase of
    mc_frame writes, by kind: `cross` by phases of two or more tile
    classes, `seconds` by a class's compound seconds over its own firsts,
    `mask` by the mask phase over a pixel some class wrote."""
    cross: int
    seconds: int
    mask: int


def phase_overlap(case, flats, classes, mask) -> Overlap:
    """The Overlap of these mc_frame arguments (live tiles of each
    class's firsts and seconds, by each stream's own n_ref0, within the
    frame; the masked cells), host numpy: the cases in which the phases'
    order decides the result."""
    A = flats.shape[0]
    shape = (3 * A, case.ha, case.wa)
    classes_hit = np.zeros(shape, np.int32)
    any_mc = np.zeros(shape, bool)
    own = np.zeros(shape, bool)
    for c in classes:
        rw, hw = REC_WORDS[c.w], HDR_WORDS[c.w]
        by_phase = []
        for second in (0, 1):
            m = np.zeros(shape, bool)
            for k in range(A):
                r0 = int(flats[k, c.r0])
                u = flats[k, c.rec:c.rec + c.n * c.ch * rw].reshape(
                    c.n, c.ch, rw).astype(np.int64)
                hd = flats[k, c.hdr:c.hdr + c.n * hw].reshape(c.n, hw)
                for ci in range(c.n):
                    if (ci >= r0) != second:
                        continue
                    for rec in u[ci]:
                        if c.w:
                            if rec[1] == 0:
                                continue
                            w, plane = c.w, int(hd[ci, 1])
                            dy, dx = rec[1] - 1, rec[0] & 0x1FFF
                        else:
                            if rec[2] == 0:
                                continue
                            w, plane = 4, int(rec[0])
                            dy, dx = rec[2] - 1, rec[1]
                        if 0 <= plane <= 2:
                            m[3 * k + plane, max(dy, 0):max(dy + w, 0),
                              max(dx, 0):max(dx + w, 0)] = True
            by_phase.append(m)
        own |= by_phase[0] & by_phase[1]
        classes_hit += by_phase[0] | by_phase[1]
        any_mc |= by_phase[0] | by_phase[1]
    masked = mc_mask_bits(case, flats, mask) if mask is not None \
        else np.zeros(shape, bool)
    return Overlap(int((classes_hit > 1).sum()), int(own.sum()),
                   int((masked & any_mc).sum()))


def mc_mask_bits(case, flats, mask):
    """bool [3A, ha, wa]: the pixels the mask phase adds R to."""
    A = flats.shape[0]
    words = -(-mask.mi_cols // 16)
    mp = flats[:, mask.off:mask.off + mask.mi_rows * words].reshape(
        A, mask.mi_rows, words).astype(np.int64)
    cells = ((mp[..., None] >> np.arange(16)) & 1).reshape(
        A, mask.mi_rows, -1)[:, :, :mask.mi_cols] != 0
    out = np.zeros((3 * A, case.ha, case.wa), bool)
    for p in range(3):
        gy = 8 >> (mask.ssy if p else 0)
        gx = 8 >> (mask.ssx if p else 0)
        cm = cells.repeat(gy, 1).repeat(gx, 2)
        out[p::3, :cm.shape[1], :cm.shape[2]] = cm
    return out


def _tile_grid(rng, w, hp, wp, n):
    """Up to n distinct w-aligned (dy, dx) of an hp x wp plane region."""
    ys, xs = np.meshgrid(np.arange(0, hp - w + 1, w),
                         np.arange(0, wp - w + 1, w), indexing="ij")
    cells = np.stack([ys.ravel(), xs.ravel()], 1)
    return cells[rng.permutation(len(cells))[:n]]


def _source(rng, d, w, crop):
    """Source origins for destinations d: near them, or anywhere from
    past the crop's start to past its end, within int16 of d after the
    shift by 4."""
    near = d + rng.integers(-24, 25, len(d))
    far = rng.integers(-12 - w - 8, crop + 20, len(d))
    return np.clip(np.where(rng.random(len(d)) < 0.5, near, far), d - 2000,
                   d + 2000)


def _chunks(rng, tiles, ch, make):
    """Chunk records [n, ch, rw] of `tiles` (plane, dy, dx, ...) grouped
    by plane: each chunk takes 1..ch of one plane's tiles at random record
    positions, the other records padding (dy + 1 == 0, the rest random);
    make(rng, group) gives a group's records.  Returns (records,
    planes)."""
    recs, planes = [], []
    for p in (0, 1, 2):
        t = [x for x in tiles if x[0] == p]
        while t:
            m = int(rng.integers(1, ch + 1))
            group, t = t[:m], t[m:]
            r = make(rng, group)
            out = rng.integers(-32768, 32768, (ch, r.shape[1])).astype(
                np.int16)
            out[:, 1 if r.shape[1] == 4 else 2] = 0
            out[rng.choice(ch, len(group), replace=False)] = r
            recs.append(out)
            planes.append(p)
    return recs, planes


def mc_case(rng, bd, ss, ha, wa, pad, n_streams, chunks=None,
            scaled=True):
    """The inputs of one MC case, a namespace of: pool int32 [8 P, 3,
    pha, pwa] (P >= n_streams pools), F int32 [3 A, ha, wa] the frames
    the predictions land in (stream k at planes 3k .. 3k + 2), flats
    int16 [A, nflat] with segs {name: (off, shape)} ("misc", "mc{w}",
    "mc{w}h", "mcs", "mcsh"), active int16 [A] (stream k reads pool
    slots 8 active[k] + slot), misc int64 [A, 48], R int32 [3 A, ha, wa]
    the residuals of the mask add, "mi_mask" [ha / 8, ceil(mi_cols / 16)]
    in the flats with mi_cols = wa / 8 - 1, and bd, ss, ha, wa.  Per
    stream a random number of tiles a class (so chunk counts and n_ref0
    differ between streams), about a third of them predicted twice
    (compound).  The mask and R are drawn last, so the other inputs do
    not depend on them."""
    chunks = chunks or MC_CHUNKS
    pha, pwa = ha + pad[0], wa + pad[1]
    n_pool = n_streams + (n_streams > 1)
    pool = rng.integers(0, 1 << bd, (8 * n_pool, 3, pha, pwa)).astype(
        np.int32)
    crop = np.stack([rng.integers(max(8, pha // 2), pha + 1, 8 * n_pool),
                     rng.integers(max(8, pwa // 2), pwa + 1, 8 * n_pool)], 1)
    region = [(ha, wa), (ha >> ss[1], wa >> ss[0]), (ha >> ss[1], wa >> ss[0])]
    active = rng.permutation(n_pool)[:n_streams].astype(np.int16)
    F = rng.integers(0, 1 << bd, (3 * n_streams, ha, wa)).astype(np.int32)

    def hdr(rng, s, p, width):
        """A chunk header of stream s for plane p: a random slot, its
        plane's crop, random words the port does not read."""
        h = rng.integers(-32768, 32768, width).astype(np.int16)
        slot = int(rng.integers(0, 8))
        h[0], h[1] = slot, p
        if width == 8:
            cw, chh = crop[8 * s + slot, 1], crop[8 * s + slot, 0]
            h[3] = (cw + ss[0]) >> ss[0] if p else cw
            h[4] = (chh + ss[1]) >> ss[1] if p else chh
        return h

    per_stream = []
    for k in range(n_streams):
        s = int(active[k])
        segs = {}
        for (w, _, _), ch in zip(MC_SLOTS, chunks):
            n_t = int(rng.integers(4, 40))
            tiles = [(p, int(dy), int(dx))
                     for p in (0, 1, 2)
                     for dy, dx in _tile_grid(rng, w, *region[p], n_t // 3
                                              + (p == 0) * (n_t % 3))]

            def make(rng, group, w=w):
                p = group[0][0]
                d = np.asarray([(dy, dx) for _, dy, dx in group])
                c = (crop[8 * s:8 * s + 8].min(0) >> (ss[::-1] if p
                                                       else (0, 0)))
                y0 = _source(rng, d[:, 0], w, int(c[0]))
                x0 = _source(rng, d[:, 1], w, int(c[1]))
                r = np.zeros((len(group), 4), np.int64)
                r[:, 0] = d[:, 1] | rng.integers(0, 4, len(group)) << 13
                r[:, 1] = d[:, 0] + 1
                r[:, 2] = (y0 - d[:, 0]) << 4 | rng.integers(0, 16,
                                                             len(group))
                r[:, 3] = (x0 - d[:, 1]) << 4 | rng.integers(0, 16,
                                                             len(group))
                return r.astype(np.int16)

            first, fp = _chunks(rng, tiles, ch, make)
            seconds = [tiles[i] for i in rng.permutation(len(tiles))[
                :len(tiles) // 3]]
            second, sp = _chunks(rng, seconds, ch, make)
            if w == 8:                           # an all-zero chunk
                first.append(np.zeros((ch, 4), np.int16))
                fp.append(0)
            recs = first + second
            hdrs = [hdr(rng, s, p, 8) for p in fp + sp]
            segs[w] = (np.stack(recs), np.stack(hdrs), len(recs), len(first))
        if scaled and k == 0:
            n_t = int(rng.integers(8, 40))
            tiles = [(p, int(dy), int(dx)) for p in (0, 1, 2)
                     for dy, dx in _tile_grid(rng, 4, *region[p], n_t // 3)]

            def make_s(rng, group):
                p = group[0][0]
                n = len(group)
                c = crop[8 * s:8 * s + 8].min(0) >> (1 if p else 0)
                r = rng.integers(-32768, 32768, (n, 16))
                r[:, 0] = p
                r[:, 1] = [dx for _, _, dx in group]
                r[:, 2] = [dy + 1 for _, dy, _ in group]
                r[:, 4] = rng.integers(-20, c[1] + 12, n)
                r[:, 5] = rng.integers(-20, c[0] + 12, n)
                r[:, 6:8] = rng.integers(0, 16, (n, 2))
                r[:, 8] = rng.integers(0, 4, n)
                r[:, 9], r[:, 10] = c[1], c[0]
                r[:, 12:14] = rng.integers(8, 33, (n, 2))
                return r.astype(np.int16)

            first, fp = _chunks(rng, tiles, chunks[4], make_s)
            seconds = [tiles[i] for i in rng.permutation(len(tiles))[
                :len(tiles) // 3]]
            second, sp = _chunks(rng, seconds, chunks[4], make_s)
            segs["s"] = (np.stack(first + second),
                         np.stack([hdr(rng, s, p, 4) for p in fp + sp]),
                         len(first) + len(second), len(first))
        per_stream.append(segs)

    # the flats: misc, then each class's records and headers at the most
    # chunks of any stream plus one, zero past a stream's own
    layout, off = {"misc": (0, (48,))}, 48
    for (w, _, _), ch in zip(MC_SLOTS, chunks):
        cap = max(st[w][2] for st in per_stream) + 1
        layout[f"mc{w}"] = (off, (cap, ch, 4))
        off += cap * ch * 4
        layout[f"mc{w}h"] = (off, (cap, 8))
        off += cap * 8
    if scaled:
        cap = per_stream[0]["s"][2] + 1
        layout["mcs"] = (off, (cap, chunks[4], 16))
        off += cap * chunks[4] * 16
        layout["mcsh"] = (off, (cap, 4))
        off += cap * 4
    mi_rows, mi_cols = ha // 8, wa // 8 - 1
    layout["mi_mask"] = (off, (mi_rows, -(-mi_cols // 16)))
    off += mi_rows * -(-mi_cols // 16)
    flats = np.zeros((n_streams, off + 40), np.int16)
    for k, st in enumerate(per_stream):
        misc = flats[k, :48]
        for w, ns, rs in MC_SLOTS:
            rec, hd, n, n0 = st[w]
            for name, a in ((f"mc{w}", rec), (f"mc{w}h", hd)):
                o = layout[name][0]
                flats[k, o:o + a.size] = a.reshape(-1)
            misc[ns], misc[rs] = n, n0
        if "s" in st:
            rec, hd, n, n0 = st["s"]
            for name, a in (("mcs", rec), ("mcsh", hd)):
                o = layout[name][0]
                flats[k, o:o + a.size] = a.reshape(-1)
            misc[14], misc[15] = n, n0
    o, shape = layout["mi_mask"]
    flats[:, o:o + shape[0] * shape[1]] = rng.integers(
        -32768, 32768, (n_streams, shape[0] * shape[1]))
    R = rng.integers(-(1 << bd), 1 << bd, F.shape).astype(np.int32)
    return SimpleNamespace(pool=pool, F=F, R=R, flats=flats, segs=layout,
                           active=active, misc=flats[:, :48].astype(np.int64),
                           bd=bd, ss=tuple(ss), ha=ha, wa=wa,
                           mi_cols=mi_cols)
