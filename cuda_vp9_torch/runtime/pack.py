"""Host packer: FramePlan -> ONE flat int16 tensor for the fused step.

Everything the fused frame step consumes (coefficients, MC tiles, intra
chunks, loop-filter masks, scalars) is packed into a single flat int16
buffer with a layout that is static per (frame geometry, cap tier), so a
frame costs exactly one host->device transfer.  Capacities come in two
tiers:

  "full"  — worst-case (used for intra-only frames: all-intra, all
            coefficients possible, no MC),
  "tight" — sized for typical inter frames; pack_frame returns None on
            overflow and the caller falls back to the host oracle for
            that frame (bit-exact either way).

Values all fit int16: pixel coordinates < 2^13, dequantized coefficients
are range-checked (overflow -> fallback), pad marker is -32768 which
survives the device-side int32 cast and lands far out of range so padded
work drops at scatter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import models as M
from ..decoder import constants as C
from . import lfmeta
from . import plan as planlib

CHUNK_INTRA = 64
CHUNK_MC4 = 256
CHUNK_MC8 = 128
CHUNK_MC16 = 64
CHUNK_MC32 = 32
CHUNK_MCS = 128   # scaled-reference 4x4 tiles (16-wide records)


def mc_chunks(mi_rows: int, mi_cols: int):
    """Per-geometry MC chunk lengths (mc4, mc8, mc16, mc32).

    The fused step's MC cost at HD/4K is dominated by the NUMBER of
    sequential fori_loop iterations (each pays a small-kernel floor), not
    by FLOPs: a typical 1080p frame has ~12k 16x16 tiles = ~190 chunks
    of 64.  HD+ geometries use 4x larger chunks — same total work in a
    quarter of the iterations, and the per-chunk matmuls get 4x larger
    (better MXU occupancy).  Partial-chunk padding stays cheap: zero
    pages are elided from the upload."""
    if mi_rows * mi_cols * 64 >= 1.9e6:     # >= ~1080p pixel count
        return CHUNK_MC4 * 4, CHUNK_MC8 * 4, CHUNK_MC16 * 4, CHUNK_MC32 * 4
    return CHUNK_MC4, CHUNK_MC8, CHUNK_MC16, CHUNK_MC32


def band_params(ha, ts=16):
    """Row-band geometry for the banded MC kernel: each MC chunk reads
    one [BR, wa] band of one (slot, plane) canvas (see fused._mc_chunk).
    The row margin after the grouping stride covers the tile class's
    read span (h + 7 taps + 3 sub-rmin rows): 24 suffices for <= 16-tall
    tiles; the 32-tall class groups with a 40-row margin."""
    br = min(160, ha)
    return br, br - (40 if ts == 32 else 24)

_INTRA_MODE_TO_TX_TYPE = np.array(
    [0, 1, 2, 0, 3, 1, 2, 2, 1, 3], np.int32)

NEED_LEFT = 1 << 1
NEED_ABOVE = 1 << 2
NEED_ABOVERIGHT = 1 << 3
EXTEND = np.array([NEED_ABOVE | NEED_LEFT, NEED_ABOVE, NEED_LEFT,
                   NEED_ABOVERIGHT, NEED_LEFT | NEED_ABOVE,
                   NEED_LEFT | NEED_ABOVE, NEED_LEFT | NEED_ABOVE,
                   NEED_LEFT, NEED_ABOVERIGHT, NEED_LEFT | NEED_ABOVE],
                  np.int32)


def cdiv(a, b):
    return (a + b - 1) // b


# Coefficient buckets: (name, tx_size, shipped coeff count).  Units
# ship only their first-N scan-order coefficients when eob allows
# (N < n*n), spilling to the next-larger bucket of the same tx size
# when a bucket fills.  The sub-16-coefficient buckets exist because
# real streams are eob-light (measured on the bench stream: median eob
# 1-4 in every sparse class) — they cut the shipped coefficient bytes
# ~4x, and the host->device link is the decode bottleneck.
COEFF_BUCKETS = (
    ("tx0s", 0, 4), ("tx0", 0, 16),
    ("tx1s", 1, 8), ("tx1m", 1, 24), ("tx1", 1, 64),
    ("tx2xs", 2, 16), ("tx2s", 2, 64), ("tx2d", 2, 256),
    ("tx3xs", 3, 16), ("tx3s", 3, 64), ("tx3m", 3, 256), ("tx3d", 3, 1024),
)

# Chunk length per coeff bucket: the fused step runs the inverse
# transforms in a fori_loop over chunks with a TRACED trip count
# (misc[MISC_TRIP[name]]), so per-frame transform cost tracks actual
# content instead of the bucket capacity.  Caps round up to a chunk
# multiple.
COEFF_CHUNK = {"tx0s": 1024, "tx0": 1024, "tx1s": 256, "tx1m": 256,
               "tx1": 256, "tx2xs": 128, "tx2s": 128, "tx2d": 64,
               "tx3xs": 128, "tx3s": 64, "tx3m": 32, "tx3d": 16}

# misc[] slot carrying each bucket's residual-loop trip count (16..22
# are the original seven; 23-25 hold the mc n_ref0 counts, so the
# sub-buckets take 26..29)
MISC_TRIP = {"tx0": 16, "tx1": 17, "tx2s": 18, "tx2d": 19,
             "tx3s": 20, "tx3m": 21, "tx3d": 22,
             "tx0s": 26, "tx1s": 27, "tx2xs": 28, "tx3xs": 29,
             "tx1m": 32}

# 32x32 coo buckets: units whose eob exceeds the prefix buckets but with
# few NONZERO coefficients (high-eob 32x32 units are overwhelmingly
# sparse inside) ship as interleaved (raster_idx, value) pairs instead
# of a coefficient row.  Two granularities: tx3cs takes any eob > 16
# with <= 16 nonzeros (64 B vs the 128 B tx3s prefix row — measured the
# single largest 1080p upload segment), tx3c takes eob > 64 with <= 64
# nonzeros (256 B vs the 2 KB tx3d row).  8-bit only (highbd values
# exceed int16; tx3s/tx3m/tx3d absorb those as before).
COO_PAIRS = 64
CHUNK_TX3C = 16
MISC_TRIP_TX3C = 30
COO16_PAIRS = 16
CHUNK_TX3CS = 64
MISC_TRIP_TX3CS = 31

last_overflow = None  # (segment, needed, cap) of the most recent fallback


def _note_overflow(seg, needed, cap):
    global last_overflow
    last_overflow = (seg, needed, cap)


def compute_caps(mi_rows: int, mi_cols: int, tier: str,
                 lossless: bool = False,
                 pool_ha: int | None = None,
                 ss: tuple = (1, 1)) -> Dict[str, int]:
    ssx, ssy = ss
    w4, h4 = mi_cols * 2, mi_rows * 2
    cells = w4 * h4          # luma 4x4 blocks
    ccells = (w4 >> ssx) * (h4 >> ssy)   # 4x4 blocks per chroma plane
    total44 = cells + 2 * ccells
    worst = [max(16, total44 >> (2 * t)) for t in range(4)]
    if tier == "scaled":
        # scaled-reference frames (mid-stream resize / SVC inter-layer):
        # the wide tier plus an "mcs" class of 4x4 tiles with per-column
        # subpel stepping (vp9_scale.c / vpx_scaled_2d parity).  Worst
        # case: every 4x4 cell compound-predicted from scaled refs.
        caps = compute_caps(mi_rows, mi_cols, "wide", lossless, pool_ha,
                            ss)
        caps["tier"] = "scaled"
        pha = pool_ha or ((mi_rows + 7) & ~7) * 8
        br, stride = band_params(pha)
        groups = 2 * 3 * 3 * ((pha - 1) // stride + 1)
        caps["mcs"] = cdiv(total44 * 2, CHUNK_MCS) + groups
        return caps
    caps = {"tier": tier}
    if tier == "full":
        # intra-only frames must NEVER overflow: worst-case everywhere
        # (sparse buckets stay tiny; dense buckets take the worst case)
        caps["tx0s"] = worst[0]
        caps["tx0"] = worst[0]
        caps["tx1s"] = max(64, worst[1] >> 1)
        caps["tx1m"] = max(64, worst[1] >> 1)
        caps["tx1"] = worst[1]
        caps["tx2xs"] = max(8, worst[2] >> 3)
        caps["tx2s"] = max(8, worst[2] >> 3)
        caps["tx2d"] = worst[2]
        caps["tx3xs"] = max(8, worst[3] >> 3)
        caps["tx3s"] = max(8, worst[3] >> 3)
        caps["tx3m"] = max(8, worst[3] >> 2)
        caps["tx3d"] = worst[3]
        caps["tx3c"] = max(16, worst[3] >> 2)
        caps["tx3cs"] = max(16, worst[3] >> 1)
        caps["mc4"] = caps["mc8"] = caps["mc16"] = caps["mc32"] = 1
        max_waves = w4 + h4 + 2
        # HD+ keyframes: 4x larger intra chunks (the wavefront loop's
        # iteration count, not its FLOPs, bounds keyframe step time)
        ich = CHUNK_INTRA * 4 if mi_rows * mi_cols * 64 >= 1.9e6 \
            else CHUNK_INTRA
        caps["intra_chunk"] = ich
        caps["intra"] = cdiv(total44, ich) + 4 * max_waves
    else:
        m4_worst = (cells + 2 * ccells) * 2
        m8_worst = (cells // 4 + 2 * (ccells // 4)) * 2
        m16_worst = (cells // 16 + 2 * (ccells // 16)) * 2
        m32_worst = (cells // 64 + 2 * (ccells // 64)) * 2
        # chunks are (slot, plane, row-band)-homogeneous: add group slack.
        # Slack is sized from the FRAME canvas; with an enlarged pool
        # (scaled refs) the band count can exceed it — a pack that then
        # overflows falls back to the host oracle, still bit-exact.
        ha = ((mi_rows + 7) & ~7) * 8
        br, stride = band_params(ha)
        groups = 2 * 3 * 3 * ((ha - 1) // stride + 1)  # avg x slot x plane
        _, stride32 = band_params(ha, 32)
        groups32 = 2 * 3 * 3 * ((ha - 1) // stride32 + 1)
        c4, c8, c16, c32 = mc_chunks(mi_rows, mi_cols)
        caps["mc_chunk"] = (c4, c8, c16, c32)
        if tier == "wide":
            # escalation tier for frames that overflow "tight": 3x the
            # typical-case budget, bounded by the worst case.  Full
            # worst-case capacities at 4K make a ~0.5 GB program that
            # the compiler chokes on (>50 min; this tier compiles in
            # ~70 s); 3x covers every dense frame seen in practice, and
            # truly pathological frames still decode bit-exact on the
            # host oracle.
            caps["tx0s"] = min(worst[0], max(64, worst[0] * 9 // 8))
            caps["tx0"] = min(worst[0], max(64, worst[0] * 9 // 8))
            caps["tx1s"] = min(worst[1], max(64, worst[1] * 3 // 2))
            caps["tx1m"] = min(worst[1], max(64, worst[1] * 3 // 2))
            caps["tx1"] = min(worst[1], max(64, worst[1] * 3 // 2))
            caps["tx2xs"] = min(worst[2], max(64, worst[2] * 3 // 2))
            caps["tx2s"] = min(worst[2], max(64, worst[2] * 3 // 2))
            caps["tx2d"] = min(worst[2], max(16, worst[2] * 3 // 4))
            caps["tx3xs"] = worst[3]
            caps["tx3s"] = worst[3]
            caps["tx3m"] = min(worst[3], max(8, worst[3] * 3 // 4))
            caps["tx3d"] = min(worst[3], max(16, worst[3] * 3 // 4))
            caps["tx3c"] = min(worst[3], max(16, worst[3] * 3 // 4))
            caps["tx3cs"] = worst[3]
            caps["mc4"] = max(1, cdiv(m4_worst * 3 // 4, c4) + groups)
            caps["mc8"] = max(1, cdiv(m8_worst * 3 // 4, c8) + groups)
            caps["mc16"] = max(1, cdiv(m16_worst, c16) + groups)
            caps["mc32"] = max(1, cdiv(m32_worst, c32) + groups32)
            ich = CHUNK_INTRA * 4 if mi_rows * mi_cols * 64 >= 1.9e6 \
                else CHUNK_INTRA
            caps["intra_chunk"] = ich
            caps["intra"] = cdiv(total44 * 3 // 4, ich) + 256
        else:
            caps["tx0s"] = max(64, worst[0] * 3 // 8)
            caps["tx0"] = worst[0] if lossless else max(64, worst[0] * 3 // 8)
            caps["tx1s"] = max(64, worst[1] >> 1)
            caps["tx1m"] = max(64, worst[1] >> 1)
            caps["tx1"] = max(64, worst[1] >> 1)
            caps["tx2xs"] = max(64, worst[2] >> 1)
            caps["tx2s"] = max(64, worst[2] >> 1)
            caps["tx2d"] = max(16, worst[2] >> 2)
            caps["tx3xs"] = worst[3]
            caps["tx3s"] = worst[3]
            caps["tx3m"] = max(8, worst[3] >> 2)
            caps["tx3d"] = max(16, worst[3] >> 2)
            caps["tx3c"] = max(16, worst[3] >> 2)
            caps["tx3cs"] = max(16, worst[3] * 3 // 4)
            caps["mc4"] = max(1, cdiv(m4_worst * 3 // 8, c4) + groups)
            caps["mc8"] = max(1, cdiv(m8_worst // 2, c8) + groups)
            caps["mc16"] = max(1, cdiv(m16_worst, c16) + groups)
            caps["mc32"] = max(1, cdiv(m32_worst, c32) + groups32)
            # inter frames carry few intra blocks scattered across
            # many (wave, size-class) chunk boundaries: a 16-unit chunk
            # cuts the partial-chunk upload waste ~4x (keyframes use
            # the full/wide tiers and keep the wider chunks).  HD+ uses
            # 64: there the intra pass is iteration-count-bound
            # (~140 us/chunk floor, measured at 1080p) and the intra
            # segment is a tiny upload share.
            ich = 64 if mi_rows * mi_cols * 64 >= 1.9e6 else 16
            caps["intra_chunk"] = ich
            caps["intra"] = cdiv(total44 // 4, ich) + 128
    for name, ch in COEFF_CHUNK.items():
        if name in caps:
            caps[name] = cdiv(caps[name], ch) * ch
    if "tx3c" in caps:
        caps["tx3c"] = cdiv(caps["tx3c"], CHUNK_TX3C) * CHUNK_TX3C
    if "tx3cs" in caps:
        caps["tx3cs"] = cdiv(caps["tx3cs"], CHUNK_TX3CS) * CHUNK_TX3CS
    return caps


class FlatLayout:
    """Named segments inside one flat int16 buffer (static per geometry)."""

    def __init__(self):
        self.segs: Dict[str, tuple] = {}
        self.size = 0

    def add(self, name, shape):
        n = int(np.prod(shape))
        self.segs[name] = (self.size, tuple(shape))
        self.size += n

    def view(self, buf, name):
        off, shape = self.segs[name]
        return buf[off:off + int(np.prod(shape))].reshape(shape)


def build_layout(caps, mi_rows, mi_cols, lossless, bd: int = 8,
                 ss: tuple = (1, 1)) -> FlatLayout:
    L = FlatLayout()
    for name, t, ncoef in COEFF_BUCKETS:
        if lossless and name != "tx0":
            continue
        L.add(f"coeff_{name}", (caps[name], ncoef))
        if bd > 8:
            # high-bit-depth dequantized coefficients exceed int16: ship
            # as (lo, hi) with lo = v - (hi << 15) in [0, 0x7FFF],
            # hi = v >> 15 (arithmetic); the step rebuilds v in int32
            L.add(f"coeffh_{name}", (caps[name], ncoef))
        L.add(f"cpos_{name}", (caps[name], 4))
    if not lossless and bd == 8 and "tx3c" in caps:
        # interleaved (raster_idx, value) pairs; see COO_PAIRS above
        L.add("coeff_tx3c", (caps["tx3c"], 2 * COO_PAIRS))
        L.add("cpos_tx3c", (caps["tx3c"], 4))
        L.add("coeff_tx3cs", (caps["tx3cs"], 2 * COO16_PAIRS))
        L.add("cpos_tx3cs", (caps["tx3cs"], 4))
    # MC tile wire rows are 4 int16: (dx | filt<<13, dy+1, sr, sc) with
    # sr/sc = ((src - dst) << 4) | subpel_q4 and dx < 2^13; everything
    # chunk-constant (slot, plane, srow band, ref crop dims) lives in
    # the 8-wide chunk header instead — a tile is 8 wire bytes
    c4, c8, c16, c32 = caps.get(
        "mc_chunk", (CHUNK_MC4, CHUNK_MC8, CHUNK_MC16, CHUNK_MC32))
    L.add("mc4", (caps["mc4"], c4, 4))
    L.add("mc8", (caps["mc8"], c8, 4))
    L.add("mc16", (caps["mc16"], c16, 4))
    L.add("mc32", (caps.get("mc32", 1), c32, 4))
    L.add("mc4h", (caps["mc4"], 8))
    L.add("mc8h", (caps["mc8"], 8))
    L.add("mc16h", (caps["mc16"], 8))
    L.add("mc32h", (caps.get("mc32", 1), 8))
    if "mcs" in caps:
        # scaled-reference 4x4 tiles: [.., 12] classic fields plus
        # (xs, ys) step_q4 and 2 pad columns
        L.add("mcs", (caps["mcs"], CHUNK_MCS, 16))
        L.add("mcsh", (caps["mcs"], 4))
    # intra units ship bit-packed: 4 int16 words per unit (50 bits of
    # fields — see fused._intra_chunk for the word layout); at 18 wire
    # bytes/unit the intra segment dominated keyframe uploads (3.5 MB of
    # an 8 MB 4K keyframe), packed it is 8 bytes/unit
    L.add("intra", (caps["intra"], caps.get("intra_chunk", CHUNK_INTRA),
                    4))
    L.add("chunk_bs", (caps["intra"],))
    # inter-residual mask, bit-packed 16 mi cells per int16 (the mask
    # is dense-ish, so at int16-per-cell it was a fixed ~7 KB/frame of
    # upload at SD; packed it is ~0.5 KB)
    L.add("mi_mask", (mi_rows, cdiv(mi_cols, 16)))
    # packed loop-filter metadata for the loop-filter kernel
    # (lfmeta.pack_lfm_fields layout)
    LF_K = lfmeta.K
    sb_rows, sb_cols = cdiv(mi_rows, 8), cdiv(mi_cols, 8)
    n_sbs_pad = cdiv(sb_rows, LF_K) * LF_K * sb_cols
    L.add("lfm", (n_sbs_pad, 2, 128))
    L.add("lf_thr", (64, 4))
    if ss == (0, 0):
        # 4:4:4 chroma deblocks through the kernel's LUMA path on the
        # chroma plane's own geometry (fused.make_frame_step); this is
        # its mask tensor, luma-format, chroma cell grid
        rc, cc = cdiv(mi_rows, 1 << ss[1]), cdiv(mi_cols, 1 << ss[0])
        sbr_c, sbc_c = cdiv(rc, 8), cdiv(cc, 8)
        L.add("lfm_c", (cdiv(sbr_c, LF_K) * LF_K * sbc_c, 2, 128))
    elif ss != (1, 1):
        # 4:2:2 and 4:4:0 chroma: VP9 deblocks it per LUMA superblock, in
        # 32x64 (4:2:2) or 64x32 (4:4:0) pixel slices, an order the 64-px
        # kernel cannot express — the sequential-tile path
        # (ops/device/lf_wave.py) replays it with per-cell mask bitfields
        # + threshold maps on the chroma plane's own cell grid
        ha_ = ((mi_rows + 7) & ~7) * 8
        wa_ = ((mi_cols + 7) & ~7) * 8
        cr, ccc = (ha_ >> ss[1]) // 8, (wa_ >> ss[0]) // 8
        for nm in ("lfw_v", "lfw_h", "lfw_mb", "lfw_lm", "lfw_hv"):
            L.add(nm, (cr, ccc))
    L.add("misc", (48,))
    return L


_SCAN_PREFIX = {}


def scan_prefix(t, ncoef):
    """[4, ncoef] first-ncoef scan indices for each tx_type."""
    key = (t, ncoef)
    if key not in _SCAN_PREFIX:
        _SCAN_PREFIX[key] = np.stack([
            M.SCAN_ORDERS[t][tt].scan[:ncoef] for tt in range(4)])
    return _SCAN_PREFIX[key]


def _pack_coeffs(plan, caps, layout, buf, lossless, bd=8):
    mi = plan.mi
    ssx = plan.hdr.subsampling_x
    ssy = plan.hdr.subsampling_y
    # gather all coded transform units across planes
    U = {"plane": [], "y": [], "x": [], "off": [], "tt": [], "eob": [],
         "tx": []}
    for plane in range(3):
        eob_map = plan.eob_maps[plane]
        off = plan.coeff_off_maps[plane]
        ys, xs = np.nonzero(eob_map > 0)
        if len(ys) == 0:
            continue
        if plane:
            # chroma 4x4 unit (ys, xs) -> mi cell (plane px * 2^ss / 8)
            mi_r = np.minimum(ys >> (1 - ssy), mi.mi_rows - 1)
            mi_c = np.minimum(xs >> (1 - ssx), mi.mi_cols - 1)
        else:
            mi_r = ys >> 1
            mi_c = xs >> 1
        bsize = mi.sb_type[mi_r, mi_c].astype(np.int32)
        tx_y = mi.tx_size[mi_r, mi_c].astype(np.int32)
        if plane:
            tx = M.UV_TXSIZE_LOOKUP[bsize, tx_y, ssx, ssy]
            tt = np.zeros_like(tx)
        else:
            tx = tx_y
            if lossless:
                tt = np.zeros_like(tx)
            else:
                inter = mi.ref[mi_r, mi_c, 0] > C.INTRA_FRAME
                sub = ((ys & 1) << 1) | (xs & 1)
                mode_s = mi.bmi_mode[mi_r, mi_c, sub]
                mode_b = mi.mode[mi_r, mi_c]
                mode = np.where(bsize < C.BLOCK_8X8, mode_s, mode_b)
                mode = np.minimum(mode.astype(np.int32), 9)
                tt = np.where(inter, 0,
                              _INTRA_MODE_TO_TX_TYPE[mode]).astype(np.int32)
        tt = np.where(tx == 3, 0, tt)
        U["plane"].append(np.full(len(ys), plane))
        U["y"].append(ys)
        U["x"].append(xs)
        U["off"].append(off[ys, xs])
        U["tt"].append(tt)
        U["eob"].append(eob_map[ys, xs])
        U["tx"].append(tx)
    if U["plane"]:
        A = {k: np.concatenate(v) for k, v in U.items()}
    else:
        A = {k: np.zeros(0, np.int64) for k in U}
    srcs = plan.coeffs

    assigned = np.zeros(len(A["tx"]), bool)
    n_coo = 0
    n_coo_s = 0
    if "coeff_tx3c" in layout.segs:
        # coo pre-pass: 32x32 units past the tx3xs prefix with few
        # nonzero coeffs ship as (raster_idx, value) pairs — tx3cs (16
        # pairs) for nnz <= 16, tx3c (64 pairs) for high-eob nnz <= 64
        # (bucket doc at COO_PAIRS)
        cm3 = layout.view(buf, "coeff_tx3c")
        pm3 = layout.view(buf, "cpos_tx3c")
        cap3 = caps["tx3c"]
        cms = layout.view(buf, "coeff_tx3cs")
        pms = layout.view(buf, "cpos_tx3cs")
        caps_s = caps["tx3cs"]
        cand = np.nonzero((A["tx"] == 3) & (A["eob"] > 16))[0]
        for i in cand:
            if n_coo >= cap3 and n_coo_s >= caps_s:
                break
            vals = srcs[A["plane"][i]][A["off"][i]:A["off"][i] + 1024]
            nz = np.flatnonzero(vals)
            v = vals[nz]
            if np.abs(v).max(initial=0) > 32767:
                continue  # range overflow: dense buckets handle it
            if len(nz) <= COO16_PAIRS and n_coo_s < caps_s:
                cms[n_coo_s, 0:2 * len(nz):2] = nz
                cms[n_coo_s, 1:2 * len(nz):2] = v
                pms[n_coo_s, 0] = A["plane"][i]
                pms[n_coo_s, 1] = A["y"][i] * 4 + 1
                pms[n_coo_s, 2] = A["x"][i] * 4
                pms[n_coo_s, 3] = 0
                assigned[i] = True
                n_coo_s += 1
            elif A["eob"][i] > 64 and len(nz) <= COO_PAIRS \
                    and n_coo < cap3:
                cm3[n_coo, 0:2 * len(nz):2] = nz
                cm3[n_coo, 1:2 * len(nz):2] = v
                pm3[n_coo, 0] = A["plane"][i]
                pm3[n_coo, 1] = A["y"][i] * 4 + 1
                pm3[n_coo, 2] = A["x"][i] * 4
                pm3[n_coo, 3] = 0  # tx3 is always DCT
                assigned[i] = True
                n_coo += 1
    counts = []
    for name, t, ncoef in COEFF_BUCKETS:
        if lossless and name != "tx0":
            counts.append(0)
            continue  # non-tx0 units would be caught by the final check
        full = ncoef == (4 << t) * (4 << t)
        elig = (A["tx"] == t) & ~assigned
        if not full:
            elig &= A["eob"] <= ncoef
        idx = np.nonzero(elig)[0]
        cap = caps[name]
        if full and len(idx) > cap:
            _note_overflow(name, len(idx), cap)
            return None
        idx = idx[:cap]  # excess spills to the next (larger) bucket
        assigned[idx] = True
        counts.append(len(idx))
        cm = layout.view(buf, f"coeff_{name}")
        pm = layout.view(buf, f"cpos_{name}")
        if len(idx) == 0:
            continue
        offs = A["off"][idx]
        tts = A["tt"][idx].astype(np.int64)
        if full:
            gidx = offs[:, None] + np.arange(ncoef)[None, :]
        else:
            gidx = offs[:, None] + scan_prefix(t, ncoef)[tts]
        # gather per plane (coeff buffers are separate per plane)
        pl = A["plane"][idx]
        vals = np.empty((len(idx), ncoef), np.int64)
        for pp in range(3):
            s = pl == pp
            if s.any():
                vals[s] = srcs[pp][gidx[s]]
        if bd > 8:
            # split into (lo in [0, 0x7FFF], hi = v >> 15); the step
            # rebuilds v = (hi << 15) + lo in int32
            hi = vals >> 15
            cmh = layout.view(buf, f"coeffh_{name}")
            cmh[:len(idx)] = hi
            cm[:len(idx)] = vals - (hi << 15)
        elif np.abs(vals).max(initial=0) > 32767:
            _note_overflow("coeff_range", 0, 0)
            return None
        else:
            cm[:len(idx)] = vals
        pm[:len(idx), 0] = pl
        # y is stored +1 so a zero entry means "inactive" and all-zero
        # pages can be elided from the host->device transfer
        pm[:len(idx), 1] = A["y"][idx] * 4 + 1
        pm[:len(idx), 2] = A["x"][idx] * 4
        pm[:len(idx), 3] = tts
    if not assigned.all():
        _note_overflow("coeff_unassigned", int((~assigned).sum()), 0)
        return None
    counts.append(n_coo)    # coo bucket counts ride last
    counts.append(n_coo_s)
    return counts


def _blocks_arr(plan):
    arr = getattr(plan, "blocks_arr", None)
    if arr is None:
        arr = np.array([[b.mi_row, b.mi_col, b.bsize, b.bwl, b.bhl]
                        for b in plan.blocks], np.int32).reshape(-1, 5)
    return arr


def _round_q4(v):
    q = np.where(v >= 0, v + 2, v - 2)
    return np.where(q >= 0, q // 4, -((-q) // 4))


def _round_q2(v):
    q = np.where(v >= 0, v + 1, v - 1)
    return np.where(q >= 0, q // 2, -((-q) // 2))


def split_mv(bmv, j, sx: int, sy: int):
    """The MVs [n, 2] of 4x4 block j of a plane with subsampling (sx, sy)
    in sub-8x8 blocks whose four luma MVs are bmv [n, 4, 2]
    (average_split_mvs, vp9_reconinter.c:112): direct at 4:4:4 and on
    luma, the x-pair average at 4:2:2, the y-pair average at 4:4:0, the
    4-way average at 4:2:0.  j is the PLANE-raster index (the reference
    calls average_split_mvs with i = y * n4w + x per plane), so at 4:2:2
    chroma block 1 averages luma blocks 1 and 2: a normative quirk (see
    ops/ref/recon.py:222).  The scaled and the unscaled branches of
    `_mc_tiles_vectorized` both take it."""
    if not (sx or sy):
        return bmv[:, j]
    if sx and sy:
        return _round_q4(bmv.sum(axis=1))
    return _round_q2(bmv[:, j] + bmv[:, j + (1 if sx else 2)])


def _mc_tiles_vectorized(plan, refs, slot_map):
    """Emit MC tile rows [n, 12] per tile class, vectorized over blocks
    (dec_build_inter_predictors parity).  Sub-8x8 blocks (split MVs with
    averaged chroma) go through the per-block reference path.  Blocks
    predicting from a SCALED reference (vp9_scale.c: ref dims differ
    from the frame) route to the "mcs" class of 4x4 tiles with q4 step
    fields — including the partner reference of a compound block whose
    ref0 is scaled, so the compound average always lands after the first
    prediction (the mcs pass runs last in the fused step)."""
    from ..ops.ref import inter as ref_inter
    hdr = plan.hdr
    mi = plan.mi
    ss = (hdr.subsampling_x, hdr.subsampling_y)
    blocks = _blocks_arr(plan)
    out = {4: [], 8: [], 16: [], 32: [], "s": []}
    if not len(blocks):
        return out
    br, bc, bs, bwl, bhl = (blocks[:, i] for i in range(5))
    ref0 = mi.ref[br, bc, 0].astype(np.int32)
    inter = ref0 > C.INTRA_FRAME
    big = bs >= C.BLOCK_8X8
    crop = {}
    for k, rb in refs.items():
        if rb is None:
            continue
        for p in range(3):
            sx = ss[0] if p else 0
            sy = ss[1] if p else 0
            crop[(k - 1, p)] = ((rb.width + sx) >> sx,
                                (rb.height + sy) >> sy)

    # per-ref fixed-point scale factors (vp9_setup_scale_factors_for_frame)
    xfp = np.full(4, 1 << 14, np.int64)
    yfp = np.full(4, 1 << 14, np.int64)
    xstep = np.full(4, 16, np.int64)
    ystep = np.full(4, 16, np.int64)
    issc = np.zeros(4, bool)
    for k, rb in refs.items():
        if rb is None:
            continue
        sf = ref_inter.ScaleFactors(rb.width, rb.height,
                                    hdr.width, hdr.height)
        if sf.is_valid():
            xfp[k], yfp[k] = sf.x_scale_fp, sf.y_scale_fp
            xstep[k], ystep[k] = sf.x_step_q4, sf.y_step_q4
            issc[k] = sf.is_scaled()
    if issc.any():
        r1 = mi.ref[br, bc, 1].astype(np.int64)
        sc0 = inter & issc[np.clip(ref0, 0, 3)]
        sc1 = inter & (r1 > C.INTRA_FRAME) & issc[np.clip(r1, 0, 3)]
    else:
        sc0 = sc1 = np.zeros(len(br), bool)

    # ---- vectorized path: >= 8x8 blocks
    sel0 = inter & big
    if sel0.any():
        compound = mi.ref[br, bc, 1].astype(np.int32) > C.INTRA_FRAME
        filt = mi.interp_filter[br, bc].astype(np.int32)
        for ref_i in range(2):
            sel = (sel0 & ~sc0) if ref_i == 0 \
                else (sel0 & compound & ~sc0 & ~sc1)
            if not sel.any():
                continue
            idx = np.nonzero(sel)[0]
            r, c = br[idx], bc[idx]
            rf = mi.ref[r, c, ref_i].astype(np.int32)
            mv = mi.mv[r, c, ref_i].astype(np.int64)  # [n, 2] (row, col)
            for plane in range(3):
                sx = ss[0] if plane else 0
                sy = ss[1] if plane else 0
                w = (4 << bwl[idx]) >> sx
                h = (4 << bhl[idx]) >> sy
                dx = (c * 8) >> sx
                dy = (r * 8) >> sy
                scol = mv[:, 1] << (1 - sx)
                srow = mv[:, 0] << (1 - sy)
                x0 = dx + (scol >> 4)
                y0 = dy + (srow >> 4)
                spx = scol & 15
                spy = srow & 15
                cwl = np.empty(len(idx), np.int64)
                chl = np.empty(len(idx), np.int64)
                for k in (1, 2, 3):
                    if (k - 1, plane) in crop:
                        m = rf == k
                        cwl[m], chl[m] = crop[(k - 1, plane)]
                rows = np.stack([
                    np.full(len(idx), plane, np.int64), dx, dy + 1,
                    slot_map[rf - 1], x0, y0, spx, spy, filt[idx],
                    cwl, chl, np.full(len(idx), ref_i, np.int64)], axis=1)
                # expand into tiles per (w, h) shape class (sorted: the
                # native C++ packer mirrors this emission order exactly)
                for ww, hh in sorted(set(zip(w.tolist(), h.tolist()))):
                    m = (w == ww) & (h == hh)
                    ts = 32 if (ww >= 32 and hh >= 32) else \
                        16 if (ww >= 16 and hh >= 16) else \
                        8 if (ww >= 8 and hh >= 8) else 4
                    sub = rows[m]
                    ny, nx = hh // ts, ww // ts
                    k = ny * nx
                    rep = np.repeat(sub, k, axis=0)
                    oy, ox = np.meshgrid(np.arange(ny) * ts,
                                         np.arange(nx) * ts, indexing="ij")
                    offs = np.stack([ox.ravel(), oy.ravel()], 1)  # [k, 2]
                    offs = np.tile(offs, (sub.shape[0], 1))
                    rep[:, 1] += offs[:, 0]
                    rep[:, 2] += offs[:, 1]
                    rep[:, 4] += offs[:, 0]
                    rep[:, 5] += offs[:, 1]
                    out[ts].append(rep)

    # ---- sub-8x8 blocks (split MVs), vectorized per (bwl, bhl) combo.
    # Chroma MVs average the covering luma sub-MVs per the plane's
    # subsampling (`split_mv`, with its 4:2:2 quirk; the scaled branch
    # below takes the same rule).
    sel = inter & ~big
    if sel.any():
        idx_all = np.nonzero(sel)[0]
        compound = mi.ref[br, bc, 1].astype(np.int32) > C.INTRA_FRAME
        filt_all = mi.interp_filter[br, bc].astype(np.int64)
        for wl, hl in sorted(set(zip(bwl[idx_all].tolist(),
                                     bhl[idx_all].tolist()))):
            for ref_i in range(2):
                m = sel & (bwl == wl) & (bhl == hl) & ~sc0
                if ref_i:
                    m &= compound & ~sc1
                if not m.any():
                    continue
                idx = np.nonzero(m)[0]
                r, c = br[idx], bc[idx]
                rf = mi.ref[r, c, ref_i].astype(np.int64)
                filt = filt_all[idx]
                bmv = mi.bmi_mv[r, c, :, ref_i].astype(np.int64)  # [n,4,2]
                for plane in range(3):
                    sx = ss[0] if plane else 0
                    sy = ss[1] if plane else 0
                    n4w = (1 << wl) >> sx
                    n4h = (1 << hl) >> sy
                    cwl = np.empty(len(idx), np.int64)
                    chl = np.empty(len(idx), np.int64)
                    for k in (1, 2, 3):
                        if (k - 1, plane) in crop:
                            mk = rf == k
                            cwl[mk], chl[mk] = crop[(k - 1, plane)]
                    for y in range(n4h):
                        for x in range(n4w):
                            mvv = split_mv(bmv, y * n4w + x, sx, sy)
                            dx = ((c * 8) >> sx) + 4 * x
                            dy = ((r * 8) >> sy) + 4 * y
                            scol = mvv[:, 1] << (1 - sx)
                            srow = mvv[:, 0] << (1 - sy)
                            out[4].append(np.stack([
                                np.full(len(idx), plane, np.int64),
                                dx, dy + 1, slot_map[rf - 1],
                                dx + (scol >> 4), dy + (srow >> 4),
                                scol & 15, srow & 15, filt, cwl, chl,
                                np.full(len(idx), ref_i, np.int64)],
                                axis=1))

    # ---- scaled-reference units -> "mcs" 4x4 tiles (per-column q4 step)
    if sc0.any() or sc1.any():
        compound = mi.ref[br, bc, 1].astype(np.int64) > C.INTRA_FRAME
        filt_all = mi.interp_filter[br, bc].astype(np.int64)

        def emit_scaled(idx, ref_i, mv_rc, x_off, y_off, w, h, plane,
                        sx, sy):
            """_mc_unit param derivation (scaled branch per the ref's
            scale factors, unscaled otherwise), vectorized over blocks
            idx for one plane-local unit of (w, h) at (x_off, y_off),
            chopped into 4x4 mcs tiles — per-tile subpel origins advance
            by the q4 step, so tiling composes exactly."""
            r, c = br[idx], bc[idx]
            rf = mi.ref[r, c, ref_i].astype(np.int64)
            sc = issc[np.clip(rf, 0, 3)]
            bwm = (1 << (bwl[idx] - 1)).astype(np.int64)
            bhm = (1 << (bhl[idx] - 1)).astype(np.int64)
            mi_x = c.astype(np.int64) * 8
            mi_y = r.astype(np.int64) * 8
            mb_l = -mi_x * 8
            mb_t = -mi_y * 8
            mb_r = (np.int64(hdr.mi_cols) - bwm - c) * 64
            mb_b = (np.int64(hdr.mi_rows) - bhm - r) * 64
            r4 = mv_rc[:, 0] << (1 - sy)
            c4 = mv_rc[:, 1] << (1 - sx)
            # normative off-frame clamp (dec_build_inter_predictors
            # scaled branch; INTERP_EXTEND=4, SUBPEL_SHIFTS=16)
            spel_l = (4 + w) << 4
            spel_t = (4 + h) << 4
            # max(lo, min(hi, v)) — NOT np.clip: when an edge-clipped
            # block makes lo > hi the normative result is lo
            r4s = np.maximum(mb_t * (1 << (1 - sy)) - spel_t,
                             np.minimum(mb_b * (1 << (1 - sy))
                                        + (spel_t - 16), r4))
            c4s = np.maximum(mb_l * (1 << (1 - sx)) - spel_l,
                             np.minimum(mb_r * (1 << (1 - sx))
                                        + (spel_l - 16), c4))
            x_start = (-mb_l) >> (3 + sx)
            y_start = (-mb_t) >> (3 + sy)
            fxp, fyp = xfp[rf], yfp[rf]
            x0s = ((x_start + x_off) * fxp) >> 14
            y0s = ((y_start + y_off) * fyp) >> 14
            # vp9_scale_mv: scaled MV plus the block-position q4 offset
            scol_s = ((c4s * fxp) >> 14) + \
                ((((mi_x + x_off) << 4) * fxp >> 14) & 15)
            srow_s = ((r4s * fyp) >> 14) + \
                ((((mi_y + y_off) << 4) * fyp >> 14) & 15)
            x0 = np.where(sc, x0s, x_start + x_off)
            y0 = np.where(sc, y0s, y_start + y_off)
            scol = np.where(sc, scol_s, c4)
            srow = np.where(sc, srow_s, r4)
            spx = scol & 15
            spy = srow & 15
            x0 = x0 + (scol >> 4)
            y0 = y0 + (srow >> 4)
            xs = np.where(sc, xstep[rf], 16)
            ys = np.where(sc, ystep[rf], 16)
            dx = (mi_x >> sx) + x_off
            dy = (mi_y >> sy) + y_off
            cwl = np.ones(len(idx), np.int64)
            chl = np.ones(len(idx), np.int64)
            for k in (1, 2, 3):
                if (k - 1, plane) in crop:
                    mk = rf == k
                    cwl[mk], chl[mk] = crop[(k - 1, plane)]
            zero = np.zeros(len(idx), np.int64)
            for ty in range(h // 4):
                for tx in range(w // 4):
                    dqx = spx + 4 * tx * xs
                    dqy = spy + 4 * ty * ys
                    out["s"].append(np.stack([
                        np.full(len(idx), plane, np.int64),
                        dx + 4 * tx, dy + 4 * ty + 1, slot_map[rf - 1],
                        x0 + (dqx >> 4), y0 + (dqy >> 4),
                        dqx & 15, dqy & 15, filt_all[idx], cwl, chl,
                        np.full(len(idx), ref_i, np.int64),
                        xs, ys, zero, zero], axis=1))

        for ref_i in range(2):
            mbase = sc0 if ref_i == 0 else (compound & (sc0 | sc1))
            mb_big = inter & big & mbase
            if mb_big.any():
                for wl, hl in sorted(set(zip(bwl[mb_big].tolist(),
                                             bhl[mb_big].tolist()))):
                    mm = mb_big & (bwl == wl) & (bhl == hl)
                    idx = np.nonzero(mm)[0]
                    mv = mi.mv[br[idx], bc[idx], ref_i].astype(np.int64)
                    for plane in range(3):
                        sx = ss[0] if plane else 0
                        sy = ss[1] if plane else 0
                        emit_scaled(idx, ref_i, mv, 0, 0,
                                    (4 << wl) >> sx, (4 << hl) >> sy,
                                    plane, sx, sy)
            mb_sub = inter & ~big & mbase
            if mb_sub.any():
                for wl, hl in sorted(set(zip(bwl[mb_sub].tolist(),
                                             bhl[mb_sub].tolist()))):
                    mm = mb_sub & (bwl == wl) & (bhl == hl)
                    idx = np.nonzero(mm)[0]
                    bmv = mi.bmi_mv[br[idx], bc[idx], :, ref_i] \
                        .astype(np.int64)
                    for plane in range(3):
                        sx = ss[0] if plane else 0
                        sy = ss[1] if plane else 0
                        n4w = (1 << wl) >> sx
                        n4h = (1 << hl) >> sy
                        for y in range(n4h):
                            for x in range(n4w):
                                mvv = split_mv(bmv, y * n4w + x, sx, sy)
                                emit_scaled(idx, ref_i, mvv, 4 * x, 4 * y,
                                            4, 4, plane, sx, sy)
    return out


def _pack_mc(plan, refs, caps, layout, buf, pool_ha=None):
    hdr = plan.hdr
    slot_map = np.asarray(hdr.ref_frame_idx, np.int64)
    groups_np = _mc_tiles_vectorized(plan, refs, slot_map)
    tiles = {}
    for ts in (4, 8, 16, 32, "s"):
        tiles[ts] = np.concatenate(groups_np[ts]) if groups_np[ts] \
            else np.zeros((0, 16 if ts == "s" else 12), np.int64)
    if tiles["s"].shape[0] and "mcs" not in layout.segs:
        # scaled-reference tiles need the "scaled" cap tier
        _note_overflow("mcs", tiles["s"].shape[0], 0)
        return None
    # band range spans the POOL canvas (refs can be larger than the
    # frame when scaled references are in play)
    ha = pool_ha or ((hdr.mi_rows + 7) & ~7) * 8
    br, stride = band_params(ha)
    nums = []
    nums_ref0 = []
    c4, c8, c16, c32 = caps.get(
        "mc_chunk", (CHUNK_MC4, CHUNK_MC8, CHUNK_MC16, CHUNK_MC32))
    classes = [(4, c4, "mc4"), (8, c8, "mc8"), (16, c16, "mc16"),
               (32, c32, "mc32")]
    if "mcs" in layout.segs:
        classes.append(("s", CHUNK_MCS, "mcs"))
    for ts, chunk, name in classes:
        # group tiles by (is_avg, slot, plane, row band); every chunk is
        # homogeneous in (slot, plane, band) so the device kernel reads
        # one [BR, wa] band slice and filters it on the MXU.  avg groups
        # come last (dest-overlap ordering).
        tl = tiles[ts]
        arr = layout.view(buf, name)
        hdrarr = layout.view(buf, name + "h")
        n = tl.shape[0]
        if n == 0:
            nums.append(0)
            nums_ref0.append(0)
            continue
        # the 32-tall class reads 38 rows past rmin: group with the
        # wider 40-row margin (band_params)
        st = band_params(ha, 32)[1] if ts == 32 else stride
        rmin = np.clip(tl[:, 5] - 3, 0, tl[:, 10] - 1)
        srow = np.clip((rmin // st) * st, 0, ha - br)
        order = np.lexsort((srow, tl[:, 0], tl[:, 3], tl[:, 11]))
        tl = tl[order]
        srow = srow[order]
        gkey = ((tl[:, 11] * 8 + tl[:, 3]) * 4 + tl[:, 0]) * 8192 + srow
        starts = np.nonzero(np.r_[True, gkey[1:] != gkey[:-1]])[0]
        ends = np.r_[starts[1:], n]
        ci = 0
        c0 = 0
        ok = True
        aligned = False
        for s, e in zip(starts, ends):
            if ts == 4 and not aligned and tl[s, 11] == 1:
                # align the 4x4 class's ref0/avg boundary to a group-of-4
                # multiple (empty pad chunks): the fused step's masked
                # single-loop landing (shared-trip/batched mode) then
                # never mixes a ref0 tile and an avg tile of the same
                # stream in one scatter group (fused._mc_pass)
                ci = (ci + 3) & ~3
                c0 = ci
                aligned = True
            for k0 in range(s, e, chunk):
                if ci >= arr.shape[0]:
                    ok = False
                    break
                part = tl[k0:min(k0 + chunk, e)]
                if ts == "s":
                    arr[ci, :len(part)] = part
                else:
                    # wire projection: (dx | filt<<13, dy+1, sr, sc)
                    wp = arr[ci, :len(part)]
                    wp[:, 0] = part[:, 1] | (part[:, 8] << 13)
                    wp[:, 1] = part[:, 2]
                    wp[:, 2] = ((part[:, 5] - (part[:, 2] - 1)) << 4) \
                        | part[:, 7]
                    wp[:, 3] = ((part[:, 4] - part[:, 1]) << 4) \
                        | part[:, 6]
                hdrarr[ci, 0] = tl[s, 3]
                hdrarr[ci, 1] = tl[s, 0]
                hdrarr[ci, 2] = srow[s]
                if ts != "s":
                    hdrarr[ci, 3] = tl[s, 9]    # ref crop width
                    hdrarr[ci, 4] = tl[s, 10]   # ref crop height
                ci += 1
                if tl[s, 11] == 0:
                    c0 = ci  # chunks are ref_i-homogeneous, ref0 first
            if not ok:
                break
        if not ok:
            _note_overflow(name, ci + 1, arr.shape[0])
            return None  # overflow -> host fallback
        nums.append(ci)
        nums_ref0.append(c0)
    return nums, nums_ref0


def _pack_intra(plan, caps, layout, buf):
    units, _num_waves = planlib.build_intra_units(plan)
    hdr = plan.hdr
    ss_x, ss_y = hdr.subsampling_x, hdr.subsampling_y
    aligned = [(hdr.mi_cols * 8, hdr.mi_rows * 8),
               ((hdr.mi_cols * 8) >> ss_x, (hdr.mi_rows * 8) >> ss_y),
               ((hdr.mi_cols * 8) >> ss_x, (hdr.mi_rows * 8) >> ss_y)]
    rows = []
    for u in units:
        fw, fh = aligned[u.plane]
        need = int(EXTEND[u.mode])
        bs = u.bs
        n_left = 0
        if (need & NEED_LEFT) and u.have_left:
            n_left = (fh - u.y0) if (u.bottom_clipped and u.y0 + bs > fh) \
                else bs
        n_above = 0
        if (need & (NEED_ABOVE | NEED_ABOVERIGHT)) and u.have_up:
            if need & NEED_ABOVERIGHT:
                if u.right_clipped:
                    if u.x0 + 2 * bs <= fw:
                        n_above = 2 * bs if (u.have_right and bs == 4) else bs
                    elif u.x0 + bs <= fw:
                        n_above = (fw - u.x0) if (u.have_right and bs == 4) \
                            else bs
                    else:
                        n_above = fw - u.x0
                else:
                    n_above = 2 * bs if (bs == 4 and u.have_right) else bs
            else:
                n_above = (fw - u.x0) if (u.right_clipped
                                          and u.x0 + bs > fw) else bs
        if u.have_up and (need & (NEED_ABOVE | NEED_ABOVERIGHT)):
            tl_mode = 0 if u.have_left else 1
        else:
            tl_mode = 2
        bs_idx = {4: 0, 8: 1, 16: 2, 32: 3}[bs]
        # bit-pack to 4 int16 words (device unpack: fused._intra_chunk);
        # x0/y0 are 4-aligned so /4 fits 14 bits at the spec's 65536 max
        # dimension; y0/4 stored +1 so an all-zero record is padding
        w0 = (u.x0 >> 2) | (u.plane << 14)
        w1 = ((u.y0 >> 2) + 1) | (int(u.have_up) << 15)
        w2 = u.mode | (n_above << 4) | (n_left << 10)
        w3 = tl_mode | (int(u.have_left) << 2)
        rows.append((u.wave, bs_idx,
                     w0 - 0x10000 if w0 & 0x8000 else w0,
                     w1 - 0x10000 if w1 & 0x8000 else w1,
                     w2 - 0x10000 if w2 & 0x8000 else w2, w3))
    cap = caps["intra"]
    chunks = layout.view(buf, "intra")
    chunk_bs = layout.view(buf, "chunk_bs")
    if not rows:
        return 0
    rows.sort(key=lambda t: (t[0], t[1]))
    ichunk = chunks.shape[1]
    ci = 0
    pos = 0
    cur_key = (rows[0][0], rows[0][1])
    chunk_bs[0] = rows[0][1]
    for t in rows:
        key = (t[0], t[1])
        if key != cur_key or pos == ichunk:
            ci += 1
            if ci >= cap:
                _note_overflow("intra", ci + 1, cap)
                return None  # overflow -> host fallback
            pos = 0
            cur_key = key
            chunk_bs[ci] = t[1]
        chunks[ci, pos] = t[2:]
        pos += 1
    return ci + 1


def _pack_lf(plan, caps, layout, buf):
    hdr = plan.hdr
    if not hdr.lf.filter_level:
        return 0
    from ..ops.ref.loopfilter import make_thresholds
    from .lfmeta import pack_lf_thresholds, pack_lfm_fields
    (lvl_y, vy, hy), (lvl_uv, vuv, huv) = lfmeta.build_lf_metadata(
        plan.mi, plan.seg_map, hdr)
    thr = make_thresholds(hdr.lf.sharpness_level)
    layout.view(buf, "lf_thr")[:] = pack_lf_thresholds(thr)
    if "lfm_c" not in layout.segs and "lfw_v" not in layout.segs:
        layout.view(buf, "lfm")[:] = pack_lfm_fields(
            lvl_y, vy, hy, lvl_uv, vuv, huv,
            hdr.mi_rows, hdr.mi_cols)
        return 1
    # non-4:2:0: luma through the normal kernel (chroma fields zeroed)
    z1 = np.zeros((1, 1), lvl_uv.dtype)
    zb = np.zeros((1, 1), bool)
    zm = (zb, zb, zb, zb)
    layout.view(buf, "lfm")[:] = pack_lfm_fields(
        lvl_y, vy, hy, z1, zm, zm, hdr.mi_rows, hdr.mi_cols)
    if "lfm_c" in layout.segs:
        # 4:4:4: chroma masks in luma format at the chroma cell grid
        rc = cdiv(hdr.mi_rows, 1 << hdr.subsampling_y)
        cc = cdiv(hdr.mi_cols, 1 << hdr.subsampling_x)
        layout.view(buf, "lfm_c")[:] = pack_lfm_fields(
            lvl_uv, vuv, huv, z1, zm, zm, rc, cc)
        return 1
    # 4:2:2 and 4:4:0: per-cell mask bitfields + thresholds for the
    # sequential tile path (ops/device/lf_wave.py)
    mb_t, lm_t, hv_t = thr
    lv = np.clip(lvl_uv, 0, 63)
    R0, C0 = lvl_uv.shape
    for nm, masks in (("lfw_v", vuv), ("lfw_h", huv)):
        dst = layout.view(buf, nm)
        bits = sum((m.astype(np.int16) << k) for k, m in enumerate(masks))
        dst[:R0, :C0] = bits
    for nm, tab in (("lfw_mb", mb_t), ("lfw_lm", lm_t), ("lfw_hv", hv_t)):
        dst = layout.view(buf, nm)
        dst[:R0, :C0] = tab[lv].astype(np.int16)
    return 1


PAGE = 512  # int16 elements per transfer page (1 KB)


def pack_frame(plan, refs, caps, layout, pool_ha=None):
    """Pack one frame into a flat int16 buffer (padded to a PAGE multiple;
    zero pages are elided from the host->device transfer).  Returns None
    when the tight-tier capacities overflow (caller falls back to the
    host oracle)."""
    hdr = plan.hdr
    buf = np.zeros(cdiv(layout.size, PAGE) * PAGE, np.int16)
    ncoeff = _pack_coeffs(plan, caps, layout, buf, bool(hdr.lossless),
                          hdr.bit_depth)
    if ncoeff is None:
        return None
    if hdr.frame_is_intra_only:
        nmc, nmc0 = [0, 0, 0, 0], [0, 0, 0, 0]
    else:
        packed_mc = _pack_mc(plan, refs, caps, layout, buf, pool_ha)
        if packed_mc is None:
            return None
        nmc, nmc0 = packed_mc
    n_chunks = _pack_intra(plan, caps, layout, buf)
    if n_chunks is None:
        return None
    lf_on = _pack_lf(plan, caps, layout, buf)
    mi = plan.mi
    mm = ((mi.ref[:, :, 0] > C.INTRA_FRAME)
          & (mi.skip == 0)).astype(np.uint16)
    mi_rows, mi_cols = mm.shape
    pc = cdiv(mi_cols, 16)
    mmp = np.zeros((mi_rows, pc * 16), np.uint16)
    mmp[:, :mi_cols] = mm
    packed = np.zeros((mi_rows, pc), np.uint16)
    for b in range(16):
        packed |= mmp[:, b::16] << b
    layout.view(buf, "mi_mask")[:] = packed.astype(np.int16)
    misc = layout.view(buf, "misc")
    misc[0] = nmc[0]
    misc[1] = nmc[1]
    misc[2] = nmc[2]
    misc[3] = n_chunks
    misc[4] = lf_on
    for i in range(8):
        misc[5 + i] = (hdr.refresh_frame_flags >> i) & 1
    # misc[MISC_TRIP[name]]: residual fori_loop trip count per coeff
    # bucket (cdiv(filled units, chunk))
    for b, (name, _, _) in enumerate(COEFF_BUCKETS):
        misc[MISC_TRIP[name]] = cdiv(ncoeff[b], COEFF_CHUNK[name])
    misc[MISC_TRIP_TX3C] = cdiv(ncoeff[len(COEFF_BUCKETS)], CHUNK_TX3C)
    misc[MISC_TRIP_TX3CS] = cdiv(ncoeff[len(COEFF_BUCKETS) + 1],
                                 CHUNK_TX3CS)
    # misc[23..25]: first compound-average chunk per MC class (chunks
    # before it are unique-destination first-reference predictions)
    for i in range(3):
        misc[23 + i] = nmc0[i]
    # misc[33]/[34]: 32x32 MC class chunk count / first avg chunk
    misc[33] = nmc[3]
    misc[34] = nmc0[3]
    # misc[14]/[15]: scaled-reference mcs chunk counts (tier "scaled")
    if len(nmc) > 4:
        misc[14] = nmc[4]
        misc[15] = nmc0[4]
    return buf
