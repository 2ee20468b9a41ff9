#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cuda_vp9_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi name and power limit) and the torch / CUDA
     versions, and build the CUDA sources from cuda_vp9_torch/csrc with
     nvcc, one compiler per source, all started together;
  2. compare each kernel with its plain torch version on the card, bit for
     bit (tolerance 0: integer math):
       - the loop filter on random pixels and random edge metadata at bit
         depths 8, 10 and 12, at 64x64 and at the 1920x1088 canvas, and on
         the 4:4:4 chroma-plane call (a chroma plane as plane 0 of a
         [3, hac, wac] canvas, zero chroma fields) at 10 bits; lf_on = 0
         must leave the frame untouched;
       - the 4:2:2 chroma loop filter against lf_plane_tiles at bit depths
         8, 10 and 12 on p1_04's 144x88 chroma planes and at 10 bits on
         1088x960 planes (that plain run is timed for phase 5);
       - the loop filter's stream axis (lf_frames, one launch for N
         frames) against lf_frames_plain and against N single lf_frame
         calls: 16 frames on the 640x384 canvas at bit depths 8, 10 and
         12, and 2 frames on the 1920x1088 canvas at 10 bits, lf_on random
         per frame with at least one 0 (that frame must come back
         untouched);
       - the tile probe at [200, 200] against tile_probe_plain and the
         probe's NumPy reference;
  3. run the frame step once at one 64x64 superblock (fused.entry);
  4. the main paths, each with the kernel counts set to 0 just before it
     and read just after:
       - decode through the vpx_codec_* API with vp9_dx_torch("cuda"):
         nc03 (loop filter on), hd01 (1080p), cp01 (compound prediction,
         scaled references), the 10- and 12-bit streams p2_01, p2_02 and
         p2_04, the 4:4:4 streams p3_01 (10-bit) and p1_01, the 4:2:2
         streams p1_02 and p1_04, hb01 (1080p 10-bit), and the lossless
         streams ll01 and ll02 (filter level 0 throughout).  Every frame's
         MD5 must equal the golden file and every frame must run on the
         device; the loop-filter kernel must have launched on every
         stream with a filter level, the 4:2:2 chroma kernel on p1_02 and
         p1_04, and neither plain version ever;
       - the tile probe through its entry point (tools/tile_probe.py),
         checked against the probe's NumPy reference;
       - the multi-stream decoders (runtime/multistream.py), each run on
         its own counts: BatchedTorchDecoder on 16 copies of nc03 (12
         rounds), on lg01 + in01 + kf02 (48 rounds: the ring wraps, short
         streams sit rounds out, filter levels differ within a round) and
         on in02 + sc01 (sc01's resized frames leave the batch for the
         single-stream step); then MultiStreamDecoder on kf01 + kf03.
         Every MD5 must equal the golden file, every frame must run on the
         device (on in02 + sc01: as many on the host as a TorchRecon gives
         sc01 alone), and when every frame joined the batch the loop
         filter must have launched once per round with a level, as the
         port's parser reads the headers;
  5. time a second, warm decode of nc03, hd01, cp01 and hb01, and of 16 x
     nc03 through BatchedTorchDecoder (aggregate fps), and each kernel
     against its plain version (CUDA events); each timed run of the loop
     filter is also held against the plain result, and lf_frames on 16
     640x384 frames is timed beside 16 lf_frame calls.

The last two lines are a JSON record of the kernels and the contract
line {"ok": true, "device": {...}}.  Without a CUDA device, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
# (stream, frames, whether a frame has a loop-filter level)
STREAMS = (("nc03_640x360_occl", 12, True), ("hd01_1920x1080_t4", 4, True),
           ("cp01_352x288_compound", 8, False),
           ("p2_01_176x144_10b", 8, True), ("p2_02_176x144_12b", 8, True),
           ("p2_04_176x144_12b_inter", 10, True),
           ("p3_01_176x144_444_10b", 6, True),
           ("p1_01_176x144_444", 6, True), ("p1_02_176x144_422", 6, True),
           ("p1_04_176x144_422_long", 10, True),
           ("large/hb01_1920x1080_10b", 3, False),
           ("ll01_176x144_lossless", 6, False),
           ("ll02_96x64_lossless_inter", 8, False))
WARM = ("nc03_640x360_occl", "hd01_1920x1080_t4", "cp01_352x288_compound",
        "large/hb01_1920x1080_10b")
LF_SHAPES = ((8, 8), (135, 240))      # mi grids: 64x64 and 1920x1088 canvas
# 4:2:2 mi grids: p1_04's 176x144 (chroma 88x144) and 1920x1088 (chroma
# 960x1088)
LF422_SHAPES = ((18, 22), (135, 240))
LF422_STREAMS = ("p1_02_176x144_422", "p1_04_176x144_422_long")
LFS_SHAPE = (45, 80)                  # mi grid of the 640x384 canvas
NC03_BATCH = ("nc03_640x360_occl",) * 16
MIX = ("lg01_176x144_48f", "in01_176x144", "kf02_176x144")
RESIZE = ("in02_352x288", "sc01_352x288_scaled")
MSD = ("kf01_64x64", "kf03_odd_98x66")
KERNELS = ("loopfilter", "tileprobe")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor float32 rate; the
                                # table has no int32 rate, so it stands in


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def pixels(rng, h, w, bd):
    """8x8 blocks of a random level plus noise of a random amplitude
    (flat to busy, scaled to the bit depth), so every filter width
    engages somewhere."""
    s = bd - 8
    lvl = rng.integers(0, 256 << s, (h // 8, w // 8))
    amp = rng.choice([1, 3, 9, 40], (h // 8, w // 8)) << s
    noise = rng.integers(-64 << s, (64 << s) + 1, (h, w)) % np.repeat(
        np.repeat(amp, 8, 0), 8, 1)
    return np.clip(np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0,
                   (1 << bd) - 1)


def rand_lf_inputs(rng, mi_rows, mi_cols, bd, chroma_444=False):
    """Random frame, edge metadata and thresholds for one mi grid, the
    metadata as tests/test_pallas_lf.py builds it (no edge on the frame's
    left and top borders).  chroma_444: the frame step's 4:4:4 chroma
    call, one plane in plane 0 and zero chroma fields."""
    from cuda_vp9_torch.ops.ref.loopfilter import make_thresholds
    from cuda_vp9_torch.runtime.lfmeta import (pack_lf_thresholds,
                                               pack_lfm_fields)

    def cells(R, C):
        kind = rng.integers(0, 4, (R, C))
        m16, m8, m4 = kind == 1, kind == 2, kind == 3
        m4i = (rng.random((R, C)) < 0.4) & ~m16
        m16[:, 0] = m8[:, 0] = m4[:, 0] = False
        return rng.integers(0, 64, (R, C)), (m16, m8, m4, m4i)

    def hcells(R, C):
        _, (h16, h8, h4, h4i) = cells(R, C)
        h16[0], h8[0], h4[0] = False, False, False
        return h16, h8, h4, h4i & ~h16

    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    F = np.zeros((3, ha, wa), np.int32)
    F[0] = pixels(rng, ha, wa, bd)
    lvl_y, vy = cells(mi_rows, mi_cols)
    if chroma_444:
        z = (np.zeros((1, 1), bool),) * 4
        lvl_uv, vuv, huv, R2, C2 = np.zeros((1, 1), int), z, z, 1, 1
    else:
        F[1, :ha // 2, :wa // 2] = pixels(rng, ha // 2, wa // 2, bd)
        F[2, :ha // 2, :wa // 2] = pixels(rng, ha // 2, wa // 2, bd)
        R2, C2 = (mi_rows + 1) // 2, (mi_cols + 1) // 2
        lvl_uv, vuv = cells(R2, C2)
        huv = hcells(R2, C2)
    lfm = pack_lfm_fields(lvl_y, vy, hcells(mi_rows, mi_cols), lvl_uv, vuv,
                          huv, mi_rows, mi_cols)
    thr = pack_lf_thresholds(make_thresholds(int(rng.integers(0, 8))))
    return F, lfm, thr


def rand_lf_stack(rng, n, mi_rows, mi_cols, bd):
    """n random frames [n, 3, ha, wa] with their lfm [n, n_sbs_pad, 2,
    128] and thr [n, 64, 4] (rand_lf_inputs each)."""
    ins = [rand_lf_inputs(rng, mi_rows, mi_cols, bd) for _ in range(n)]
    return tuple(np.stack([x[i] for x in ins]) for i in range(3))


def strided(dev, arr, pad=512):
    """arr [n, ...] on the card as a view whose frames lie `pad` elements
    apart, as the batched step passes each stream's segment of the stacked
    flats."""
    n, size = arr.shape[0], arr[0].size
    rows = np.zeros((n, size + pad), arr.dtype)
    rows[:, :size] = arr.reshape(n, -1)
    return torch.from_numpy(rows).to(dev)[:, :size].view(arr.shape)


def rand_422_inputs(rng, mi_rows, mi_cols, bd):
    """Random 4:2:2 frame F [3, ha, wa] (chroma planes in the left
    [ha, wa/2], luma zero) and the five int16 per-cell maps (vbits, hbits,
    mb, lm, hv [ha/8, wa/16]) with edges in the visible cells, none on the
    planes' left and top borders, as runtime/pack._pack_lf writes them."""
    from cuda_vp9_torch.ops.ref.loopfilter import make_thresholds

    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    R, C = mi_rows, (mi_cols + 1) // 2
    F = np.zeros((3, ha, wa), np.int32)
    for p in (1, 2):
        F[p, :8 * R, :8 * C] = pixels(rng, 8 * R, 8 * C, bd)

    def bits(top):
        kind = rng.integers(0, 4, (R, C))
        m16, m8, m4 = kind == 1, kind == 2, kind == 3
        m4i = (rng.random((R, C)) < 0.4) & ~m16
        for m in (m16, m8, m4):
            if top:
                m[0, :] = False
            else:
                m[:, 0] = False
        return m16 | m8 << 1 | m4 << 2 | m4i << 3

    lv = rng.integers(0, 64, (R, C))
    maps = []
    for v in (bits(False), bits(True),
              *(t[lv] for t in make_thresholds(int(rng.integers(0, 8))))):
        m = np.zeros((ha // 8, wa // 16), np.int16)
        m[:R, :C] = v
        maps.append(m)
    return F, maps


# int32 operations per filtered lane (one pixel row or column of one edge
# chain) of csrc/loopfilter.cu's edge_chain, by filter: the filter mask
# and hev (38), flat (23), filter4 (25), the 6 filter8 taps (54), flat2
# and the 14 filter16 taps (181); the interior 4x4 edge is another mask,
# hev and filter4 (63).
LF_LANE_OPS = {16: 321, 8: 140, 4: 63, "inner": 63}


def edge_ops(bits) -> float:
    """int32 operations of the edge chains that cells with these edge
    bits need; each cell is the edge of 8 lanes."""
    bits = np.asarray(bits).astype(np.int32)
    k16 = (bits & 1) != 0
    k8 = ((bits & 2) != 0) & ~k16
    k4 = ((bits & 4) != 0) & ~k16 & ~k8
    return 8.0 * sum(int(m.sum()) * LF_LANE_OPS[k] for m, k in (
        (k16, 16), (k8, 8), (k4, 4), ((bits & 8) != 0, "inner")))


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lf_work(F, lfm, thr):
    """(bytes, operations) of one lf_frame call on a 4:2:0 frame: its
    pixels (the luma plane and the top-left quarter of each chroma plane
    of F) read once and written once, lfm and thr read once; the int32
    operations that this lfm's edges need (a chroma entry, [64:128] of
    each half, is the edge of both the U and the V lanes)."""
    _, ha, wa = F.shape
    px = ha * wa + 2 * (ha // 2) * (wa // 2)
    halves = lfm.reshape(-1, 2, 128)
    return (2 * px * F.itemsize + lfm.nbytes + thr.nbytes,
            edge_ops(halves[:, :, :64]) + 2 * edge_ops(halves[:, :, 64:]))


def lf_bound_ms(F, lfm, thr):
    """(bound ms, "bytes" or "operations") of one lf_frame call."""
    return bound(*lf_work(F, lfm, thr))


def lfs_bound_ms(F, lfm, thr, lf_on):
    """(bound ms, "bytes" or "operations") of one lf_frames call: the work
    of lf_frame on every frame with a level, summed."""
    work = [lf_work(F[k], lfm[k], thr[k]) for k in range(len(lf_on))
            if lf_on[k]]
    return bound(sum(w[0] for w in work), sum(w[1] for w in work))


def lf422_bound_ms(F, maps):
    """(bound ms, "bytes" or "operations") of one lf_chroma_422 call: the
    two chroma planes (the left [ha, wa/2] of planes 1 and 2) read once
    and written once and the five maps read once, against the operations
    of both planes' edges."""
    _, ha, wa = F.shape
    px = 2 * ha * (wa // 2)
    return bound(2 * px * F.itemsize + sum(m.nbytes for m in maps),
                 2 * (edge_ops(maps[0]) + edge_ops(maps[1])))


def probe_bound_ms(frame, masks, coords):
    """(bound ms, "bytes" or "operations") of one tile-probe call.  It
    works in place and touches only its entries' tiles: per valid entry
    its 72x72 tile read once and written once and the 8 mask values it
    adds, against 4 int32 adds per changed pixel (64 per entry)."""
    n = int((coords.reshape(-1, 2)[:, 0] > 0).sum())
    return bound(n * (2 * 72 * 72 * frame.itemsize + 8 * masks.itemsize),
                 n * 64 * 4)


def cuda_ms(fn, reps: int, setup=None, after=None) -> float:
    """Median milliseconds of fn(x) over reps runs, CUDA events; x =
    setup() is made outside the timed window, and after(x), if given, is
    called on each run's x once the run has finished."""
    times = []
    for _ in range(reps):
        x = setup() if setup else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        if after:
            after(x)
    return statistics.median(times)


def decode(name: str, n_frames: int):
    """Decode one fixture through the codec API on the card; returns
    (md5s, recon, seconds).  The MD5s read every frame back to the host,
    so the time covers the device work."""
    from cuda_vp9_torch.tools.profile_decode import decode as decode_md5

    t0 = time.perf_counter()
    md5s, recon = decode_md5(str(FIXTURES / f"{name}.ivf"), "cuda", n_frames)
    return md5s, recon, time.perf_counter() - t0


def packets(name):
    from cuda_vp9_torch.containers import IvfReader
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r]


def golden_md5(name):
    return [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]


def filter_levels(name):
    """Per packet, the loop-filter level of each of its frames, read from
    the uncompressed headers by the port's parser (the level's bits do not
    depend on the reference sizes, so none are needed)."""
    from cuda_vp9_torch.decoder.bitreader import parse_superframe_index
    from cuda_vp9_torch.decoder.headers import parse_uncompressed_header
    return [[parse_uncompressed_header(
        d[o:o + n], ref_sizes=lambda i: (16, 16)).lf.filter_level
        for o, n in parse_superframe_index(d)] for d in packets(name)]


def rounds_with_level(names, rounds=None):
    """Rounds (one packet per stream, no superframes) in which some
    stream's frame has a loop-filter level: one lf_frames launch each when
    every frame joins the batch."""
    levels = [filter_levels(n)[:rounds] for n in names]
    return sum(any(lv[i][0] for lv in levels if i < len(lv))
               for i in range(max(map(len, levels))))


def batched(names, rounds=None):
    """Decode the streams in lockstep through BatchedTorchDecoder("cuda"),
    one packet of each per round (the first `rounds` packets), and read
    every frame back; returns (per-stream MD5s, the decoder, seconds)."""
    from cuda_vp9_torch.tools.multistream_bench import run_batched
    pk = [packets(n)[:rounds] for n in names]
    t0 = time.perf_counter()
    md5s, bd = run_batched(pk, "cuda")
    return md5s, bd, time.perf_counter() - t0


def multi_stream_paths(LF, L4, TP):
    """Phase 4c: BatchedTorchDecoder on 16 x nc03, the 48-round mix and
    in02 + sc01, then MultiStreamDecoder, each with the kernel counts set
    to 0 before it; exits on a failed check.  Returns the stream-axis
    kernel's launches on 16 x nc03."""
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.runtime.multistream import MultiStreamDecoder
    from cuda_vp9_torch.runtime.pipeline import TorchRecon
    from cuda_vp9_torch.utils.md5 import frame_md5
    lfs_launches = None
    for label, names, rounds in (("16 x nc03", NC03_BATCH, None),
                                 ("lg01 + in01 + kf02", MIX, None),
                                 ("in02 + sc01", RESIZE, 6)):
        LF.reset_counts()
        L4.reset_counts()
        TP.reset_counts()
        md5s, bd, dt = batched(names, rounds)
        st = bd.stats()
        unbatched = sum(r["unbatched"] for r in st)
        n_frames = sum(len(m) for m in md5s)
        bad = [(n, [i for i, (a, b) in enumerate(zip(m, golden_md5(n)))
                    if a != b]) for n, m in zip(names, md5s)]
        bad = [b for b in bad if b[1]]
        want = rounds_with_level(names, rounds) if not unbatched else None
        print(f"batched {label}: {n_frames} frames in {bd.rounds} rounds, "
              f"MD5 mismatches {bad}, on device "
              f"{sum(r['device'] for r in st)}, on host "
              f"{sum(r['host'] for r in st)}, frames_unbatched {unbatched}, "
              f"lf_frames launches {LF.launches} (rounds with a level: "
              f"{want}), plain calls {LF.plain_calls}, cold {dt:.2f} s "
              f"({dt / max(bd.rounds, 1):.3f} s a round)")
        if bad or LF.plain_calls or L4.plain_calls or any(
                len(m) != len(golden_md5(n)[:rounds]) for n, m in zip(
                    names, md5s)):
            raise SystemExit(f"batched {label}: decode check failed")
        if names is RESIZE:
            alone = TorchRecon("cuda")
            dec = NativeVp9Decoder(recon_fn=alone)
            for p in packets(RESIZE[1])[:rounds]:
                dec.decode(p)
            print(f"batched {label}: sc01 frames_unbatched "
                  f"{st[1]['unbatched']}, on host {st[1]['host']}; a "
                  f"TorchRecon alone: on host {alone.frames_on_host}")
            if not st[1]["unbatched"] or st[0]["host"] \
                    or st[1]["host"] != alone.frames_on_host:
                raise SystemExit("in02 + sc01: sc01's resized frames did "
                                 "not leave the batch as expected")
        elif unbatched or any(r["host"] for r in st) or LF.launches != want:
            raise SystemExit(f"batched {label}: frames left the batch or "
                             "the stream-axis kernel did not run once per "
                             "round with a level")
        if names is NC03_BATCH:
            lfs_launches = LF.launches
    LF.reset_counts()
    msd = MultiStreamDecoder(len(MSD), lag=2)
    pk = [packets(n) for n in MSD]
    got = [[] for _ in MSD]
    for i in range(max(map(len, pk))):
        for s in range(len(MSD)):
            if i < len(pk[s]):
                msd.put(s, pk[s][i])
        for s, f in msd.ready():
            got[s].append(frame_md5(f.visible_planes()))
    for s, f in msd.flush():
        got[s].append(frame_md5(f.visible_planes()))
    print(f"MultiStreamDecoder {' + '.join(MSD)}: stats {msd.stats()}, "
          f"MD5 equal {[g == golden_md5(n) for g, n in zip(got, MSD)]}")
    if any(g != golden_md5(n) for g, n in zip(got, MSD)) \
            or any(st["host"] for st in msd.stats()):
        raise SystemExit("MultiStreamDecoder: decode check failed")
    return lfs_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_vp9_torch.ops.cuda import _build
    from cuda_vp9_torch.ops.cuda import lf422 as L4
    from cuda_vp9_torch.ops.cuda import loopfilter as LF
    from cuda_vp9_torch.ops.cuda import tileprobe as TP
    from cuda_vp9_torch.runtime import fused
    from cuda_vp9_torch.tools import tile_probe as probe_tool

    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build the sources, one nvcc each, in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(_build.build, KERNELS))
    LF._lib()
    L4._lib()
    TP._lib()
    print(f"build {', '.join(k + '.cu' for k in KERNELS)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_build.build_seconds.get(k, 0.0):.2f} s"
                      for k in KERNELS) + ")")

    # 2. each kernel against its plain version, bit-exact
    rng = np.random.default_rng(2026)
    lf_err = 0
    cases = [(bd, shape, False) for bd in (8, 10, 12) for shape in LF_SHAPES]
    cases += [(10, (18, 22), True), (10, LF_SHAPES[-1], True)]
    for bd, (mi_rows, mi_cols), c444 in cases:
        F, lfm, thr = rand_lf_inputs(rng, mi_rows, mi_cols, bd, c444)
        args = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev))
        Fk = torch.from_numpy(F).to(dev)
        Fp = Fk.clone()
        kw = dict(mi_rows=mi_rows, mi_cols=mi_cols, bd=bd)
        LF.lf_frame(Fk, *args, 1, **kw)
        LF.lf_frame_plain(Fp, *args, 1, **kw)
        torch.cuda.synchronize()
        err = int((Fk - Fp).abs().max())
        changed = int((Fp != torch.from_numpy(F).to(dev)).sum())
        what = f"{F.shape[1]}x{F.shape[2]} bd {bd}" + (
            " 4:4:4 chroma canvas" if c444 else "")
        print(f"lf kernel vs plain {what}: max_abs_err {err} (tolerance 0), "
              f"{changed} pixels filtered")
        if err or not changed or (c444 and Fk[1:].any()):
            raise SystemExit(f"loop-filter kernel disagrees at {what}")
        lf_err = max(lf_err, err)
        Fo = torch.from_numpy(F).to(dev)
        LF.lf_frame(Fo, *args, 0, **kw)
        if not torch.equal(Fo.cpu(), torch.from_numpy(F)):
            raise SystemExit("lf_on = 0 changed the frame")
    print("lf_on = 0: identity")
    l4_err = 0
    l4_cases = [(bd, LF422_SHAPES[0]) for bd in (8, 10, 12)]
    l4_cases += [(10, LF422_SHAPES[1])]
    for bd, mi in l4_cases:
        F, maps = rand_422_inputs(rng, *mi, bd)
        md = [torch.from_numpy(m).to(dev) for m in maps]
        Fk = torch.from_numpy(F).to(dev)
        Fp = Fk.clone()
        L4.lf_chroma_422(Fk, *md, 1, bd=bd)
        # the plain twin: lf_plane_tiles on each plane, written back
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L4.lf_chroma_422_plain(Fp, *md, 1, bd=bd)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = int((Fk - Fp).abs().max())
        changed = int((Fp != torch.from_numpy(F).to(dev)).sum())
        what = f"{F.shape[1]}x{F.shape[2] // 2} planes bd {bd}"
        print(f"lf_chroma_422 kernel vs lf_plane_tiles {what}: max_abs_err "
              f"{err} (tolerance 0), {changed} pixels filtered, plain "
              f"{plain_s:.3f} s")
        if err or not changed:
            raise SystemExit(f"4:2:2 chroma kernel disagrees at {what}")
        l4_err = max(l4_err, err)
        if mi == LF422_SHAPES[1]:
            # one plain run of minutes is timed here, not repeated in 5
            l4_big = (F, maps, plain_s * 1e3)
    Fo = torch.from_numpy(F).to(dev)
    before = L4.launches
    L4.lf_chroma_422(Fo, *md, 0, bd=10)
    if not torch.equal(Fo.cpu(), torch.from_numpy(F)) \
            or L4.launches != before:
        raise SystemExit("4:2:2 lf_on = 0 changed the frame or launched")
    lfs_err = 0
    for bd, n, mi in [(bd, 16, LFS_SHAPE) for bd in (8, 10, 12)] + [
            (10, 2, LF_SHAPES[-1])]:
        F, lfm, thr = rand_lf_stack(rng, n, *mi, bd)
        lf_on = [int(v) for v in rng.integers(0, 2, n)]
        lf_on[0], lf_on[1] = 0, 1
        lfm_d, thr_d = strided(dev, lfm), strided(dev, thr)
        kw = dict(mi_rows=mi[0], mi_cols=mi[1], bd=bd)
        F0 = torch.from_numpy(F).to(dev)
        Fk, Fs, Fp = F0.clone(), F0.clone(), F0.clone()
        LF.lf_frames(Fk, lfm_d, thr_d, lf_on, **kw)
        for k in range(n):
            LF.lf_frame(Fs[k], lfm_d[k], thr_d[k], lf_on[k], **kw)
        LF.lf_frames_plain(Fp, lfm_d, thr_d, lf_on, **kw)
        torch.cuda.synchronize()
        err = int((Fk - Fp).abs().max())
        err_single = int((Fk - Fs).abs().max())
        same = [torch.equal(Fk[k], F0[k]) for k in range(n)]
        what = f"{n} x {F.shape[2]}x{F.shape[3]} bd {bd} lf_on {lf_on}"
        print(f"lf_frames kernel vs plain {what}: max_abs_err {err} "
              f"(tolerance 0), vs {n} lf_frame kernel calls {err_single}, "
              f"frames with lf_on 0 untouched "
              f"{all(same[k] for k in range(n) if not lf_on[k])}")
        if err or err_single or any(same[k] != (not lf_on[k])
                                    for k in range(n)):
            raise SystemExit(f"lf_frames disagrees at {what}")
        lfs_err = max(lfs_err, err, err_single)
    err, probe_err = probe_tool.run("cuda")
    print(f"tile_probe kernel [200, 200]: max_abs_err {probe_err} against "
          f"tile_probe_plain, {err} against the NumPy reference "
          f"(tolerance 0)")
    if err or probe_err:
        raise SystemExit("tile-probe kernel disagrees")

    # 3. the step at one superblock
    step, sargs = fused.entry(dev)
    step(*sargs)
    torch.cuda.synchronize()
    print("fused.entry: one 64x64 step ran")

    # 4a. the decode path through the codec API, counted
    LF.reset_counts()
    L4.reset_counts()
    TP.reset_counts()
    lf_by_stream = {}
    for name, n, filtered in STREAMS:
        before, before4 = LF.launches, L4.launches
        md5s, recon, dt = decode(name, n)
        lf_by_stream[name] = LF.launches - before
        l4_here = L4.launches - before4
        golden = golden_md5(name)[:n]
        bad = [i for i, (a, b) in enumerate(zip(md5s, golden)) if a != b]
        print(f"{name}: {len(md5s)} frames, MD5 mismatches {bad}, "
              f"on device {recon.frames_on_device}, on host "
              f"{recon.frames_on_host}, wide {recon.frames_wide}, "
              f"lf_frame launches {lf_by_stream[name]}, lf_chroma_422 "
              f"launches {l4_here}, cold {dt:.2f} s")
        if len(md5s) != n or bad or recon.frames_on_device != n \
                or recon.frames_on_host:
            raise SystemExit(f"{name}: decode check failed")
        if filtered and not lf_by_stream[name]:
            raise SystemExit(f"{name}: the loop-filter kernel never ran")
        if name in LF422_STREAMS and (not l4_here or L4.plain_calls):
            raise SystemExit(f"{name}: the 4:2:2 chroma kernel never ran")
    lf_launches, lf_plain = LF.launches, LF.plain_calls
    l4_launches, l4_plain = L4.launches, L4.plain_calls
    print(f"decode path: loop-filter kernel launches {lf_launches}, plain "
          f"calls {lf_plain}; 4:2:2 chroma kernel launches {l4_launches}, "
          f"plain calls {l4_plain}; tile-probe launches {TP.launches}")
    if lf_launches == 0 or lf_plain or l4_launches == 0 or l4_plain:
        raise SystemExit("the decode path did not run the loop-filter "
                         "kernels")

    # 4b. the tile probe through its entry point, counted
    LF.reset_counts()
    L4.reset_counts()
    TP.reset_counts()
    err, _ = probe_tool.run("cuda", check_plain=False)
    probe_launches, probe_plain = TP.launches, TP.plain_calls
    print(f"tile probe path: max_abs_err {err} against the NumPy reference, "
          f"kernel launches {probe_launches}, plain calls {probe_plain}")
    if err or not probe_launches or probe_plain or LF.launches \
            or L4.launches:
        raise SystemExit("the tile-probe path failed")

    # 4c. the multi-stream decoders, each counted on its own
    lfs_launches = multi_stream_paths(LF, L4, TP)

    # 5. warm decode rate and kernel timing
    frames = {name: n for name, n, _ in STREAMS}
    for name in WARM:
        n = frames[name]
        _, _, dt = decode(name, n)
        print(f"{name}: warm {n} frames {dt:.3f} s = {n / dt:.2f} fps "
              f"[{card}]")
        if name == NC03_BATCH[0]:
            single_fps = n / dt
    md5s, bd, dt = batched(NC03_BATCH)
    n_frames = sum(len(m) for m in md5s)
    if any(m != golden_md5(NC03_BATCH[0]) for m in md5s):
        raise SystemExit("16 x nc03 warm pass: MD5 mismatch")
    print(f"16 x nc03 batched: warm {n_frames} frames in {bd.rounds} rounds "
          f"{dt:.3f} s = {n_frames / dt:.2f} fps aggregate "
          f"({dt / bd.rounds:.3f} s a round; single-stream nc03 "
          f"{single_fps:.2f} fps in this run) [{card}]")
    lf_rows = {}
    for bd in (8, 10):
        F, lfm, thr = rand_lf_inputs(rng, *LF_SHAPES[-1], bd)
        Fd = torch.from_numpy(F).to(dev)
        lfm_d = torch.from_numpy(lfm).to(dev)
        thr_d = torch.from_numpy(thr).to(dev)
        kw = dict(mi_rows=LF_SHAPES[-1][0], mi_cols=LF_SHAPES[-1][1], bd=bd)
        plains = []
        plain_ms = cuda_ms(lambda f: LF.lf_frame_plain(f, lfm_d, thr_d, 1,
                                                       **kw), 3, Fd.clone,
                           plains.append)
        want = plains[-1]
        n_bad = []

        def held(f):
            n_bad.append(not torch.equal(f, want))

        LF.lf_frame(Fd.clone(), lfm_d, thr_d, 1, **kw)
        ms = cuda_ms(lambda f: LF.lf_frame(f, lfm_d, thr_d, 1, **kw), 20,
                     Fd.clone, held)
        if len(n_bad) != 20 or any(n_bad):
            raise SystemExit(f"lf_frame: {sum(n_bad)} of the 20 timed runs "
                             f"at bd {bd} differ from the plain result")
        bound, by = lf_bound_ms(F, lfm, thr)
        lf_rows[bd] = (ms, plain_ms, bound, by)
        print(f"lf_frame 1920x1088 bd {bd} median: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}); 20 of 20 "
              f"timed runs equal the plain result [{card}]")
    F, maps, l4_plain_ms = l4_big
    md = [torch.from_numpy(m).to(dev) for m in maps]
    Fd = torch.from_numpy(F).to(dev)
    L4.lf_chroma_422(Fd.clone(), *md, 1, bd=10)
    l4_ms = cuda_ms(lambda f: L4.lf_chroma_422(f, *md, 1, bd=10), 20,
                    Fd.clone)
    l4_bound, l4_by = lf422_bound_ms(F, maps)
    small = rand_422_inputs(rng, *LF422_SHAPES[0], 10)
    smd = [torch.from_numpy(m).to(dev) for m in small[1]]
    s_plain_ms = cuda_ms(lambda f: L4.lf_chroma_422_plain(f, *smd, 1, bd=10),
                         3, lambda: torch.from_numpy(small[0]).to(dev))
    s_ms = cuda_ms(lambda f: L4.lf_chroma_422(f, *smd, 1, bd=10), 20,
                   lambda: torch.from_numpy(small[0]).to(dev))
    # the serial floor: a frame one SB row tall has no waits, so one SB
    # step is (t(30 SBs) - t(1 SB)) / 29; the critical path of a
    # 1920x1088 frame is sb_cols + sb_rows - 1 = 46 steps (the kernels
    # hand off in half steps: csrc/loopfilter.cu)
    def row_ms(mi_cols, chroma):
        if chroma:
            F, maps = rand_422_inputs(rng, 8, mi_cols, 10)
            md = [torch.from_numpy(m).to(dev) for m in maps]

            def fn(f):
                L4.lf_chroma_422(f, *md, 1, bd=10)
        else:
            F, lfm, thr = rand_lf_inputs(rng, 8, mi_cols, 10)
            a = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev))

            def fn(f):
                LF.lf_frame(f, *a, 1, mi_rows=8, mi_cols=mi_cols, bd=10)
        Fd = torch.from_numpy(F).to(dev)
        fn(Fd.clone())
        return cuda_ms(fn, 50, Fd.clone)

    n_steps = LF_SHAPES[-1][1] // 8 + (LF_SHAPES[-1][0] + 7) // 8 - 1
    for name, chroma in (("lf_frame", False), ("lf_chroma_422", True)):
        t1, t30 = row_ms(8, chroma), row_ms(240, chroma)
        step = (t30 - t1) / 29
        print(f"{name} one SB step {step * 1e3:.2f} us (64x64: {t1:.4f} ms, "
              f"64x1920: {t30:.4f} ms); critical path at 1920x1088: "
              f"{n_steps} steps = {n_steps * step:.4f} ms [{card}]")
    print(f"lf_chroma_422 1088x960 planes bd 10 median: kernel {l4_ms:.3f} "
          f"ms, plain {l4_plain_ms:.3f} ms (one run, phase 2), bound "
          f"{l4_bound:.4f} ms ({l4_by}); 144x88 planes: kernel {s_ms:.3f} ms, "
          f"plain {s_plain_ms:.3f} ms [{card}]")
    pf, pm, pc = probe_tool.probe_inputs()
    pf_d, pm_d = torch.from_numpy(pf).to(dev), torch.from_numpy(pm).to(dev)
    pc_t = torch.from_numpy(pc)
    TP.tile_probe(pf_d.clone(), pc_t, pm_d)
    probe_ms = cuda_ms(lambda f: TP.tile_probe(f, pc_t, pm_d), 50, pf_d.clone)
    probe_plain_ms = cuda_ms(lambda f: TP.tile_probe_plain(f, pc_t, pm_d), 20,
                             pf_d.clone)
    pbound, pby = probe_bound_ms(pf, pm, pc)
    print(f"tile_probe [200, 200] median: kernel {probe_ms:.4f} ms, plain "
          f"{probe_plain_ms:.4f} ms, bound {pbound:.6f} ms ({pby}) [{card}]")

    F, lfm, thr = rand_lf_stack(rng, 16, *LFS_SHAPE, 10)
    lf_on = [1] * 16
    lfm_d, thr_d = strided(dev, lfm), strided(dev, thr)
    kw = dict(mi_rows=LFS_SHAPE[0], mi_cols=LFS_SHAPE[1], bd=10)
    F0 = torch.from_numpy(F).to(dev)
    plains = []
    lfs_plain_ms = cuda_ms(lambda f: LF.lf_frames_plain(f, lfm_d, thr_d,
                                                        lf_on, **kw), 1,
                           F0.clone, plains.append)
    n_bad = []

    def held_16(f):
        n_bad.append(not torch.equal(f, plains[0]))

    def sequential(f):
        for k in range(16):
            LF.lf_frame(f[k], lfm_d[k], thr_d[k], lf_on[k], **kw)

    LF.lf_frames(F0.clone(), lfm_d, thr_d, lf_on, **kw)
    sequential(F0.clone())
    lfs_ms = cuda_ms(lambda f: LF.lf_frames(f, lfm_d, thr_d, lf_on, **kw),
                     20, F0.clone, held_16)
    seq_ms = cuda_ms(sequential, 20, F0.clone, held_16)
    if len(n_bad) != 40 or any(n_bad):
        raise SystemExit(f"lf_frames: {sum(n_bad)} of the 40 timed runs "
                         "differ from the plain result")
    lfs_bound, lfs_by = lfs_bound_ms(F, lfm, thr, lf_on)
    print(f"lf_frames 16 x 640x384 bd 10 median: one launch {lfs_ms:.4f} "
          f"ms, 16 lf_frame launches {seq_ms:.4f} ms, plain "
          f"{lfs_plain_ms:.3f} ms (one run), bound {lfs_bound:.4f} ms "
          f"({lfs_by}); 40 of 40 timed runs equal the plain result [{card}]")

    ms, plain_ms, bound, by = lf_rows[10]
    print(json.dumps({"kernels": [
        {"name": "lf_frame", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/loopfilter.cu",
         "replaces": "cuda_vp9_tpu/ops/pallas/loopfilter.py:430",
         "launches": lf_launches, "max_abs_err": lf_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
         "bound_by": by, "library_ms": None},
        {"name": "lf_frames", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/loopfilter.cu",
         "replaces": "cuda_vp9_tpu/ops/pallas/loopfilter.py:430",
         "launches": lfs_launches, "max_abs_err": lfs_err,
         "ms": lfs_ms, "plain_ms": lfs_plain_ms, "bound_ms": lfs_bound,
         "bound_by": lfs_by, "library_ms": None},
        {"name": "lf_plane_tiles", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/loopfilter.cu",
         "replaces": "cuda_vp9_tpu/ops/device/lf_wave.py:180",
         "launches": l4_launches, "max_abs_err": l4_err,
         "ms": l4_ms, "plain_ms": l4_plain_ms, "bound_ms": l4_bound,
         "bound_by": l4_by, "library_ms": None},
        {"name": "tile_probe", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/tileprobe.cu",
         "replaces": "tools/profiling/pallas_probe.py:110",
         "launches": probe_launches, "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms, "bound_ms": pbound,
         "bound_by": pby, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
