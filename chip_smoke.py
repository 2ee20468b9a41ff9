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
       - the persistent intra kernel (K4) against intra_pass_plain on the
         inputs of tools/kernel_cases.py (every block size 4 to 32, all 10
         modes, partial availability, the three tl_modes, units on and
         across the right and bottom edges, padded records) at bit depths
         8, 10 and 12 on a 64x64 canvas, at 10 bits on the 1920x1088
         canvas with 256-unit chunks, on a single chunk and on a 256x256
         frame of 4x4 units only, and its batched form on 4 stacked
         frames whose chunk index i mixes block sizes and whose streams
         have different chunk counts, against intra_pass_batched_plain;
         one host call and one launch per pass;
       - the residual kernel (K2), one launch for a whole bucket set
         (every bucket of pack.COEFF_BUCKETS, the WHT and at 8 bits the
         two coo buckets, no two units at one position), against the
         per-bucket twins at bit depths 8, 10 and 12, with moderate and
         extreme inputs and padded records, for one stream and for three;
       - the MC kernel (K3, K6 for the scaled class, and the inter
         residual add as its last phase) against its plain twin on every
         case of kernel_cases.MC_CASES and on two large ones (1920x1088
         at 10 bits with the HD chunk lengths, and 16 streams of 640x384
         in one batched call), each with its mask, and on the first
         case's mask alone: every tile class, bit depths 8, 10 and 12,
         4:2:0, 4:4:4 and 4:2:2, pool canvases larger than the frame,
         sources past the crop, compound chunks, padded records, pixels
         that two phases write (some case must have them); one host call
         and one launch a call, with the phases its table lists;
       - the page expansion (K5's, csrc/pages.cu) against
         expand_pages_plain and the dense flats on a round of 4 random
         flats (compacted, dense, all zero) of 2,231 pages, one launch,
         and on a round of MAX_FLATS + 6 flats of 37 pages, two launches;
  3. run the frame step once at one 64x64 superblock (fused.entry);
  4. the main paths, each with the kernel counts set to 0 just before it
     and read just after:
       - decode through the vpx_codec_* API with vp9_dx_torch("cuda"):
         nc03 (loop filter on), hd01 (1080p), cp01 (compound prediction,
         scaled references), the 10- and 12-bit streams p2_01, p2_02 and
         p2_04, the 4:4:4 streams p3_01 (10-bit) and p1_01, the 4:2:2
         streams p1_02 and p1_04, hb01 (1080p 10-bit), and the lossless
         streams ll01 and ll02 (filter level 0 throughout), and xl01
         (3840x2176).  Every frame's MD5 must equal the golden file and
         every frame must run on the device; the loop-filter kernel must
         have launched on every stream with a filter level, the 4:2:2
         chroma kernel on p1_02 and p1_04, the intra and the residual
         kernels on every stream (each starts with a keyframe), the MC
         kernel on every stream (each has inter frames) and its scaled
         class on cp01, the intra, the residual and the MC kernels with
         at most one launch per frame each (intra and MC: one per host
         call), the page expansion once per frame, and no plain version
         ever; each stream's flats sent dense (dense_frames) are printed;
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
         port's parser reads the headers, the intra and the residual
         kernels with at most one launch per round each and MC with one
         launch per host call, at most one per round, and the page
         expansion once per round (once per frame outside the batch); no
         plain version ever;
  5. time a second, warm decode of nc03, hd01, cp01, hb01 and xl01, and of
     16 x nc03 through BatchedTorchDecoder (aggregate fps), and each
     kernel against its plain version (CUDA events): the intra and the
     residual kernels on hd01's keyframe as the frame step feeds them
     (its residual buckets in one launch, then its 2703 intra chunks in
     one), beside the intra chain's hand-off floor (the same chain with
     no work) and the gap of one dependent empty launch, with ptxas's
     registers, spills and shared memory of both kernels; the MC kernel
     on nc03's busiest inter frame and on hd01's first inter frame (mask
     phase included), on cp01's busiest scaled frame (the scaled class
     alone) and on nc03's busiest frame's mask alone, as the frame step
     feeds it, each held against the twin, beside the same launch with
     no work (vp9_mc_chain_floor), the wrapper call's host time and the
     torch mask add that the last phase replaced, with ptxas's
     registers, spills and shared memory; each timed run of the loop
     filter is also held against the plain result, and lf_frames on 16
     640x384 frames is timed beside 16 lf_frame calls; the loop filter's
     one SB step (K1) and the 4:2:2 chroma filter's tile step (K7) on a
     frame one tile row tall, K7's split three ways (as it is, with no
     edge bit, and built without its write-back, LF422_SPLIT_DEFINES),
     each also on the 1088x960 pair to read the hand-offs' share;
  6. the upload (runtime/upload.py): decode nc03, hd01, xl01 and 16 x
     nc03 with every expansion checked as it runs, the kernel's flats
     against expand_pages_plain on the same upload and against the
     dense host flats (the count of flats and of pages that differ must
     be 0), and print each frame's (each round's) dense and sent bytes
     and the flats sent dense, with the host time of each call's
     compaction (its first two calls pin the staging buffers); time the
     kernel (CUDA events, median of 20; the wrapper's host time and the
     launch alone on the device beside it) against its plain version and
     against one torch.index_select call on the same pages, beside its
     bound, on hd01's keyframe, an hd01 inter frame and a 16 x nc03 inter
     round; print the host spans
     (vp9.parse, vp9.pack, vp9.compact, vp9.upload, vp9.expand,
     vp9.readback) of a stage-clocked decode of each warm stream and of
     16 x nc03; and hd01 and xl01 parsed with 1 and with min(4, cores)
     tile threads, in turns (1, T, T, 1), with the host's core count.

The last two lines are a JSON record of the kernels and the contract
line {"ok": true, "device": {...}}.  Without a CUDA device, or without
the repository beside this file, it exits non-zero and prints no result.

    python3 chip_smoke.py --baseline DIR

runs only phase 5's timings of the two loop filters (K1's frame and step,
K7's pair, p1_04's planes and its step split) and phase 6's of the page
expansion, with the package of DIR (a checkout of another commit, such as
the parent) in place of this one, so that one chip call times both
commits with the same code, in turns.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
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
           ("ll02_96x64_lossless_inter", 8, False),
           ("xl01_3840x2176_t4", 6, False))
WARM = ("nc03_640x360_occl", "hd01_1920x1080_t4", "cp01_352x288_compound",
        "large/hb01_1920x1080_10b", "xl01_3840x2176_t4")
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
KERNELS = ("loopfilter", "tileprobe", "intra", "residual", "mc", "pages")
# loopfilter.cu built without K7's write-back, for the split of its step
LF422_SPLIT_DEFINES = ("VP9_LF422_NO_WRITEBACK=1",)
# tile steps on the critical path of a 1920x1088 frame (K1) and of its
# 4:2:2 chroma, two 1088x960 planes (K7): cols + rows - 1 (the kernels
# hand off in half steps: csrc/loopfilter.cu)
N_STEPS = 30 + 17 - 1
# mc.cu built with other register caps (blocks an SM at least; the
# source's own is 4), timed beside it in phase 5
MC_CAP_BUILDS = tuple((f"VP9_MC_MIN_BLOCKS={b}",) for b in (1, 6, 8))
# intra kernel cases: (bd, ha, wa, ich, block size code of planes 0..2,
# chunks kept): every block size at every bit depth, the 1080p canvas
# with 256-unit chunks, a single chunk, and chunks of 4x4 units only
INTRA_CASES = [(bd, 64, 64, 64, codes, None) for bd in (8, 10, 12)
               for codes in ((0, 1, 2), (3, 2, 1))] + [
                   (10, 1088, 1920, 256, (0, 3, 1), None),
                   (10, 64, 64, 64, (3, 2, 1), 1),
                   (8, 256, 256, 64, (0, 0, 0), None)]
KEYFRAME = "hd01_1920x1080_t4"        # the timed intra and residual inputs
# MC cases beyond kernel_cases.MC_CASES (its fields): the 1080p canvas
# with the chunk lengths of HD and above, and a batched round of 16
# 640x384 frames
MC_BIG_CASES = ((10, (1, 1), 1088, 1920, (0, 0), 1, (1024, 512, 256, 128,
                                                     128), True),
                (8, (1, 1), 384, 640, (0, 0), 16, None, False))
# phase 6: the streams whose uploads are checked (with 16 x nc03), the
# uploads timed ((run, call index): label; the first is the kernels
# line's row), and the streams parsed with 1 and with several threads
UPLOAD_STREAMS = (("nc03_640x360_occl", 12), ("hd01_1920x1080_t4", 4),
                  ("xl01_3840x2176_t4", 6))
UPLOAD_TIMED = {("hd01", 0): "hd01 keyframe",
                ("hd01", 1): "hd01 inter frame",
                ("16 x nc03", 1): "16 x nc03 inter round"}
THREAD_STREAMS = ("hd01_1920x1080_t4", "xl01_3840x2176_t4")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor float32 rate; the
                                # table has no int32 rate, so it stands in


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def ptxas_usage(log: str):
    """(kernel, "N registers, M bytes smem, spills") for each entry function
    in an nvcc -Xptxas -v log."""
    import re
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spills = f"{m.group(1)} + {m.group(2)} bytes spilled"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            out.append((fn, f"{m.group(1)} registers, {m.group(2) or 0} "
                            f"bytes smem, {spills}"))
            fn = None
    return out


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


# int32 operations per predicted pixel of csrc/intra.cu, counted on its
# heaviest modes: the predictor's taps and rounding (6), the residual add
# and the clip (3), the write's bounds test (3)
INTRA_PIXEL_OPS = 12


def intra_bound_ms(chunks, chunk_bs, n_chunks):
    """(bound ms, "bytes" or "operations") of one intra pass: per record
    read (8 bytes); per unit that is not padding its above row, left
    column and top-left (3 bs + 1 int32) and its residual (bs^2 int32)
    read once and its pixels (bs^2 int32) written once, against
    INTRA_PIXEL_OPS per pixel."""
    rec = np.asarray(chunks[:n_chunks])
    bs = (4 << (np.asarray(chunk_bs[:n_chunks]).astype(np.int64) & 3))
    live = (rec[:, :, 1].astype(np.int64) & 0x7FFF) != 0
    bs_u = np.broadcast_to(bs[:, None], live.shape)[live]
    px = int((bs_u * bs_u).sum())
    return bound(rec.size * 2 + 4 * int((3 * bs_u + 1).sum()) + 8 * px,
                 px * INTRA_PIXEL_OPS)


class _OpCount:
    """An operand of the reference's 1-D butterflies that counts the int32
    operations done on it."""
    ops = 0

    def _op(self, *_):
        _OpCount.ops += 1
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __rshift__ = __neg__ = _op


class _OpDomain:
    """The WRAPLOW domain of csrc/residual.cu: a wrap is two shifts, a
    round shift an add, a shift and a wrap."""

    @staticmethod
    def w(x):
        return x

    @staticmethod
    def n(x):
        _OpCount.ops += 2
        return x

    def rs(self, x):
        _OpCount.ops += 2
        return self.n(x)


class _OpRows:
    def __getitem__(self, k):
        return _OpCount()


def _ops_1d(tx, adst):
    """int32 operations of one 1-D pass of size 4 << tx (the WHT's when
    adst is "wht")."""
    from cuda_vp9_torch.ops.ref import transforms as T

    class XP:
        @staticmethod
        def stack(xs, axis):
            return xs

    _OpCount.ops = 0
    if adst == "wht":
        return 4 + 10 + 2 * 4           # input shift, the butterfly, wraps
    T._1D[(tx, int(adst))](_OpRows(), _OpDomain(), lambda x: x, XP)
    return _OpCount.ops


def residual_work(buckets, bd):
    """(bytes, operations) of the residual kernel's launches on these
    buckets [(tx, coef, pos, kind), ...] (host int16 arrays of one
    stream): each record's coefficient words (twice above 8 bits) and
    cpos read once, each unit that is not padding written once (n^2
    int32); its expansion (one op a coefficient), the row and column
    passes its tx_type selects, and the final round shift (2 ops a
    pixel)."""
    nbytes = ops = 0
    for tx, coef, pos, kind in buckets:
        n = 4 << tx
        pos = np.asarray(pos).reshape(-1, 4)
        live = pos[:, 1] != 0
        nbytes += coef.size * 2 * (2 if bd > 8 and kind != 2 else 1) \
            + pos.size * 2 + int(live.sum()) * n * n * 4
        ops += coef.size
        tt = pos[live, 3].astype(np.int64) & 3
        if kind == 1:
            ops += int(live.sum()) * 2 * n * _ops_1d(0, "wht")
            continue
        for t in range(4):
            cnt = int((tt == t).sum())
            row = _ops_1d(tx, tx < 3 and bool(t & 2))
            col = _ops_1d(tx, tx < 3 and bool(t & 1))
            ops += cnt * (n * (row + col) + 2 * n * n)
    return nbytes, ops


def keyframe_flat(name):
    """(flat, layout, mi_rows, mi_cols, n_waves) of frame 0 of a fixture,
    packed by the port's native packer at the full tier, as TorchRecon
    packs it, and its intra wave count (plan.build_intra_units); the
    frame itself is decoded by a TorchRecon on the card."""
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.runtime import fused
    from cuda_vp9_torch.runtime import plan as planlib
    from cuda_vp9_torch.runtime.pipeline import TorchRecon
    recon, out = TorchRecon("cuda"), {}

    def recon_fn(plan, refs):
        h = plan.hdr
        _, caps, layout = fused.get_frame_step(h.mi_rows, h.mi_cols, "full")
        out.update(flat=plan.native_parser.pack(plan, refs, caps, layout),
                   layout=layout, mi=(h.mi_rows, h.mi_cols),
                   waves=planlib.build_intra_units(plan)[1])
        return recon(plan, refs)

    NativeVp9Decoder(recon_fn=recon_fn).decode(packets(name)[0])
    return out["flat"], out["layout"], *out["mi"], out["waves"]


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


def decode(name: str, n_frames: int, threads: int = 1):
    """Decode one fixture through the codec API on the card, with
    `threads` parse threads; returns (md5s, recon, seconds).  The MD5s
    read every frame back to the host, so the time covers the device
    work."""
    from cuda_vp9_torch.tools.profile_decode import decode as decode_md5

    t0 = time.perf_counter()
    md5s, recon = decode_md5(str(FIXTURES / f"{name}.ivf"), "cuda", n_frames,
                             threads=threads)
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


def multi_stream_paths(LF, counted):
    """Phase 4c: BatchedTorchDecoder on 16 x nc03, the 48-round mix and
    in02 + sc01, then MultiStreamDecoder, each with the kernel counts (of
    the modules `counted`, LF among them) set to 0 before it; exits on a
    failed check.  Returns the stream-axis kernel's launches on 16 x
    nc03."""
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.runtime.multistream import MultiStreamDecoder
    from cuda_vp9_torch.runtime.pipeline import TorchRecon
    from cuda_vp9_torch.utils.md5 import frame_md5
    lfs_launches = None
    for label, names, rounds in (("16 x nc03", NC03_BATCH, None),
                                 ("lg01 + in01 + kf02", MIX, None),
                                 ("in02 + sc01", RESIZE, 6)):
        for k in counted:
            k.reset_counts()
        md5s, bd, dt = batched(names, rounds)
        _, _, _, IN, RS, MC, PG = counted
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
              f"{want}), intra launches {IN.launches} ({IN.chunks} chunks) in "
              f"{IN.host_calls} host calls, residual launches {RS.launches} "
              f"({RS.buckets} buckets), mc launches "
              f"{MC.launches} ({MC.phases} phases) in "
              f"{MC.host_calls} host calls, expand_pages launches "
              f"{PG.launches} (flats sent dense "
              f"{bd.uploader.dense_frames} of {bd.uploader.frames}), "
              f"plain calls "
              f"{[k.plain_calls for k in counted]}, cold {dt:.2f} s "
              f"({dt / max(bd.rounds, 1):.3f} s a round)")
        if bad or any(k.plain_calls for k in counted) or any(
                len(m) != len(golden_md5(n)[:rounds]) for n, m in zip(
                    names, md5s)):
            raise SystemExit(f"batched {label}: decode check failed")
        if not 0 < IN.launches == IN.host_calls <= bd.rounds + unbatched \
                or not 0 < RS.launches <= bd.rounds + unbatched \
                or not 0 < MC.launches == MC.host_calls \
                <= bd.rounds + unbatched:
            raise SystemExit(f"batched {label}: the intra, residual or MC "
                             "kernel never ran, or made more than one "
                             "launch (intra, MC: host call) a round")
        if not bd.rounds <= PG.launches <= bd.rounds + unbatched:
            raise SystemExit(f"batched {label}: the page expansion did not "
                             "run once a round (and once a frame outside "
                             "the batch)")
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
    for k in counted:
        k.reset_counts()
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
          f"MD5 equal {[g == golden_md5(n) for g, n in zip(got, MSD)]}, "
          f"expand_pages launches {counted[-1].launches}")
    if any(g != golden_md5(n) for g, n in zip(got, MSD)) \
            or any(st["host"] for st in msd.stats()) \
            or any(k.plain_calls for k in counted) \
            or counted[-1].launches != sum(st["device"]
                                           for st in msd.stats()):
        raise SystemExit("MultiStreamDecoder: decode check failed")
    return lfs_launches


def frame_buf(dev, F):
    """A frame buffer (runtime/fused.frame_buffer) on dev holding F."""
    buf = torch.zeros(F.size + 1, dtype=torch.int32)
    buf[:-1] = torch.from_numpy(F).reshape(-1)
    return buf.to(dev)


def intra_vs_plain(rng, dev, IN, KC) -> int:
    """Phase 2: the persistent intra kernel against intra_pass_plain on
    every case of INTRA_CASES, and its batched form against
    intra_pass_batched_plain on 4 stacked 64x64 frames at bit depths 8,
    10 and 12 (streams with fewer chunks run padding); each pass one host
    call and one launch.  Exits on a difference; returns the largest
    error (0)."""
    for bd, ha, wa, ich, codes, n_max in INTRA_CASES:
        F, R, rec, cbs = KC.intra_frame(rng, ha, wa, bd, ich, codes)
        rec, cbs = rec[:n_max], cbs[:n_max]
        Fk = frame_buf(dev, F)
        Fp = Fk.clone()
        Rt, rt = torch.from_numpy(R).to(dev), torch.from_numpy(rec).to(dev)
        before = (IN.launches, IN.chunks, IN.host_calls)
        IN.intra_pass(Fk, Rt, rt, torch.from_numpy(cbs).to(dev), len(cbs), bd)
        launches, chunks, calls = (a - b for a, b in zip(
            (IN.launches, IN.chunks, IN.host_calls), before))
        IN.intra_pass_plain(Fp, Rt, rt, cbs, len(cbs), bd)
        torch.cuda.synchronize()
        err = int((Fk[:-1] - Fp[:-1]).abs().max())
        changed = int((Fp != frame_buf(dev, F)).sum())
        what = f"{ha}x{wa} bd {bd} block sizes {[4 << c for c in codes]}"
        print(f"intra kernel vs plain {what}: {len(cbs)} chunks of {ich}, "
              f"max_abs_err {err} (tolerance 0), {changed} pixels written, "
              f"{launches} launch ({chunks} chunks) in {calls} host call")
        if err or not changed or (launches, chunks, calls) != (
                1, len(cbs), 1):
            raise SystemExit(f"intra kernel disagrees at {what}")
    for bd in (8, 10, 12):
        F, R, flats, (om, oc, orc, cap) = KC.intra_streams(rng, 4, 64, 64, bd,
                                                           64)
        fl = torch.from_numpy(flats).to(dev)
        args = (fl[:, orc:orc + cap * 64 * 4].view(4, cap, 64, 4),
                fl[:, oc:oc + cap], fl[:, om + 3], int(flats[:, om + 3].max()),
                bd)
        Fk = frame_buf(dev, F)
        Fp = Fk.clone()
        Rt = torch.from_numpy(R).to(dev)
        before = (IN.launches, IN.chunks, IN.host_calls)
        IN.intra_pass_batched(Fk, Rt, *args)
        launches, chunks, calls = (a - b for a, b in zip(
            (IN.launches, IN.chunks, IN.host_calls), before))
        IN.intra_pass_batched_plain(Fp, Rt, *args)
        torch.cuda.synchronize()
        err = int((Fk[:-1] - Fp[:-1]).abs().max())
        print(f"intra batched kernel vs plain, 4 x 64x64 bd {bd}, chunk "
              f"counts {flats[:, om + 3].tolist()}, chunk 0 block sizes "
              f"{[4 << int(c) for c in flats[:, oc]]}: max_abs_err {err} "
              f"(tolerance 0), {launches} launch ({chunks} chunks) in "
              f"{calls} host call")
        if err or (launches, chunks, calls) != (1, args[3], 1):
            raise SystemExit(f"intra batched kernel disagrees at bd {bd}")
    return 0


def residual_vs_plain(rng, dev, RS, KC) -> int:
    """Phase 2: the one-launch residual kernel against the per-bucket twins
    on whole bucket sets (kernel_cases.residual_frame_case: every bucket,
    the WHT and at 8 bits the two coo buckets, no two units at one
    position) at bit depths 8, 10 and 12, moderate and extreme inputs,
    one stream and three, on a random residual frame (untouched pixels
    count).  Exits on a difference; returns the largest error (0)."""
    ha = wa = 512
    for bd in (8, 10, 12):
        for streams in (1, 3):
            for extreme in (False, True):
                cases = KC.residual_frame_case(rng, streams, bd, ha, wa, 160,
                                               extreme)
                src, bset = KC.pack_buckets(cases)
                src = torch.from_numpy(src).to(dev)
                R0 = torch.from_numpy(rng.integers(
                    -999, 1000, 3 * streams * ha * wa + 1).astype(
                        np.int32)).to(dev)
                Rk, Rp = R0.clone(), R0.clone()
                before = (RS.launches, RS.buckets)
                RS.residual_frame(Rk, src, bset, ha, wa, bd)
                launches, buckets = RS.launches - before[0], \
                    RS.buckets - before[1]
                RS.residual_frame_plain(Rp, src, bset, ha, wa, bd)
                torch.cuda.synchronize()
                err = int((Rk[:-1] - Rp[:-1]).abs().max())
                what = (f"bd {bd}, {streams} stream(s), extreme {extreme}: "
                        f"{len(bset)} buckets (units "
                        f"{[b.n for b in bset]})")
                print(f"residual kernel vs plain, {what}: max_abs_err {err} "
                      f"(tolerance 0), {launches} launch for {buckets} "
                      f"buckets")
                if err or not (Rp != R0).any() or (launches, buckets) != (
                        1, len(bset)):
                    raise SystemExit(f"residual kernel disagrees: {what}")
    return 0


def keyframe_timings(dev, card, IN, RS, fused, _build):
    """Phase 5: the residual and the intra kernels against their twins on
    KEYFRAME's frame 0 as the frame step feeds them (CUDA events): its
    residual buckets into a zero frame buffer (one launch), then its
    intra chunks on a zero frame with that residual (one persistent
    launch); both results held against the twins'.  Also the intra
    pass's two floors: n_chunks hand-offs of the persistent chain with
    no work (vp9_intra_chain_floor), and n_chunks dependent empty
    launches (vp9_empty_launches, the floor of the design before it);
    and ptxas's registers, spills and shared memory of both kernels.
    Returns ((ms, plain_ms, bound, by), (ms, plain_ms, bound, by)) for
    intra and residual."""
    flat, layout, mi_rows, mi_cols, n_waves = keyframe_flat(KEYFRAME)
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    flat_d = torch.from_numpy(flat).to(dev)
    misc = layout.view(flat, "misc").astype(np.int64)

    def seg16(name, n):
        off, shape = layout.segs[name]
        shape = (n,) + tuple(shape[1:])
        return flat_d[off:off + int(np.prod(shape))].view(shape)[None]

    def trips(slot):
        return int(misc[slot])

    def residual(R, plain=False):
        fused.residual_stage(
            R, flat_d[None], trips, layout.segs, ha, wa, 8, False,
            *((RS.residual_frame_plain,) if plain else ()))

    def zero():
        return fused.frame_buffer(ha, wa, dev)

    Rk, Rp = zero(), zero()
    before = (RS.launches, RS.buckets)
    residual(Rk)
    n_launch, n_res = RS.launches - before[0], RS.buckets - before[1]
    residual(Rp, plain=True)
    if not torch.equal(Rk, Rp) or n_launch != 1:
        raise SystemExit(f"{KEYFRAME} keyframe: residual kernel != plain, "
                         f"or not one launch ({n_launch})")
    rs_ms = cuda_ms(residual, 20, zero)
    rs_plain_ms = cuda_ms(lambda R: residual(R, True), 3, zero)
    # the host's share: the wrapper call's own time (gather, table, ctypes
    # call), which enqueues the launch and returns
    host = []
    for _ in range(20):
        R = zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        residual(R)
        host.append((time.perf_counter() - t0) * 1e3)
    rs_host_ms = statistics.median(host)
    # the device's share: 50 launches of the frame's table, back to back
    # in one event window (at most the kernel's time each, unless the
    # enqueue is slower than the kernel)
    table, P, _scans = RS.bucket_table(
        Rk, flat_d[None], fused.residual_buckets(trips, layout.segs, 8,
                                                 False), ha, wa, 8)
    fn = RS._lib()

    def launches50(R):
        for _ in range(50):
            _build.call(fn, dev, R.data_ptr(), table.ctypes.data, len(table),
                        P, ha, wa, 8)

    launches50(zero())
    rs_dev_ms = cuda_ms(launches50, 5, zero) / 50
    buckets = []
    for seg, slot, chunk, tx, kind in coeff_buckets():
        n = int(misc[slot]) * chunk
        if n and f"coeff_{seg}" in layout.segs:
            buckets.append((tx, layout.view(flat, f"coeff_{seg}")[:n],
                            layout.view(flat, f"cpos_{seg}")[:n], kind))
    rs_bound, rs_by = bound(*residual_work(buckets, 8))

    n_intra = int(misc[3])
    chunks = seg16("intra", n_intra)[0]
    cbs = layout.view(flat, "chunk_bs")
    cbs_d = seg16("chunk_bs", n_intra)[0]
    R = Rk[:-1].view(3, ha, wa)
    Fk, Fp = zero(), zero()
    before = (IN.launches, IN.chunks)
    IN.intra_pass(Fk, R, chunks, cbs_d, n_intra, 8)
    in_launch = IN.launches - before[0]
    in_plain_ms = cuda_ms(lambda F: IN.intra_pass_plain(F, R, chunks, cbs,
                                                        n_intra, 8), 1,
                          lambda: Fp)
    if not torch.equal(Fk[:-1], Fp[:-1]) or in_launch != 1 \
            or IN.chunks - before[1] != n_intra:
        raise SystemExit(f"{KEYFRAME} keyframe: intra kernel != plain, or "
                         f"not one launch ({in_launch})")
    in_ms = cuda_ms(lambda F: IN.intra_pass(F, R, chunks, cbs_d, n_intra, 8),
                    20, zero)
    in_bound, in_by = intra_bound_ms(layout.view(flat, "intra"), cbs,
                                     n_intra)
    ich = chunks.shape[1]
    IN.chain_floor(1, ich, n_intra, dev)
    floor_ms = cuda_ms(lambda _: IN.chain_floor(1, ich, n_intra, dev), 20)
    empty = IN._lib("vp9_empty_launches")

    def chain(_):
        if empty(2000, torch.cuda.current_stream().cuda_stream):
            raise SystemExit("vp9_empty_launches failed")

    chain(None)
    gap_ms = cuda_ms(chain, 5) / 2000
    print(f"{KEYFRAME} keyframe residual, {n_res} buckets in {n_launch} "
          f"launch: kernel {rs_ms:.4f} ms (the wrapper call's host time "
          f"{rs_host_ms:.4f} ms; one of 50 back-to-back launches of its "
          f"table {rs_dev_ms:.4f} ms), plain {rs_plain_ms:.3f} ms, bound "
          f"{rs_bound:.5f} ms ({rs_by}); equal to the plain result [{card}]")
    print(f"{KEYFRAME} keyframe intra, {n_intra} chunks of {ich} "
          f"({n_waves} waves) in {in_launch} launch: kernel {in_ms:.3f} ms "
          f"({in_ms / n_intra * 1e3:.2f} us a chunk), plain "
          f"{in_plain_ms:.1f} ms (one run), bound {in_bound:.5f} ms "
          f"({in_by}); hand-off floor (the chain with no work) "
          f"{floor_ms:.3f} ms = {floor_ms / n_intra * 1e3:.3f} us a chunk; "
          f"launch floor of the per-chunk design: one dependent empty "
          f"launch {gap_ms * 1e3:.3f} us, {n_intra} x that = "
          f"{n_intra * gap_ms:.3f} ms; equal to the plain result [{card}]")
    for k, fn in (("intra", "intra_pass_kernel"),
                  ("residual", "residual_kernel")):
        for name, line in ptxas_usage(_build.build_log.get(k, "")):
            if fn in name:
                print(f"ptxas {k}.cu {name}: {line}")
    return ((in_ms, in_plain_ms, in_bound, in_by),
            (rs_ms, rs_plain_ms, rs_bound, rs_by))


def coeff_buckets():
    """(segment, misc trip slot, chunk, tx, kind) of every coefficient
    bucket (kind 0) and of the two coo buckets (kind 2), in the step's
    order."""
    from cuda_vp9_torch.runtime import pack
    return [(name, pack.MISC_TRIP[name], pack.COEFF_CHUNK[name], tx, 0)
            for name, tx, _ in pack.COEFF_BUCKETS] + [
                ("tx3c", pack.MISC_TRIP_TX3C, pack.CHUNK_TX3C, 3, 2),
                ("tx3cs", pack.MISC_TRIP_TX3CS, pack.CHUNK_TX3CS, 3, 2)]


# int32 operations per pixel of the MC stage: a multiply and an add per
# nonzero tap, the rounding (an add and a shift) and the clip (2) of each
# pass's pixel, the landing's bounds tests (4) per output pixel, and a
# compound average's (3); the mask phase's bit test (2), add and clip (3)
# per masked pixel
MC_TAP_OPS = 2
MC_ROUND_OPS = 4
MC_LAND_OPS = 4
MC_AVG_OPS = 3
MC_MASK_OPS = 5


def mc_work(pool, kernels, flats, classes, mask, ha, wa):
    """(bytes, operations) of one single-stream mc_frame call on these
    arguments (device tensors; flats [1, nflat]), counting what this
    call's data needs: each class's records and headers read once and the
    filter table once; of the pool, the distinct source pixels that a
    nonzero tap of a live tile reaches, after the crop clamps, read once
    (a phase-0 pass is a copy, and neighbouring tiles share their
    aprons); the distinct destination pixels written once, and those that
    a compound second averages into and no first of this call writes
    read once; per live tile, the operations of its nonzero taps on the
    intermediate pixels that its vertical taps reach and on its output
    pixels, with MC_ROUND_OPS, MC_LAND_OPS and MC_AVG_OPS; the mask
    phase: its words read once, R read once over the masked pixels, and
    F read and written once over those that no MC phase writes, with
    MC_MASK_OPS a masked pixel."""
    from cuda_vp9_torch.ops.cuda import mc as MC
    dev = pool.device
    S, _, pha, pwa = pool.shape
    src = torch.zeros(pool.numel(), dtype=torch.bool, device=dev)
    firsts = torch.zeros(3 * ha * wa, dtype=torch.bool, device=dev)
    seconds = torch.zeros_like(firsts)
    nz = kernels.long() != 0                        # [4, 16, 8]
    k8 = torch.arange(8, device=dev)
    nbytes, ops = kernels.nbytes, 0

    def live(c, rw, valid):
        """The live records [T, rw] (int64) of class c, their chunk
        headers and whether each is a first prediction."""
        units, hdrs, r0 = MC.class_views(flats, c)
        u = units[0].reshape(-1, rw).long()
        hd = hdrs[0].long().repeat_interleave(c.ch, 0)
        first = torch.arange(len(u), device=dev) < int(r0[0]) * c.ch
        keep = u[:, valid] != 0
        nb = units[0].nbytes + hdrs[0].nbytes
        return u[keep], hd[keep], first[keep], nb

    def land(plane, dy, dx, first, w):
        r = torch.arange(w, device=dev)
        y = dy[:, None, None] + r[:, None]
        x = dx[:, None, None] + r
        ok = (y >= 0) & (y < ha) & (x >= 0) & (x < wa) \
            & ((plane >= 0) & (plane <= 2))[:, None, None]
        lin = (plane[:, None, None] * ha + y) * wa + x
        firsts[lin[ok & first[:, None, None]]] = True
        seconds[lin[ok & ~first[:, None, None]]] = True

    def reach(taps, w):
        """[T, w + 7]: the window positions that output positions 0..w-1
        reach through these nonzero taps [T, 8]."""
        m = torch.zeros(len(taps), w + 7, dtype=torch.bool, device=dev)
        for k in range(8):
            m[:, k:k + w] |= taps[:, k:k + 1]
        return m

    for c in (c for c in classes if c.w):
        w = c.w
        u, hd, first, nb = live(c, 4, 1)
        filt = (u[:, 0] >> 13) & 3
        tx, ty = nz[filt, u[:, 3] & 15], nz[filt, u[:, 2] & 15]   # [T, 8]
        dx, dy = u[:, 0] & 0x1FFF, u[:, 1] - 1
        t = torch.arange(w + 7, device=dev)
        rows = torch.minimum((dy + (u[:, 2] >> 4) - 3)[:, None] + t,
                             hd[:, 4:5].clamp(1, pha) - 1).clamp(min=0)
        cols = torch.minimum((dx + (u[:, 3] >> 4) - 3)[:, None] + t,
                             hd[:, 3:4].clamp(1, pwa) - 1).clamp(min=0)
        base = (hd[:, 0].clamp(0, S - 1) * 3 + hd[:, 1].clamp(0, 2)) * pha
        need_r, need_c = reach(ty, w), reach(tx, w)
        lin = ((base[:, None] + rows) * pwa)[:, :, None] + cols[:, None, :]
        src[lin[need_r[:, :, None] & need_c[:, None, :]]] = True
        land(hd[:, 1], dy, dx, first, w)
        nbytes += nb
        ops += int((need_r.sum(1) * w * (MC_TAP_OPS * tx.sum(1)
                                         + MC_ROUND_OPS)).sum()) \
            + int((w * w * (MC_TAP_OPS * ty.sum(1) + MC_ROUND_OPS
                            + MC_LAND_OPS)).sum()) \
            + int((~first).sum()) * MC_AVG_OPS * w * w
    for c in (c for c in classes if not c.w):
        u, hd, first, nb = live(c, 16, 2)
        filt = u[:, 8].clamp(0, 3)
        c4 = torch.arange(4, device=dev)
        xq4 = u[:, 6:7] + c4 * u[:, 12:13].clamp(0, 32)           # [T, 4]
        yq4 = u[:, 7:8] + c4 * u[:, 13:14].clamp(0, 32)
        tx = nz[filt[:, None], xq4 & 15]                           # [T, 4, 8]
        ty = nz[filt[:, None], yq4 & 15]
        cols = torch.minimum(
            (u[:, 4:5] + (xq4 >> 4))[:, :, None] + k8 - 3,
            u[:, 9].clamp(1, pwa)[:, None, None] - 1).clamp(min=0)
        rows = torch.minimum(u[:, 5:6] - 3 + torch.arange(14, device=dev),
                             u[:, 10:11].clamp(1, pha) - 1).clamp(min=0)
        # the intermediate rows that a nonzero vertical tap reaches
        trow = ((yq4 >> 4)[:, :, None] + k8).clamp(0, 13)          # [T, 4, 8]
        need_r = torch.zeros(len(u), 14, dtype=torch.bool, device=dev)
        tile = torch.arange(len(u), device=dev)[:, None, None]
        need_r[tile.expand_as(trow)[ty], trow[ty]] = True
        base = (hd[:, 0].clamp(0, 7) * 3 + hd[:, 1].clamp(0, 2)) * pha
        lin = ((base[:, None] + rows) * pwa)[:, :, None, None] \
            + cols[:, None]                                        # [T, 14, 4, 8]
        src[lin[need_r[:, :, None, None] & tx[:, None]]] = True
        land(u[:, 0], u[:, 2] - 1, u[:, 1], first, 4)
        nbytes += nb
        ops += int((need_r.sum(1) * (MC_TAP_OPS * tx.sum((1, 2))
                                     + 4 * MC_ROUND_OPS)).sum()) \
            + int((4 * (MC_TAP_OPS * ty.sum(2) + MC_ROUND_OPS
                        + MC_LAND_OPS)).sum()) \
            + int((~first).sum()) * MC_AVG_OPS * 16
    if mask is not None:
        words = MC.mask_words(flats, mask)
        m = ((words[0].long()[..., None] >> torch.arange(16, device=dev))
             & 1).reshape(mask.mi_rows, -1)[:, :mask.mi_cols] != 0
        masked = torch.zeros(3, ha, wa, dtype=torch.bool, device=dev)
        for p in range(3):
            gy, gx = 8 >> (mask.ssy if p else 0), 8 >> (mask.ssx if p else 0)
            cm = m.repeat_interleave(gy, 0).repeat_interleave(gx, 1)
            masked[p, :cm.shape[0], :cm.shape[1]] = cm
        masked = masked.reshape(-1)
        # a masked pixel that an MC phase writes costs only R's read: the
        # launch reads F back through L2 and writes it once (counted
        # below); one that no phase writes reads and writes F as well
        landed = int((masked & (firsts | seconds)).sum())
        n_masked = int(masked.sum())
        nbytes += words.nbytes + 4 * landed + 12 * (n_masked - landed)
        ops += MC_MASK_OPS * n_masked
    nbytes += 4 * int(src.sum() + (firsts | seconds).sum()
                      + (seconds & ~firsts).sum())
    return nbytes, ops


def mc_vs_plain(dev, MC, KC) -> int:
    """Phase 2: the MC kernel against its plain twin on every case of
    kernel_cases.MC_CASES and MC_BIG_CASES, each with its mask (the mask
    phase after the classes), and on the first case's mask alone (no
    class): mc_frame against mc_frame_plain, for one stream or several;
    one host call and one launch a call, with the phases the table
    lists.  Prints, per case, the pixels that more than one phase writes:
    phases of two tile classes, a class's seconds over its own firsts,
    the mask phase over MC's pixels; fails unless some case has pixels
    of two classes (so that the class-to-class hand-offs' order decides
    a result).  Exits on a difference; returns the largest error (0)."""
    from cuda_vp9_torch import models
    rng = np.random.default_rng(606)
    kern = torch.as_tensor(np.asarray(models.FILTER_KERNELS, np.int32),
                           device=dev)
    runs, overlaps = [], []
    for case in list(KC.MC_CASES) + list(MC_BIG_CASES):
        bd, ss, ha, wa, pad, n, chunks, scaled = case
        c = KC.mc_case(rng, bd, ss, ha, wa, pad, n, chunks, scaled)
        what = (f"{n} x {ha}x{wa} bd {bd} chroma {ss} pool +{pad} chunks "
                f"{chunks or KC.MC_CHUNKS} scaled {scaled}")
        runs.append((c, what, False))
        if not runs[1:]:
            runs.append((c, what + ", the mask alone", True))
    for c, what, mask_only in runs:
        n = len(c.flats)
        flats = c.flats[:1] if n == 1 else c.flats
        fl = torch.from_numpy(flats).to(dev)
        if n == 1:
            pool, active = c.pool[8 * int(c.active[0]):][:8], None
            classes, mask = KC.mc_args(c, fl, 0)
        else:
            pool, active = c.pool, torch.from_numpy(c.active).to(dev)
            classes, mask = KC.mc_args(c, fl)
        if mask_only:
            classes = []
        args = (frame_buf(dev, c.R), torch.from_numpy(pool).to(dev), kern, fl,
                classes, mask, active, c.bd, c.ha, c.wa)
        F0 = frame_buf(dev, c.F)
        want_phases, want_scaled = KC.mc_phases(classes, mask)
        overlap = KC.phase_overlap(c, flats, classes, mask)
        overlaps.append(overlap.cross)
        Fk, Fp = F0.clone(), F0.clone()
        before = (MC.launches, MC.host_calls, MC.phases, MC.scaled_calls)
        MC.mc_frame(Fk, *args)
        launches, calls, phases, scaled_calls = (
            a - b for a, b in zip((MC.launches, MC.host_calls, MC.phases,
                                   MC.scaled_calls), before))
        MC.mc_frame_plain(Fp, *args)
        torch.cuda.synchronize()
        err = int((Fk[:-1] - Fp[:-1]).abs().max())
        changed = int((Fp != F0).sum())
        print(f"mc kernel vs plain {what}: max_abs_err {err} (tolerance 0), "
              f"{changed} pixels written; pixels written by more than one "
              f"phase: {overlap.cross} by two classes, {overlap.seconds} by "
              f"seconds over their class's firsts, {overlap.mask} by the "
              f"mask over MC; {launches} launch of {phases} phases (want "
              f"{want_phases}, scaled class {bool(scaled_calls)}) in "
              f"{calls} host call")
        if err or not changed or launches != 1 or calls != 1 \
                or phases != want_phases \
                or bool(scaled_calls) != want_scaled or Fk[-1] != F0[-1]:
            raise SystemExit(f"mc kernel disagrees at {what}")
    if not any(overlaps):
        raise SystemExit("no MC case writes a pixel from two tile classes: "
                         "the class-to-class hand-offs' order went untested")
    return 0


def capture_mc(name, n_frames, key):
    """Decode `name` on the card with the frame step's mc_frame watched,
    and return the arguments of the call that key(index, live unscaled
    tiles, live scaled tiles) ranks highest (None: not a candidate), its
    frame buffer as it was before the call.  The flats and the active
    list are views of the upload's buffers, which the next frame reuses,
    so they are kept as copies."""
    from cuda_vp9_torch.ops.cuda import mc as MC
    from cuda_vp9_torch.runtime import fused
    real, best, calls = fused.mc_frame, {}, [0]

    def spy(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active, bd, ha,
            wa):
        live = [0, 0]
        for c in classes:
            units = MC.class_views(flats, c)[0]
            live[c.w == 0] += int((units[..., 1 if c.w else 2] != 0).sum())
        k = key(calls[0], *live)
        calls[0] += 1
        if k is not None and ("key" not in best or k > best["key"]):
            best.update(key=k, args=(
                Fbuf.clone(), Rbuf.clone(), pool.clone(), kernels,
                flats.clone(), classes, mask,
                None if active is None else active.clone(), bd, ha, wa),
                        frame=calls[0] - 1, live=tuple(live))
        return real(Fbuf, Rbuf, pool, kernels, flats, classes, mask, active,
                    bd, ha, wa)

    fused.mc_frame = spy
    try:
        decode(name, n_frames)
    finally:
        fused.mc_frame = real
    return best


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_ms(fn, setup, reps=20) -> float:
    """Median milliseconds of the host's own time in fn(setup()): the
    call enqueues its work and returns."""
    times = []
    for _ in range(reps):
        x = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, setup, reps: int, kernel: str):
    """Median device milliseconds of the kernel whose name holds `kernel`
    in fn(setup()), from torch.profiler's CUDA trace over reps runs (the
    kernel alone, without the host's enqueue), or None when the trace
    holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    xs = [setup() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs:
            fn(x)
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if kernel in e.name and e.device_type == DeviceType.CUDA]
    return statistics.median(times) / 1e3 if times else None


def mc_timings(card, MC, _build):
    """Phase 5: the MC kernel against its twin (CUDA events) on nc03's
    busiest inter frame and hd01's first inter frame, mask phase
    included, on cp01's busiest scaled frame (the scaled class alone), and
    on nc03's busiest frame's mask alone, as the frame step feeds it; each
    result held against the twin's.  Beside each: the chain floor (the
    same launch with no work, vp9_mc_chain_floor), the wrapper call's
    host time, and the torch mask add that the last phase replaced
    (`MC.mask_add`, CUDA events and host clock); and the kernel built
    with each register cap of MC_CAP_BUILDS, held against the twin and
    timed the same way.  Prints ptxas's registers, spills and shared
    memory of each build.  Returns {label: (ms, plain_ms, bound, by)}."""
    from cuda_vp9_torch.tools import kernel_cases as KC
    rows, captured = {}, {}
    for label, name, n, key, part in (
            ("nc03 busiest", "nc03_640x360_occl", 12,
             lambda i, u, s: u + s if u + s else None, "all"),
            ("hd01 first inter", "hd01_1920x1080_t4", 4,
             lambda i, u, s: -i if u + s else None, "all"),
            ("cp01 busiest scaled", "cp01_352x288_compound", 8,
             lambda i, u, s: s if s else None, "scaled"),
            ("nc03 busiest mask", "nc03_640x360_occl", 12,
             lambda i, u, s: u + s if u + s else None, "mask")):
        if name not in captured:
            captured[name] = capture_mc(name, n, key)
        got = captured[name]
        F0, R, pool, kern, flats, classes, mask, active, bd, ha, wa = \
            got["args"]
        if part == "scaled":
            classes, mask = [c for c in classes if c.w == 0], None
        elif part == "mask":
            classes = []
        args = (R, pool, kern, flats, classes, mask, active, bd, ha, wa)

        def run(F, fn=MC.mc_frame):
            fn(F, *args)

        Fk, Fp = F0.clone(), F0.clone()
        run(Fk)
        run(Fp, MC.mc_frame_plain)
        # the twins also write padded records to the trash element
        if not torch.equal(Fk[:-1], Fp[:-1]):
            raise SystemExit(f"{label}: mc kernel != plain")
        ms = cuda_ms(run, 20, F0.clone)
        plain_ms = cuda_ms(lambda F: run(F, MC.mc_frame_plain), 3, F0.clone)
        floor_ms = cuda_ms(lambda F: run(F, MC.chain_floor), 20, F0.clone)
        host = host_ms(run, F0.clone)
        dev_ms = device_ms(run, F0.clone, 20, "mc_pass_kernel")
        dev_floor = device_ms(lambda F: run(F, MC.chain_floor), F0.clone, 20,
                              "mc_pass_kernel")
        phases = KC.mc_phases(classes, mask)[0]
        b, by = bound(*mc_work(pool, kern, flats, classes, mask, ha, wa))
        torch_mask = ""
        if mask is not None:
            mp = MC.mask_words(flats, mask)[0].to(torch.int32)

            def torch_add(F):
                MC.mask_add(F[:-1].view(3, ha, wa), R[:-1].view(3, ha, wa),
                            mp, mask.mi_rows, mask.mi_cols, bd,
                            (mask.ssx, mask.ssy))

            mask_ms = cuda_ms(torch_add, 20, F0.clone)
            mask_host = host_ms(torch_add, F0.clone)
            torch_mask = (f"; the torch mask add it replaced {mask_ms:.4f} "
                          f"ms (host {mask_host:.4f} ms)")
        caps = []
        for d in MC_CAP_BUILDS:
            with lib_build(_build, "mc", d):
                Fv = F0.clone()
                run(Fv)
                if not torch.equal(Fv[:-1], Fp[:-1]):
                    raise SystemExit(f"{label}: mc kernel with {d[0]} != "
                                     "plain")
                v_ms = cuda_ms(run, 20, F0.clone)
                v_dev = device_ms(run, F0.clone, 20, "mc_pass_kernel")
                caps.append(f"{d[0].split('=')[1]}: {v_ms:.4f} ms, device "
                            f"{fmt_ms(v_dev)}")
        rows[label] = (ms, plain_ms, b, by)
        print(f"{label} (frame {got['frame']}, live tiles {got['live'][0]} "
              f"unscaled, {got['live'][1]} scaled; {part}: {phases} phases "
              f"in one launch): mc kernel {ms:.4f} ms (the wrapper call's "
              f"host time {host:.4f} ms; the launch alone on the device "
              f"{fmt_ms(dev_ms)}), chain floor {floor_ms:.4f} ms (on the "
              f"device {fmt_ms(dev_floor)}), "
              f"plain {plain_ms:.3f} ms, bound {b:.5f} ms ({by})"
              f"{torch_mask}; equal to the plain result [{card}]")
        print(f"{label}: mc kernel by register cap, blocks an SM at least "
              f"(the source's own 4: {ms:.4f} ms, device {fmt_ms(dev_ms)}): "
              + "; ".join(caps) + f"; each equal to the plain result [{card}]")
    for tag in ["mc"] + [_build._tag("mc", d) for d in MC_CAP_BUILDS]:
        for fn, line in ptxas_usage(_build.build_log.get(tag, "")):
            print(f"ptxas {tag} {fn}: {line}")
    return rows


def pages_vs_plain(rng, dev, PG, UP) -> int:
    """Phase 2: the page expansion against expand_pages_plain and the
    dense flats, on one upload of 4 random flats of 2,231 pages (an nc03
    inter flat's count) with 5%, 100%, 0% and 50% of their pages nonzero
    (the second ships dense) and an int16 aux; one launch.  Returns the
    max abs error."""
    n_pages, flats = 2231, []
    for density in (0.05, 1.0, 0.0, 0.5):
        f = rng.integers(-2000, 2000, n_pages * PG.PAGE, dtype=np.int16)
        f.reshape(n_pages, PG.PAGE)[rng.random(n_pages) >= density] = 0
        flats.append(f)
    aux = np.arange(-2, 3, dtype=np.int16)
    up = UP.Uploader(dev)
    st = up.stage(flats, aux)
    buf = up.send(st)
    before = PG.launches
    got = up.expand(st, buf)
    launched = PG.launches - before
    plain = PG.expand_pages_plain(torch.empty_like(got), buf, st.flats,
                                  n_pages)
    want = torch.from_numpy(np.stack(flats)).to(dev)
    err = max(int((got.int() - plain.int()).abs().max()),
              int((got.int() - want.int()).abs().max()))
    dense = [f.map < 0 for f in st.flats]
    aux_ok = torch.equal(up.aux(st, buf).cpu(), torch.from_numpy(aux))
    print(f"expand_pages kernel vs plain and the dense flats, 4 x {n_pages} "
          f"pages: max_abs_err {err} (tolerance 0), sent dense {dense}, "
          f"{st.nbytes} of {4 * n_pages * PG.PAGE_BYTES} bytes sent, "
          f"aux equal {aux_ok}, {launched} launch")
    if err or launched != 1 or dense != [False, True, False, False] \
            or not aux_ok:
        raise SystemExit("page expansion disagrees")
    # past the flats one launch takes: one launch for each MAX_FLATS
    n, n_pages = PG.MAX_FLATS + 6, 37
    flats = [f[:n_pages * PG.PAGE].copy() for f in flats] * (n // 4 + 1)
    flats = flats[:n]
    st = up.stage(flats)
    buf = up.send(st)
    before = PG.launches
    got = up.expand(st, buf)
    launched = PG.launches - before
    err2 = int((got.int() - torch.from_numpy(np.stack(flats)).to(dev).int()
                ).abs().max())
    print(f"expand_pages kernel vs the dense flats, {n} x {n_pages} pages: "
          f"max_abs_err {err2} (tolerance 0), {launched} launches")
    if err2 or launched != 2:
        raise SystemExit("page expansion disagrees past MAX_FLATS flats")
    return max(err, err2)


def one_gather(buf, flats, n_pages):
    """(comb, g): every flat's pages below one zero page, and the page map
    of the whole upload into comb, so that comb.index_select(0, g) is the
    upload's flats: the one PyTorch call that computes expand_pages."""
    rows = [torch.zeros(1, 512, dtype=torch.int16, device=buf.device)]
    maps, base = [], 1
    for f in flats:
        rows.append(buf[f.pages:f.pages + f.n * 1024].view(
            torch.int16).view(f.n, 512))
        if f.map < 0:
            g = torch.arange(base, base + n_pages, device=buf.device)
        else:
            g = buf[f.map:f.map + 4 * n_pages].view(torch.int32).long()
            g = torch.where(g > 0, g + base - 1, g)
        maps.append(g)
        base += f.n
    return torch.cat(rows), torch.cat(maps)


def capture_uploads(PG, UP, streams, rounds=None):
    """Decode `streams` ((name, frames), ...) and the first `rounds` rounds
    of 16 x nc03 on the card, every frame MD5-exact, with each expansion
    held as it runs against expand_pages_plain on the same upload and
    against the dense host flats.  Returns (calls: run -> [(dense bytes,
    sent bytes, flats sent dense, stage host ms)] per call, kept: the
    uploads of UPLOAD_TIMED as (buf, flats, n_pages, n_flats), bad: flats
    and pages that differ, max abs error)."""
    real_stage, real_expand = UP.Uploader.stage, UP.Uploader.expand
    label, calls, last = [None], {}, {}
    kept, bad = {}, [0, 0, 0]

    def stage(self, flats, aux=None):
        t0 = time.perf_counter()
        st = real_stage(self, flats, aux)
        ms = (time.perf_counter() - t0) * 1e3
        last.update(flats=list(flats))
        calls.setdefault(label[0], []).append(
            (sum(f.nbytes for f in flats), st.nbytes,
             sum(f.map < 0 for f in st.flats), ms))
        return st

    def expand(self, st, buf):
        out = real_expand(self, st, buf)
        A, K = out.shape[0], out.shape[1] // 512
        plain = PG.expand_pages_plain(torch.empty_like(out), buf, st.flats,
                                      K)
        want = torch.from_numpy(np.stack(last["flats"])).to(out.device)
        for other in (plain, want):
            diff = out.view(A, K, 512) != other.view(A, K, 512)
            bad[0] += int(diff.any(2).any(1).sum())
            bad[1] += int(diff.any(2).sum())
            bad[2] = max(bad[2], int((out.int() - other.int()).abs().max()))
        key = (label[0], len(calls[label[0]]) - 1)
        if key in UPLOAD_TIMED:
            kept[UPLOAD_TIMED[key]] = (buf.clone(), st.flats, K, A)
        return out

    UP.Uploader.stage, UP.Uploader.expand = stage, expand
    try:
        for name, n in streams:
            label[0] = name.split("_")[0]
            md5s, _, _ = decode(name, n)
            if md5s != golden_md5(name)[:n]:
                raise SystemExit(f"{name}: MD5 mismatch in phase 6")
        label[0] = "16 x nc03"
        md5s, _, _ = batched(NC03_BATCH, rounds)
        if any(m != golden_md5(NC03_BATCH[0])[:len(m)] for m in md5s):
            raise SystemExit("16 x nc03: MD5 mismatch in phase 6")
    finally:
        UP.Uploader.stage, UP.Uploader.expand = real_stage, real_expand
    n_calls = sum(len(v) for v in calls.values())
    print(f"upload: {n_calls} uploads of "
          f"{', '.join(n.split('_')[0] for n, _ in streams)} and 16 x nc03 "
          f"checked as they ran: flats that differ {bad[0]}, pages that "
          f"differ {bad[1]} (kernel against expand_pages_plain and against "
          f"the dense flats), max_abs_err {bad[2]} (tolerance 0)")
    if bad[0] or bad[1] or bad[2]:
        raise SystemExit("page expansion differs on real flats")
    return calls, kept, bad


def expansion_timings(dev, card, PG, kept):
    """The kernel on each kept upload (CUDA events, median of 20; the
    wrapper's host time and the launch alone on the device beside it)
    against its plain version and one torch.index_select call on the same
    pages, with its bound; returns what -> (ms, plain_ms, bound, by,
    library_ms)."""
    rows = {}
    for what, (buf, flats, K, A) in kept.items():
        out = torch.empty(A * K * 512, dtype=torch.int16, device=dev)
        comb, g = one_gather(buf, flats, K)
        ms = cuda_ms(lambda o: PG.expand_pages(o, buf, flats, K), 20,
                     lambda: out)
        got = out.clone()
        plain_ms = cuda_ms(lambda o: PG.expand_pages_plain(o, buf, flats, K),
                           20, lambda: out)
        lib_ms = cuda_ms(lambda o: torch.index_select(comb, 0, g,
                                                      out=o.view(-1, 512)),
                         20, lambda: out)
        if not torch.equal(got, out):
            raise SystemExit(f"{what}: expand_pages != torch.index_select")
        # the window's two shares: the wrapper's own host time, and the
        # launch alone on the device
        wrapper_ms = host_ms(lambda o: PG.expand_pages(o, buf, flats, K),
                             lambda: out, 100)
        kernel_ms = device_ms(lambda o: PG.expand_pages(o, buf, flats, K),
                              lambda: out, 50, "expand_pages")
        nbytes = 16 * A + A * K * 1024 + sum(
            f.n * 1024 + (0 if f.map < 0 else 4 * K) for f in flats)
        b, by = bound(nbytes, 0)
        rows[what] = (ms, plain_ms, b, by, lib_ms)
        print(f"expand_pages {what} ({A} x {K} pages, "
              f"{sum(f.n for f in flats)} sent): kernel {ms:.4f} ms (the "
              f"wrapper's host time {wrapper_ms:.4f} ms, the launch alone on "
              f"the device {fmt_ms(kernel_ms)}), plain {plain_ms:.4f} ms, "
              f"torch.index_select {lib_ms:.4f} ms, bound {b:.5f} ms ({by}, "
              f"{nbytes} bytes); equal to index_select [{card}]")
    return rows


def upload_phase(dev, card, PG, UP):
    """Phase 6: the upload of nc03, hd01, xl01 and 16 x nc03 (module
    docstring).  Exits on a failed check; returns (ms, plain_ms, bound,
    by, library_ms, max_abs_err) of hd01's keyframe."""
    from cuda_vp9_torch.tools.profile_decode import stage_clock
    calls, kept, bad = capture_uploads(PG, UP, UPLOAD_STREAMS)
    for run, rows in calls.items():
        what = "round" if run.startswith("16") else "frame"
        # the first call of each staging buffer allocates (pins) it
        print(f"upload {run}, per {what}, dense KB -> sent KB: "
              + ", ".join(f"{r[0] / 1024:.0f} -> {r[1] / 1024:.0f}"
                          for r in rows)
              + f"; in all {sum(r[0] for r in rows)} -> "
              f"{sum(r[1] for r in rows)} bytes; flats sent dense "
              f"(dense_frames) {sum(r[2] for r in rows)}; stage (host) ms "
              "per call: " + ", ".join(f"{r[3]:.3f}" for r in rows)
              + f" [{card}]")
    rows = expansion_timings(dev, card, PG, kept)
    spans = ("vp9.parse", "vp9.pack", "vp9.compact", "vp9.upload",
             "vp9.expand", "vp9.readback")
    frames = {name: n for name, n, _ in STREAMS}
    for name, streams in [(w, 1) for w in WARM] + [(NC03_BATCH[0], 16)]:
        n, wall, spent = stage_clock(str(FIXTURES / f"{name}.ivf"), "cuda",
                                     frames[name] if streams == 1 else 0,
                                     streams)
        rest = wall - sum(spent.values())
        print(f"stage clock {streams} x {name}: {n} frames {wall * 1e3:.1f} "
              "ms; " + ", ".join(f"{k} {spent.get(k, 0.0) * 1e3:.1f}"
                                 for k in spans)
              + "; " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in
                                 spent.items() if k not in spans)
              + f"; outside spans {rest * 1e3:.1f} ms [{card}]")
    T = min(4, os.cpu_count() or 1)
    for name in THREAD_STREAMS:
        got = []
        for t in (1, T, T, 1):
            n, wall, spent = stage_clock(str(FIXTURES / f"{name}.ivf"),
                                         "cuda", frames[name], 1, t)
            got.append(f"{t}: {n / wall:.2f} fps, vp9.parse "
                       f"{spent['vp9.parse'] * 1e3:.1f} ms")
        print(f"parse threads {name} (host cores {os.cpu_count()}; stage "
              f"clock, in turns): " + "; ".join(got) + f" [{card}]")
    return rows[next(iter(UPLOAD_TIMED.values()))] + (bad[2],)


@contextmanager
def lib_build(_build, name, defines):
    """The wrappers call the library of csrc/<name>.cu built with
    `defines` while inside."""
    own = _build.load(name)
    _build._libs[name] = _build.load(name, defines)
    try:
        yield
    finally:
        _build._libs[name] = own


def lf_row_ms(dev, LF, mi_cols):
    """Median ms of lf_frame on a random frame one SB row tall (mi grid 8 x
    mi_cols, bd 10): no row waits on another."""
    F, lfm, thr = rand_lf_inputs(np.random.default_rng(5), 8, mi_cols, 10)
    a = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev))

    def fn(f):
        LF.lf_frame(f, *a, 1, mi_rows=8, mi_cols=mi_cols, bd=10)
    Fd = torch.from_numpy(F).to(dev)
    fn(Fd.clone())
    return cuda_ms(fn, 50, Fd.clone)


def lf422_ms(dev, L4, F, maps, reps, want=None):
    """Median ms of lf_chroma_422 on F (bd 10), each timed run held against
    `want` when given."""
    md = [torch.from_numpy(m).to(dev) for m in maps]
    Fd = torch.from_numpy(F).to(dev)
    bad = []

    def held(f):
        bad.append(not torch.equal(f, want))
    L4.lf_chroma_422(Fd.clone(), *md, 1, bd=10)
    ms = cuda_ms(lambda f: L4.lf_chroma_422(f, *md, 1, bd=10), reps,
                 Fd.clone, held if want is not None else None)
    if any(bad):
        raise SystemExit(f"lf_chroma_422: {sum(bad)} of {reps} timed runs "
                         "differ from the plain result")
    return ms


def lf422_timings(rng, dev, card, L4, _build, big, split=True):
    """Phase 5: K7 on two 1088x960 planes (each timed run held against
    phase 2's plain result) and on p1_04's 144x88, and the split of its
    tile step: one tile row of 1 and of 30 tiles (no row waits) and the
    1088x960 pair, each as it is (full), with both edge-bit maps zero
    (loads, syncs and write-back only) and built without the write-back
    (LF422_SPLIT_DEFINES); the hand-off share is what the pair takes
    beyond N_STEPS full steps (split=False: without the third, for a
    source that has no such build).  Returns (ms, plain_ms, bound, by) of
    the pair."""
    F, maps, plain_ms, want = big
    ms = lf422_ms(dev, L4, F, maps, 20, want)
    bound_, by = lf422_bound_ms(F, maps)
    small = rand_422_inputs(rng, *LF422_SHAPES[0], 10)
    s_ms = lf422_ms(dev, L4, *small, 20)
    smd = [torch.from_numpy(m).to(dev) for m in small[1]]
    s_plain_ms = cuda_ms(lambda f: L4.lf_chroma_422_plain(f, *smd, 1, bd=10),
                         3, lambda: torch.from_numpy(small[0]).to(dev))
    print(f"lf_chroma_422 1088x960 planes bd 10 median: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms (one run, phase 2), bound {bound_:.4f} "
          f"ms ({by}); 20 of 20 timed runs equal the plain result; 144x88 "
          f"planes: kernel {s_ms:.4f} ms, plain {s_plain_ms:.3f} ms [{card}]")
    rows = [rand_422_inputs(np.random.default_rng(5), 8, c, 10)
            for c in (8, 240)]
    variants = (("full", (), False), ("edge bits 0", (), True),
                ("no write-back", LF422_SPLIT_DEFINES, False))
    for what, defines, zero in variants[:3 if split else 2]:
        def t(F, maps):
            if zero:
                maps = [np.zeros_like(m) if i < 2 else m
                        for i, m in enumerate(maps)]
            with lib_build(_build, "loopfilter", defines):
                return lf422_ms(dev, L4, F, maps, 50)
        t1, t30 = (t(*x) for x in rows)
        step = (t30 - t1) / 29
        whole = t(F, maps)
        print(f"lf_chroma_422 step split, {what}: one tile step "
              f"{step * 1e3:.2f} us (64x32: {t1:.4f} ms, 64x960: {t30:.4f} "
              f"ms); 1088x960: {whole:.4f} ms = {N_STEPS} steps "
              f"{N_STEPS * step:.4f} ms + {whole - N_STEPS * step:.4f} ms of "
              f"hand-offs and strip loads [{card}]")
    return ms, plain_ms, bound_, by


def baseline(tree: Path) -> int:
    """python3 chip_smoke.py --baseline DIR: phase 5's timings of K1 (one
    1920x1088 frame at bd 10, one SB step) and of K7 (the 1088x960 pair,
    p1_04's planes, the step split as far as DIR's loopfilter.cu builds
    it), and phase 6's of the page expansion (hd01's first two frames and
    16 x nc03's first two rounds, each expansion held against its twin as
    it runs), with the package of DIR, a checkout of another commit, in
    place of this one: the same code times before and after in one call.
    Prints no contract line."""
    sys.path.insert(0, str(tree))
    from cuda_vp9_torch.ops.cuda import _build
    from cuda_vp9_torch.ops.cuda import lf422 as L4
    from cuda_vp9_torch.ops.cuda import loopfilter as LF
    from cuda_vp9_torch.ops.cuda import pages as PG
    from cuda_vp9_torch.runtime import upload as UP

    card = card_line()
    dev = torch.device("cuda")
    print(f"{card}\nbaseline: the package of {tree}")
    split = LF422_SPLIT_DEFINES[0].split("=")[0] in (
        _build.CSRC / "loopfilter.cu").read_text()
    jobs = [("loopfilter", ()), ("pages", ())] + (
        [("loopfilter", LF422_SPLIT_DEFINES)] if split else [])
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: _build.build(*j), jobs))
    for k in ("loopfilter", "pages"):
        for fn, line in ptxas_usage(_build.build_log.get(k, "")):
            print(f"ptxas {k}.cu {fn}: {line}")
    rng = np.random.default_rng(2026)
    F, lfm, thr = rand_lf_inputs(rng, *LF_SHAPES[-1], 10)
    a = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev))
    kw = dict(mi_rows=LF_SHAPES[-1][0], mi_cols=LF_SHAPES[-1][1], bd=10)
    Fd = torch.from_numpy(F).to(dev)
    LF.lf_frame(Fd.clone(), *a, 1, **kw)
    ms = cuda_ms(lambda f: LF.lf_frame(f, *a, 1, **kw), 20, Fd.clone)
    t1, t30 = lf_row_ms(dev, LF, 8), lf_row_ms(dev, LF, 240)
    print(f"lf_frame 1920x1088 bd 10 median: kernel {ms:.4f} ms; one SB "
          f"step {(t30 - t1) / 29 * 1e3:.2f} us [{card}]")
    F, maps = rand_422_inputs(rng, *LF422_SHAPES[1], 10)
    want = torch.from_numpy(F).to(dev)
    L4.lf_chroma_422(want, *(torch.from_numpy(m).to(dev) for m in maps), 1,
                     bd=10)
    # the timed runs are held against the first (the plain run takes
    # tens of seconds; phase 2 holds the kernel against it)
    lf422_timings(rng, dev, card, L4, _build, (F, maps, float("nan"), want),
                  split)
    _, kept, _ = capture_uploads(PG, UP, [(KEYFRAME, 2)], 2)
    expansion_timings(dev, card, PG, kept)
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--baseline"] and len(sys.argv) == 3:
        return baseline(Path(sys.argv[2]).resolve())
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--baseline DIR]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cuda_vp9_torch.ops.cuda import _build
    from cuda_vp9_torch.ops.cuda import intra as IN
    from cuda_vp9_torch.ops.cuda import lf422 as L4
    from cuda_vp9_torch.ops.cuda import loopfilter as LF
    from cuda_vp9_torch.ops.cuda import mc as MC
    from cuda_vp9_torch.ops.cuda import pages as PG
    from cuda_vp9_torch.ops.cuda import residual as RS
    from cuda_vp9_torch.ops.cuda import tileprobe as TP
    from cuda_vp9_torch.runtime import fused
    from cuda_vp9_torch.runtime import upload as UP
    from cuda_vp9_torch.tools import kernel_cases as KC
    from cuda_vp9_torch.tools import tile_probe as probe_tool

    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build the sources, one nvcc each, in parallel
    t0 = time.perf_counter()
    jobs = [(k, ()) for k in KERNELS] + [("mc", d) for d in MC_CAP_BUILDS] \
        + [("loopfilter", LF422_SPLIT_DEFINES)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: _build.build(*j), jobs))
    LF._lib()
    L4._lib()
    TP._lib()
    IN._lib()
    RS._lib()
    MC._lib()
    PG._lib()
    print(f"build {', '.join(k + '.cu' for k in KERNELS)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_build.build_seconds.get(k, 0.0):.2f} s"
                      for k in KERNELS) + ")")
    for k in KERNELS:
        for fn, line in ptxas_usage(_build.build_log.get(k, "")):
            print(f"ptxas {k}.cu {fn}: {line}")

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
            l4_big = (F, maps, plain_s * 1e3, Fp)
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

    in_err = intra_vs_plain(rng, dev, IN, KC)
    rs_err = residual_vs_plain(rng, dev, RS, KC)
    mc_err = mc_vs_plain(dev, MC, KC)
    pg_err = pages_vs_plain(rng, dev, PG, UP)

    # 3. the step at one superblock
    step, sargs = fused.entry(dev)
    step(*sargs)
    torch.cuda.synchronize()
    print("fused.entry: one 64x64 step ran")

    # 4a. the decode path through the codec API, counted
    counted = (LF, L4, TP, IN, RS, MC, PG)
    for k in counted:
        k.reset_counts()
    lf_by_stream = {}
    for name, n, filtered in STREAMS:
        before = [(k.launches, getattr(k, "host_calls", 0)) for k in counted]
        extra = (MC.scaled_calls, MC.phases, IN.chunks, RS.buckets)
        md5s, recon, dt = decode(name, n)
        (lf_here, _), (l4_here, _), _, (in_here, calls_here), (rs_here, _), \
            (mc_here, mc_calls), (pg_here, _) = [
                (k.launches - b[0], getattr(k, "host_calls", 0) - b[1])
                for k, b in zip(counted, before)]
        mcs_here, phases_here, chunks_here, buckets_here = (
            a - b for a, b in zip((MC.scaled_calls, MC.phases, IN.chunks,
                                   RS.buckets), extra))
        lf_by_stream[name] = lf_here
        golden = golden_md5(name)[:n]
        bad = [i for i, (a, b) in enumerate(zip(md5s, golden)) if a != b]
        print(f"{name}: {len(md5s)} frames, MD5 mismatches {bad}, "
              f"on device {recon.frames_on_device}, on host "
              f"{recon.frames_on_host}, wide {recon.frames_wide}, "
              f"lf_frame launches {lf_here}, lf_chroma_422 launches "
              f"{l4_here}, intra launches {in_here} ({chunks_here} chunks) in "
              f"{calls_here} host calls, residual launches {rs_here} "
              f"({buckets_here} buckets), mc launches {mc_here} "
              f"({phases_here} phases; {mcs_here} with the scaled class) in "
              f"{mc_calls} host calls, expand_pages launches {pg_here}, "
              f"flats sent dense {recon.uploader.dense_frames} of "
              f"{recon.uploader.frames} ({recon.uploader.flat_bytes} bytes "
              f"dense, {recon.uploader.sent_bytes} sent), cold {dt:.2f} s")
        if len(md5s) != n or bad or recon.frames_on_device != n \
                or recon.frames_on_host:
            raise SystemExit(f"{name}: decode check failed")
        if filtered and not lf_here:
            raise SystemExit(f"{name}: the loop-filter kernel never ran")
        if name in LF422_STREAMS and (not l4_here or L4.plain_calls):
            raise SystemExit(f"{name}: the 4:2:2 chroma kernel never ran")
        if not 0 < in_here == calls_here <= n or not 0 < rs_here <= n \
                or buckets_here < rs_here or chunks_here < in_here \
                or IN.plain_calls or RS.plain_calls:
            raise SystemExit(f"{name}: the intra or residual kernel never "
                             "ran, ran a plain twin, or made more than one "
                             "launch (intra: host call) a frame")
        if not 0 < mc_here == mc_calls <= n or MC.plain_calls \
                or (name.startswith("cp01") and not mcs_here):
            raise SystemExit(f"{name}: the MC kernel (or on cp01 its scaled "
                             "class) never ran, ran a plain twin, or made "
                             "more than one launch (host call) a frame")
        if pg_here != recon.frames_on_device or PG.plain_calls:
            raise SystemExit(f"{name}: the page expansion did not run once "
                             "a frame, or ran its plain twin")
    lf_launches, lf_plain = LF.launches, LF.plain_calls
    l4_launches, l4_plain = L4.launches, L4.plain_calls
    in_launches, in_calls = IN.launches, IN.host_calls
    rs_launches = RS.launches
    mc_launches, mcs_launches, mask_launches = (MC.launches, MC.scaled_calls,
                                                MC.mask_calls)
    pg_launches, pg_pages = PG.launches, PG.pages
    print(f"decode path: loop-filter kernel launches {lf_launches}, plain "
          f"calls {lf_plain}; 4:2:2 chroma kernel launches {l4_launches}, "
          f"plain calls {l4_plain}; intra kernel launches {in_launches} "
          f"({IN.chunks} chunks) in {in_calls} host calls, plain calls "
          f"{IN.plain_calls}; residual kernel launches {rs_launches} "
          f"({RS.buckets} buckets), plain calls {RS.plain_calls}; "
          f"mc kernel launches {mc_launches} ({MC.phases} phases; "
          f"{mcs_launches} with the scaled class, {mask_launches} with the "
          f"mask) in {MC.host_calls} host calls, plain calls "
          f"{MC.plain_calls}; page expansion launches {pg_launches} "
          f"({pg_pages} pages), plain calls {PG.plain_calls}; "
          f"tile-probe launches {TP.launches}")
    if lf_launches == 0 or lf_plain or l4_launches == 0 or l4_plain:
        raise SystemExit("the decode path did not run the loop-filter "
                         "kernels")

    # 4b. the tile probe through its entry point, counted
    for k in counted:
        k.reset_counts()
    err, _ = probe_tool.run("cuda", check_plain=False)
    probe_launches, probe_plain = TP.launches, TP.plain_calls
    print(f"tile probe path: max_abs_err {err} against the NumPy reference, "
          f"kernel launches {probe_launches}, plain calls {probe_plain}")
    if err or not probe_launches or probe_plain or LF.launches \
            or L4.launches or IN.launches or RS.launches or MC.launches \
            or PG.launches:
        raise SystemExit("the tile-probe path failed")

    # 4c. the multi-stream decoders, each counted on its own
    lfs_launches = multi_stream_paths(LF, counted)

    # 5. warm decode rate and kernel timing
    for k in counted:
        k.reset_counts()
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
    print(f"warm decodes: mc kernel launches {MC.launches} ({MC.phases} "
          f"phases; {MC.scaled_calls} with the scaled class) in "
          f"{MC.host_calls} host calls, plain calls "
          f"{[k.plain_calls for k in counted]}")
    if any(k.plain_calls for k in counted) or not MC.launches:
        raise SystemExit("warm decodes: a plain twin ran, or MC did not")
    mc_rows = mc_timings(card, MC, _build)
    in_row, rs_row = keyframe_timings(dev, card, IN, RS, fused, _build)
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
    # the serial floor: a frame one SB row tall has no waits, so one SB
    # step is (t(30 SBs) - t(1 SB)) / 29
    t1 = lf_row_ms(dev, LF, 8)
    t30 = lf_row_ms(dev, LF, 240)
    step = (t30 - t1) / 29
    print(f"lf_frame one SB step {step * 1e3:.2f} us (64x64: {t1:.4f} ms, "
          f"64x1920: {t30:.4f} ms); critical path at 1920x1088: "
          f"{N_STEPS} steps = {N_STEPS * step:.4f} ms [{card}]")
    l4_row = lf422_timings(rng, dev, card, L4, _build, l4_big)
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

    # 6. the upload
    for k in counted:
        k.reset_counts()
    pg_row = upload_phase(dev, card, PG, UP)

    ms, plain_ms, bound, by = lf_rows[10]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
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
         "ms": l4_row[0], "plain_ms": l4_row[1], "bound_ms": l4_row[2],
         "bound_by": l4_row[3], "library_ms": None},
        {"name": "tile_probe", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/tileprobe.cu",
         "replaces": "tools/profiling/pallas_probe.py:110",
         "launches": probe_launches, "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms, "bound_ms": pbound,
         "bound_by": pby, "library_ms": None},
        {"name": "intra_pass", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/intra.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:452",
         "launches": in_launches, "max_abs_err": in_err,
         "ms": in_row[0], "plain_ms": in_row[1], "bound_ms": in_row[2],
         "bound_by": in_row[3], "library_ms": None},
        {"name": "residual", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/residual.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:44",
         "launches": rs_launches, "max_abs_err": rs_err,
         "ms": rs_row[0], "plain_ms": rs_row[1], "bound_ms": rs_row[2],
         "bound_by": rs_row[3], "library_ms": None},
        {"name": "mc", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/mc.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:163",
         "launches": mc_launches, "max_abs_err": mc_err,
         "ms": mc_rows["nc03 busiest"][0],
         "plain_ms": mc_rows["nc03 busiest"][1],
         "bound_ms": mc_rows["nc03 busiest"][2],
         "bound_by": mc_rows["nc03 busiest"][3], "library_ms": None},
        {"name": "mcs", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/mc.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:388",
         "launches": mcs_launches, "max_abs_err": mc_err,
         "ms": mc_rows["cp01 busiest scaled"][0],
         "plain_ms": mc_rows["cp01 busiest scaled"][1],
         "bound_ms": mc_rows["cp01 busiest scaled"][2],
         "bound_by": mc_rows["cp01 busiest scaled"][3],
         "library_ms": None},
        {"name": "mc_mask_add", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/mc.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:620",
         "launches": mask_launches, "max_abs_err": mc_err,
         "ms": mc_rows["nc03 busiest mask"][0],
         "plain_ms": mc_rows["nc03 busiest mask"][1],
         "bound_ms": mc_rows["nc03 busiest mask"][2],
         "bound_by": mc_rows["nc03 busiest mask"][3],
         "library_ms": None},
        {"name": "expand_pages", "route": "cuda",
         "source": "cuda_vp9_torch/csrc/pages.cu",
         "replaces": "cuda_vp9_tpu/runtime/fused.py:513",
         "launches": pg_launches, "max_abs_err": max(pg_err, pg_row[5]),
         "ms": pg_row[0], "plain_ms": pg_row[1], "bound_ms": pg_row[2],
         "bound_by": pg_row[3], "library_ms": pg_row[4]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
