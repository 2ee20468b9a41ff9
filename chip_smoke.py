#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cuda_vp9_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi name and power limit), the torch / CUDA
     versions, and build the CUDA loop-filter kernel from
     cuda_vp9_torch/csrc with nvcc;
  2. compare the kernel with its plain torch version on the card, bit
     for bit (tolerance 0: the filter is integer math), on random pixels
     and random edge metadata at 64x64 and at the 1920x1088 canvas, and
     check that lf_on = 0 leaves the frame untouched;
  3. run the frame step once at one 64x64 superblock (fused.entry);
  4. decode nc03_640x360_occl (loop filter on), hd01_1920x1080_t4 (1080p)
     and cp01_352x288_compound (compound prediction, scaled references)
     through the vpx_codec_* API with vp9_dx_torch("cuda"): every frame's
     MD5 must equal the golden file, every frame must run on the device,
     and the loop-filter kernel must have launched (never its plain
     version);
  5. time a second, warm decode of each stream, and the loop filter
     (kernel against plain, CUDA events) at 1920x1088.

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
STREAMS = (("nc03_640x360_occl", 12), ("hd01_1920x1080_t4", 4),
           ("cp01_352x288_compound", 8))
LF_SHAPES = ((8, 8), (135, 240))      # mi grids: 64x64 and 1920x1088 canvas


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def rand_lf_inputs(rng, mi_rows, mi_cols):
    """Random 8-bit frame, edge metadata and thresholds for one mi grid;
    the metadata as tests/test_pallas_lf.py builds it (no edge on the
    frame's left and top borders)."""
    from cuda_vp9_torch._hostshim import pack_lf_thresholds, pack_lfm_fields
    from cuda_vp9_tpu.ops.ref.loopfilter import make_thresholds

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

    def pixels(h, w):
        """8x8 blocks of a random level plus noise of a random amplitude
        (flat to busy), so every filter width engages somewhere."""
        lvl = rng.integers(0, 256, (h // 8, w // 8))
        amp = rng.choice([1, 3, 9, 40], (h // 8, w // 8))
        noise = rng.integers(-64, 65, (h, w)) % np.repeat(
            np.repeat(amp, 8, 0), 8, 1)
        return np.clip(np.repeat(np.repeat(lvl, 8, 0), 8, 1) + noise, 0, 255)

    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    F = np.zeros((3, ha, wa), np.int32)
    F[0] = pixels(ha, wa)
    F[1, :ha // 2, :wa // 2] = pixels(ha // 2, wa // 2)
    F[2, :ha // 2, :wa // 2] = pixels(ha // 2, wa // 2)
    R2, C2 = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    lvl_y, vy = cells(mi_rows, mi_cols)
    lvl_uv, vuv = cells(R2, C2)
    lfm = pack_lfm_fields(lvl_y, vy, hcells(mi_rows, mi_cols), lvl_uv, vuv,
                          hcells(R2, C2), mi_rows, mi_cols)
    thr = pack_lf_thresholds(make_thresholds(int(rng.integers(0, 8))))
    return F, lfm, thr


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def decode(name: str, n_frames: int):
    """Decode one fixture through the codec API on the card; returns
    (md5s, recon, seconds).  The MD5s read every frame back to the host,
    so the time covers the device work."""
    from cuda_vp9_torch.tools.profile_decode import decode as decode_md5

    t0 = time.perf_counter()
    md5s, recon = decode_md5(str(FIXTURES / f"{name}.ivf"), "cuda", n_frames)
    return md5s, recon, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_vp9_torch.ops.cuda import _build
    from cuda_vp9_torch.ops.cuda import loopfilter as LF
    from cuda_vp9_torch.runtime import fused

    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    LF._lib()
    print(f"build loopfilter.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds.get('loopfilter', 0.0):.2f} s)")

    # 2. kernel against plain, bit-exact
    rng = np.random.default_rng(2026)
    max_err = 0
    for mi_rows, mi_cols in LF_SHAPES:
        F, lfm, thr = rand_lf_inputs(rng, mi_rows, mi_cols)
        args = (torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev))
        Fk = torch.from_numpy(F).to(dev)
        Fp = Fk.clone()
        kw = dict(mi_rows=mi_rows, mi_cols=mi_cols, bd=8)
        LF.lf_frame(Fk, *args, 1, **kw)
        LF.lf_frame_plain(Fp, *args, 1, **kw)
        torch.cuda.synchronize()
        err = int((Fk - Fp).abs().max())
        changed = int((Fp != torch.from_numpy(F).to(dev)).sum())
        print(f"lf kernel vs plain {F.shape[1]}x{F.shape[2]}: max_abs_err "
              f"{err} (tolerance 0), {changed} pixels filtered")
        if err or not changed:
            raise SystemExit(f"loop-filter kernel disagrees at "
                             f"{F.shape[1]}x{F.shape[2]}")
        max_err = max(max_err, err)
        Fo = torch.from_numpy(F).to(dev)
        LF.lf_frame(Fo, *args, 0, **kw)
        if not torch.equal(Fo.cpu(), torch.from_numpy(F)):
            raise SystemExit("lf_on = 0 changed the frame")
    print("lf_on = 0: identity")

    # 3. the step at one superblock
    step, sargs = fused.entry(dev)
    step(*sargs)
    torch.cuda.synchronize()
    print("fused.entry: one 64x64 step ran")

    # 4. the main path: decode through the codec API, counted
    LF.reset_counts()
    results = {}
    for name, n in STREAMS:
        md5s, recon, dt = decode(name, n)
        results[name] = (recon.frames_on_device, recon.frames_on_host, dt)
        golden = [ln.split()[0] for ln in
                  (FIXTURES / f"{name}.md5").read_text().splitlines()][:n]
        bad = [i for i, (a, b) in enumerate(zip(md5s, golden)) if a != b]
        print(f"{name}: {len(md5s)} frames, MD5 mismatches {bad}, "
              f"on device {recon.frames_on_device}, on host "
              f"{recon.frames_on_host}, wide {recon.frames_wide}, "
              f"cold {dt:.2f} s")
        if len(md5s) != n or bad or recon.frames_on_device != n \
                or recon.frames_on_host:
            raise SystemExit(f"{name}: decode check failed")
    launches, plain_calls = LF.launches, LF.plain_calls
    print(f"loop-filter kernel launches {launches}, plain calls "
          f"{plain_calls}")
    if launches == 0 or plain_calls:
        raise SystemExit("the main path did not run the loop-filter kernel")

    # 5. warm decode rate and kernel timing
    for name, n in STREAMS:
        _, _, dt = decode(name, n)
        print(f"{name}: warm {n} frames {dt:.3f} s = {n / dt:.2f} fps "
              f"[{card}]")
    F, lfm, thr = rand_lf_inputs(rng, *LF_SHAPES[-1])
    Fd = torch.from_numpy(F).to(dev)
    lfm_d, thr_d = torch.from_numpy(lfm).to(dev), torch.from_numpy(thr).to(dev)
    kw = dict(mi_rows=LF_SHAPES[-1][0], mi_cols=LF_SHAPES[-1][1], bd=8)
    LF.lf_frame(Fd.clone(), lfm_d, thr_d, 1, **kw)
    ms = cuda_ms(lambda: LF.lf_frame(Fd.clone(), lfm_d, thr_d, 1, **kw), 20)
    copy_ms = cuda_ms(lambda: Fd.clone(), 20)
    plain_ms = cuda_ms(lambda: LF.lf_frame_plain(Fd.clone(), lfm_d, thr_d, 1,
                                                 **kw), 3)
    print(f"lf_frame 1920x1088 median: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (each includes a {copy_ms:.3f} ms frame "
          f"copy) [{card}]")

    print(json.dumps({"kernels": [{
        "name": "lf_frame", "route": "cuda",
        "source": "cuda_vp9_torch/csrc/loopfilter.cu",
        "replaces": "cuda_vp9_tpu/ops/pallas/loopfilter.py:430",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
