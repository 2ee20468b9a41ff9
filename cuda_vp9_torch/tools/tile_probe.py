"""Run the shared-memory tile probe (ops/cuda/tileprobe.py) on one device.

Usage:
  python -m cuda_vp9_torch.tools.tile_probe [--device cuda]

The inputs are those of `tools/profiling/pallas_probe.py`: a [200, 200]
int32 frame (i % 251), a [24, 128] mask table (i % 7) and three waves of
up to four superblock entries.  The probe runs through `tile_probe` on
the device and is checked, bit for bit, against the probe's NumPy
reference; on a CUDA device the kernel is also checked against
`tile_probe_plain`.  Prints "PROBE OK" and exits 0 when everything
agrees.  `chip_smoke.py` times the kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.cuda import tileprobe as TP

H = W = 64 * 3 + 8


def probe_inputs():
    """(frame [200, 200], masks [24, 128], coords [24]) int32 numpy, as
    pallas_probe.main builds them."""
    frame = np.arange(H * W, dtype=np.int32).reshape(H, W) % 251
    masks = (np.arange(3 * 8 * 128, dtype=np.int32)
             .reshape(3 * 8, 128) % 7)
    coords = np.zeros((3, TP.MAXW, 2), np.int32)
    coords[0, 0] = (1, 1)
    coords[1, 0] = (1, 2)
    coords[1, 1] = (2, 1)
    coords[2, 0] = (2, 2)
    return frame, masks, coords.reshape(-1)


def probe_reference(frame, masks, coords):
    """The probe's NumPy reference (pallas_probe.py:124-139)."""
    ref = frame.copy()
    coords = coords.reshape(-1, TP.MAXW, 2)
    TS = TP.TS
    for wv in range(coords.shape[0]):
        for n in range(TP.MAXW):
            sbr, sbc = coords[wv, n] - 1
            if sbr < 0:
                continue
            tile = ref[sbr * 64:sbr * 64 + TS, sbc * 64:sbc * 64 + TS].copy()
            tileT = tile.T.copy()
            acc = np.zeros((64,), np.int64)
            for j in range(2):
                v = tileT[8 + j, 8:TS]
                m = np.repeat(masks[sbr * 8, :8], 8)
                acc = acc + v + m
            tileT[8, 8:TS] = acc
            ref[sbr * 64:sbr * 64 + TS, sbc * 64:sbc * 64 + TS] = tileT.T
    return ref


def run(device, check_plain: bool = True):
    """(max |tile_probe - reference|, max |kernel - plain| or None) on
    `device`; on a CUDA device the kernel is held against
    tile_probe_plain when check_plain."""
    frame, masks, coords = probe_inputs()
    want = probe_reference(frame, masks, coords)
    dev = torch.device(device)
    masks_d = torch.from_numpy(masks).to(dev)
    coords_t = torch.from_numpy(coords)
    f0 = torch.from_numpy(frame).to(dev)
    got = TP.tile_probe(f0.clone(), coords_t, masks_d)
    err = int(np.abs(got.cpu().numpy().astype(np.int64) - want).max())
    if dev.type != "cuda" or not check_plain:
        return err, None
    plain = TP.tile_probe_plain(f0.clone(), coords_t, masks_d)
    return err, int((got - plain).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tile_probe",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    err, kerr = run(args.device)
    print(f"tile_probe on {args.device}: max_abs_err {err} against the "
          f"NumPy reference" + ("" if kerr is None else
                                f", {kerr} against tile_probe_plain"))
    if err or kerr:
        print("PROBE MISMATCH")
        return 1
    print("PROBE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
