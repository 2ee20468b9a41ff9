"""Shared-memory tile probe: the CUDA kernel and its plain torch twin.

`tile_probe` is the counterpart of the Pallas probe `kernel` of
`tools/profiling/pallas_probe.py`: in place on an int32 [H, W] frame, per
wave of up to MAXW entries with +1-encoded superblock coordinates
(sbr, sbc), 0 marking a padded entry, it loads the 72x72 tile at
(64 sbr, 64 sbc) and the mask row masks[8 sbr], transposes the tile, sets
row 8 of the transpose (columns 8..71) to

    tileT[8, 8 + k] + tileT[9, 8 + k] + 2 * masks[8 sbr, k // 8]

and transposes back.  The coordinates live on the host, as the Pallas
probe's scalar-prefetched ones do.  On a CUDA frame it launches the
kernel of `csrc/tileprobe.cu` (one launch per non-empty wave, one block
per valid entry, tiles in shared memory) or raises; on a CPU frame it
runs `tile_probe_plain`, the probe's NumPy reference in torch ops.  The
kernel runs the entries of one wave in parallel, and their tiles may
share apron pixels, so no entry may change a pixel inside another entry's
tile of its wave; both versions reject such waves.

`launches` counts the kernel launches (as the C entry point reports them)
and `plain_calls` the calls of the plain version.
"""

from __future__ import annotations

import ctypes

import torch

MAXW = 4        # entries per wave
TS = 72         # tile side: a 64-pixel superblock and an 8-pixel apron

launches = 0
plain_calls = 0


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _check(frame, coords, masks):
    """Each wave's valid entries [(sbr, sbc), ...], zero-based, after
    checking types, devices and bounds."""
    if frame.dtype != torch.int32 or frame.dim() != 2 \
            or not frame.is_contiguous():
        raise ValueError("frame must be a contiguous int32 [H, W] tensor")
    if coords.dtype != torch.int32 or coords.dim() != 1 \
            or coords.numel() % (2 * MAXW) or coords.device.type != "cpu":
        raise ValueError(f"coords must be a host int32 "
                         f"[n_waves * {MAXW} * 2] tensor")
    if masks.dtype != torch.int32 or masks.dim() != 2 \
            or not masks.is_contiguous() or not 8 <= masks.shape[1] <= 128:
        raise ValueError("masks must be a contiguous int32 [rows, 8..128] "
                         "tensor")
    if masks.device != frame.device:
        raise ValueError("frame and masks must be on one device")
    waves = [[(r - 1, s - 1) for r, s in wave if r > 0]
             for wave in coords.reshape(-1, MAXW, 2).tolist()]
    H, W = frame.shape
    for sbr, sbc in (e for wave in waves for e in wave):
        if sbc < 0 or 64 * sbr + TS > H or 64 * sbc + TS > W \
                or 8 * sbr >= masks.shape[0]:
            raise ValueError(f"entry ({sbr + 1}, {sbc + 1}) reaches past "
                             f"the frame {H}x{W} or the masks")
    for wave in waves:
        for i, (r, c) in enumerate(wave):
            # entry i changes column 64 c + 8, rows 64 r + 8 .. 64 r + 71
            for j, (r2, c2) in enumerate(wave):
                if i != j and 64 * c2 <= 64 * c + 8 < 64 * c2 + TS \
                        and 64 * r + 8 < 64 * r2 + TS \
                        and 64 * r2 < 64 * r + TS:
                    raise ValueError(
                        f"entry ({r + 1}, {c + 1}) changes pixels inside "
                        f"the tile of entry ({r2 + 1}, {c2 + 1}) of its wave")
    return waves


def tile_probe_plain(frame, coords, masks):
    """The probe's NumPy reference (pallas_probe.py:124-139) in torch ops,
    in place on frame; entries one after another.  Returns frame."""
    waves = _check(frame, coords, masks)
    global plain_calls
    plain_calls += 1
    for wave in waves:
        for sbr, sbc in wave:
            tile = frame[64 * sbr:64 * sbr + TS, 64 * sbc:64 * sbc + TS]
            tileT = tile.t().clone()
            m = masks[8 * sbr, :8].repeat_interleave(8)
            acc = torch.zeros(64, dtype=torch.int32, device=frame.device)
            for j in range(2):
                acc = acc + tileT[8 + j, 8:TS] + m
            tileT[8, 8:TS] = acc
            tile.copy_(tileT.t())
    return frame


def _lib():
    """The bound C entry point; builds csrc/tileprobe.cu at first use."""
    from ._build import load
    fn = load("tileprobe").vp9_tile_probe
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
    return fn


def tile_probe(frame, coords, masks):
    """Run the probe in place on frame [H, W] int32; returns frame.

    coords: host int32 [n_waves * MAXW * 2], +1-encoded (sbr, sbc) per
    entry; masks: int32 [rows, cols], cols in 8..128, on the frame's
    device.  A CUDA frame goes to the kernel (the frame's rows and the
    mask rows must start on 16-byte boundaries), a CPU frame to
    tile_probe_plain."""
    if frame.device.type == "cpu":
        return tile_probe_plain(frame, coords, masks)
    if frame.device.type != "cuda":
        raise ValueError(f"tile_probe: unsupported device {frame.device}")
    waves = _check(frame, coords, masks)
    if frame.shape[1] % 4 or masks.shape[1] % 4 \
            or frame.data_ptr() % 16 or masks.data_ptr() % 16:
        raise ValueError("tile_probe: frame and mask rows must be 16-byte "
                         "aligned (widths a multiple of 4)")
    flat = [v for wave in waves for e in wave for v in e]
    entries = (ctypes.c_int * max(1, len(flat)))(*flat)
    counts = (ctypes.c_int * len(waves))(*(len(w) for w in waves))
    global launches
    fn = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        err = fn(frame.data_ptr(), frame.shape[1], entries, counts,
                 len(waves), masks.data_ptr(), masks.shape[1], stream,
                 ctypes.byref(n))
    launches += n.value
    if err:
        raise RuntimeError(f"vp9_tile_probe: CUDA error {err}")
    return frame
