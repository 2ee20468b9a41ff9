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
kernel of `csrc/tileprobe.cu` or raises; on a CPU frame it runs
`tile_probe_plain`, the probe's NumPy reference in torch ops.  The
kernel runs every wave in one launch (one more for every MAX_ENTRIES
entries past the first MAX_ENTRIES): `build_table` gives each entry the
earlier-wave entries it waits for, on done flags on the device, and the
tiles move by TMA.  The entries of one wave run in any order, and their
tiles may share apron pixels, so no entry may change a pixel inside
another entry's tile of its wave; both versions reject such waves.

`launches` counts the kernel launches (as the C entry point reports them)
and `plain_calls` the calls of the plain version.
"""

from __future__ import annotations

import ctypes
from array import array
from typing import NamedTuple

import torch

from . import _build

MAXW = 4        # entries per wave
TS = 72         # tile side: a 64-pixel superblock and an 8-pixel apron
MAX_ENTRIES = 224   # entries a launch takes (csrc/tileprobe.cu kMaxEntries)
MAX_DEPS = 9        # entries an entry waits for: the 3x3 superblocks
WS_LINE = 32        # int32 words of one workspace line (128 bytes)

launches = 0
plain_calls = 0


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _check(frame, coords, masks):
    """The call's Table (build_table, bounds included), after checking
    types and devices."""
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
    return build_table(waves, *frame.shape, masks.shape[0])


class Table(NamedTuple):
    """The kernel's table of one call, in ticket (wave) order."""
    entries: list       # [(sbr, sbc), ...], zero-based
    deps: list          # per entry, the indices of the entries it waits for
    sizes: array        # entries of each launch, at most MAX_ENTRIES each
    rows: array         # per entry, 12 ints as csrc/tileprobe.cu takes them


_PAD = [[0] * (MAX_DEPS - k) for k in range(MAX_DEPS + 1)]


def build_table(waves, H=None, W=None, mask_rows=None) -> Table:
    """One walk over the waves' entries [[(sbr, sbc), ...], ...]: refuses
    an entry whose tile reaches past the H x W frame or whose mask row
    past mask_rows (when they are given), and a wave in which an entry
    changes a pixel inside another entry's tile (the entries of a wave run
    in any order); gives each entry the entries it waits for, the latest
    earlier-wave entry at each of the 3x3 superblocks around it (the only
    ones whose tiles meet its own).  Entries go MAX_ENTRIES to a launch; a
    launch runs after the one before it on the stream, so the rows drop
    the waits on earlier launches and number the others within their
    launch."""
    entries, deps, rows = [], [], []
    last = {}               # superblock -> its latest entry of a done wave
    get = last.get
    for wave in waves:
        for i, (r, c) in enumerate(wave):
            if H is not None and (c < 0 or 64 * r + TS > H
                                  or 64 * c + TS > W or 8 * r >= mask_rows):
                raise ValueError(f"entry ({r + 1}, {c + 1}) reaches past "
                                 f"the frame {H}x{W} or the masks")
            # entry i changes column 64 c + 8, rows 64 r + 8 .. 64 r + 71,
            # which lie inside the tiles at (r, c) and (r + 1, c) alone
            for j, (r2, c2) in enumerate(wave):
                if c2 == c and r <= r2 <= r + 1 and i != j:
                    raise ValueError(
                        f"entry ({r + 1}, {c + 1}) changes pixels inside "
                        f"the tile of entry ({r2 + 1}, {c2 + 1}) of its wave")
            d = [g for g in map(get, ((r - 1, c - 1), (r - 1, c),
                                      (r - 1, c + 1), (r, c - 1), (r, c),
                                      (r, c + 1), (r + 1, c - 1),
                                      (r + 1, c), (r + 1, c + 1)))
                 if g is not None]
            d.sort()
            start = len(entries) - len(entries) % MAX_ENTRIES
            local = [g - start for g in d if g >= start] if start else d
            entries.append((r, c))
            deps.append(d)
            rows += [r, c, len(local)] + local + _PAD[len(local)]
        for k, e in enumerate(wave, len(entries) - len(wave)):
            last[e] = k
    n = len(entries)
    sizes = array("i", (min(MAX_ENTRIES, n - s)
                        for s in range(0, n, MAX_ENTRIES)))
    return Table(entries, deps, sizes, array("i", rows))


def tile_probe_plain(frame, coords, masks):
    """The probe's NumPy reference (pallas_probe.py:124-139) in torch ops,
    in place on frame; entries one after another.  Returns frame."""
    t = _check(frame, coords, masks)
    global plain_calls
    plain_calls += 1
    for sbr, sbc in t.entries:
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
    fn = _build.load("tileprobe").vp9_tile_probe
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: without argtypes
        # ctypes passes Python ints as 32-bit C ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [vp, i, i, vp, i, vp, i, vp, i, vp, vp,
                       ctypes.POINTER(i)]
    return fn


def tile_probe(frame, coords, masks):
    """Run the probe in place on frame [H, W] int32; returns frame.

    coords: host int32 [n_waves * MAXW * 2], +1-encoded (sbr, sbc) per
    entry; masks: int32 [rows, cols], cols in 8..128, on the frame's
    device.  A CUDA frame goes to the kernel (the frame's rows must start
    on 16-byte boundaries, as TMA needs), a CPU frame to
    tile_probe_plain."""
    if frame.device.type == "cpu":
        return tile_probe_plain(frame, coords, masks)
    if frame.device.type != "cuda":
        raise ValueError(f"tile_probe: unsupported device {frame.device}")
    t = _check(frame, coords, masks)
    if frame.shape[1] % 4 or frame.data_ptr() % 16:
        raise ValueError("tile_probe: the frame's rows must be 16-byte "
                         "aligned (a width that is a multiple of 4)")
    if not t.entries:
        return frame
    ws = torch.empty(WS_LINE * (len(t.sizes) + len(t.entries)),
                     dtype=torch.int32, device=frame.device)
    global launches
    launches += _build.call(_lib(), frame.device, frame.data_ptr(),
                            frame.shape[0], frame.shape[1],
                            t.rows.buffer_info()[0], len(t.entries),
                            t.sizes.buffer_info()[0], len(t.sizes),
                            masks.data_ptr(), masks.shape[1], ws.data_ptr())
    return frame
