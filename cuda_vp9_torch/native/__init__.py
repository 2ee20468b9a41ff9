"""ctypes binding for the native host entropy decoder (libvp9host.so).

`NativeParser.parse(payload)` returns the same FramePlan the Python
bitstream layer produces — the reconstruction backends are shared.

The library is built with g++ from the sources beside this file into
`build/cuda_vp9_torch/libvp9host.so` at the checkout root, at first use,
and rebuilt when a source is newer than it.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess

import numpy as np

from ..decoder import constants as C
from ..decoder.blockd import BlockRecord, FramePlan, MiGrid
from ..decoder.headers import FrameHeader, LoopFilterParams, \
    SegmentationParams

_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                    "cuda_vp9_torch")
_SO = os.path.join(_OUT, "libvp9host.so")
_SRC = os.path.join(_DIR, "vp9host.cpp")


class _PlanOut(ct.Structure):
    _fields_ = [
        ("ok", ct.c_int32),
        ("show_existing", ct.c_int32), ("frame_to_show", ct.c_int32),
        ("frame_type", ct.c_int32), ("show_frame", ct.c_int32),
        ("intra_only", ct.c_int32),
        ("width", ct.c_int32), ("height", ct.c_int32),
        ("bit_depth", ct.c_int32),
        ("subsampling_x", ct.c_int32), ("subsampling_y", ct.c_int32),
        ("lossless", ct.c_int32), ("base_qindex", ct.c_int32),
        ("refresh_frame_flags", ct.c_int32),
        ("ref_frame_idx", ct.c_int32 * 3),
        ("interp_filter", ct.c_int32), ("allow_hp", ct.c_int32),
        ("reference_mode", ct.c_int32),
        ("log2_tile_cols", ct.c_int32), ("log2_tile_rows", ct.c_int32),
        ("mi_rows", ct.c_int32), ("mi_cols", ct.c_int32),
        ("lf_filter_level", ct.c_int32), ("lf_sharpness", ct.c_int32),
        ("lf_mode_ref_delta_enabled", ct.c_int32),
        ("lf_ref_deltas", ct.c_int32 * 4),
        ("lf_mode_deltas", ct.c_int32 * 2),
        ("seg_enabled", ct.c_int32), ("seg_abs_delta", ct.c_int32),
        ("seg_feature_enabled", (ct.c_int32 * 4) * 8),
        ("seg_feature_data", (ct.c_int32 * 4) * 8),
        ("sb_type", ct.POINTER(ct.c_int8)),
        ("mode", ct.POINTER(ct.c_int8)),
        ("uv_mode", ct.POINTER(ct.c_int8)),
        ("tx_size", ct.POINTER(ct.c_int8)),
        ("skip", ct.POINTER(ct.c_int8)),
        ("segment_id", ct.POINTER(ct.c_int8)),
        ("interp", ct.POINTER(ct.c_int8)),
        ("ref0", ct.POINTER(ct.c_int8)),
        ("ref1", ct.POINTER(ct.c_int8)),
        ("mv", ct.POINTER(ct.c_int32)),
        ("bmi_mode", ct.POINTER(ct.c_int8)),
        ("bmi_mv", ct.POINTER(ct.c_int32)),
        ("seg_map", ct.POINTER(ct.c_uint8)),
        ("n_blocks", ct.c_int32),
        ("blocks", ct.POINTER(ct.c_int32)),
        ("plane_w4", ct.c_int32 * 3), ("plane_h4", ct.c_int32 * 3),
        ("eob_map", ct.POINTER(ct.c_int32) * 3),
        ("off_map", ct.POINTER(ct.c_int64) * 3),
        ("coeffs", ct.POINTER(ct.c_int32) * 3),
        ("coeff_len", ct.c_int64 * 3),
    ]


class _PackIn(ct.Structure):
    _fields_ = [
        ("total_len", ct.c_int64),
        ("lossless", ct.c_int32), ("ring_slot", ct.c_int32),
        ("ha", ct.c_int32), ("lf_k", ct.c_int32),
        ("coeff_off", ct.c_int64 * 12), ("cpos_off", ct.c_int64 * 12),
        ("coeff_cap", ct.c_int64 * 12),
        ("mc_off", ct.c_int64 * 3), ("mch_off", ct.c_int64 * 3),
        ("mc_cap", ct.c_int64 * 3),
        ("intra_off", ct.c_int64), ("chunkbs_off", ct.c_int64),
        ("intra_cap", ct.c_int64),
        ("mimask_off", ct.c_int64), ("lfm_off", ct.c_int64),
        ("misc_off", ct.c_int64),
        ("crop", ((ct.c_int32 * 2) * 3) * 3),
        ("highbd", ct.c_int32),
        ("coeffh_off", ct.c_int64 * 12),
        # scaled-reference "mcs" class (tier "scaled"; mcs_cap 0 = absent)
        ("mcs_off", ct.c_int64), ("mcsh_off", ct.c_int64),
        ("mcs_cap", ct.c_int64),
        ("pool_ha", ct.c_int32), ("pad0", ct.c_int32),
        # 32x32 coo bucket (8-bit only; c3_cap 0 = absent)
        ("c3_off", ct.c_int64), ("c3pos_off", ct.c_int64),
        ("c3_cap", ct.c_int64),
        ("intra_chunk", ct.c_int32), ("pad1", ct.c_int32),
        # tx3cs coo bucket: 16 pairs for any eob > 16, <= 16 nonzeros
        ("c3s_off", ct.c_int64), ("c3spos_off", ct.c_int64),
        ("c3s_cap", ct.c_int64),
        ("mc_chunk", ct.c_int64 * 3),   # per-geometry MC chunk lengths
        ("lfthr_off", ct.c_int64),      # [64, 4] level->threshold table
        # 32x32 MC tile class (appended for ABI stability)
        ("mc32_off", ct.c_int64), ("mc32h_off", ct.c_int64),
        ("mc32_cap", ct.c_int64), ("mc32_chunk", ct.c_int64),
    ]


_COEFF_NAMES = ("tx0s", "tx0", "tx1s", "tx1m", "tx1", "tx2xs",
                "tx2s", "tx2d", "tx3xs", "tx3s", "tx3m", "tx3d")


_lib = None


def build_library(force: bool = False) -> str:
    """Compile libvp9host.so if missing/stale."""
    srcs = [_SRC] + [os.path.join(_DIR, f) for f in os.listdir(_DIR)
                     if f.endswith(".inc") or f.endswith(".h")]
    if (not force and os.path.exists(_SO)
            and all(os.path.getmtime(_SO) > os.path.getmtime(s)
                    for s in srcs)):
        return _SO
    # compile to a private temp path + atomic rename: concurrent
    # builders (subprocess tests import the package in parallel) must
    # never dlopen a half-written .so
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{_SO}.build.{os.getpid()}"
    subprocess.check_call(
        ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Wno-unused-function", "-o", tmp, _SRC])
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib
    if _lib is None:
        build_library()
        _lib = ct.CDLL(_SO)
        _lib.vp9h_create.restype = ct.c_void_p
        _lib.vp9h_destroy.argtypes = [ct.c_void_p]
        _lib.vp9h_set_threads.argtypes = [ct.c_void_p, ct.c_int]
        _lib.vp9h_parse.restype = ct.c_int
        _lib.vp9h_parse.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int64,
                                    ct.POINTER(_PlanOut)]
        _lib.vp9h_pack.restype = ct.c_int64
        _lib.vp9h_pack.argtypes = [ct.c_void_p, ct.POINTER(_PackIn),
                                   ct.POINTER(ct.c_int16)]
        _lib.vp9h_compact_pages.restype = ct.c_int64
        _lib.vp9h_compact_pages.argtypes = [ct.c_void_p, ct.c_int64,
                                            ct.c_int64, ct.c_void_p,
                                            ct.c_void_p]
    return _lib


def compact_pages(flat: np.ndarray, max_pages: int, map_addr: int,
                  pages_addr: int) -> int:
    """Page compaction of a packed flat (int16, whole 512-int16 pages) in
    C++, in one pass, into caller memory: the int32 page map at map_addr
    (0: an all-zero page; i: the i-th nonzero page), the nonzero pages at
    pages_addr.  Returns their count, or -1 when more than max_pages are
    nonzero (the flat then ships dense).  Counterpart of
    TpuReconFused._compact without the tier: no zero page, no padding."""
    if flat.dtype != np.int16 or not flat.flags.c_contiguous \
            or flat.size % 512:
        raise ValueError("compact_pages: flat must be contiguous int16 "
                         "whole pages")
    return int(_load().vp9h_compact_pages(flat.ctypes.data, flat.size // 512,
                                          max_pages, map_addr, pages_addr))


def _wrap(ptr, shape, dtype):
    n = int(np.prod(shape))
    buf = np.ctypeslib.as_array(ptr, shape=(n,))
    return buf.view(dtype).reshape(shape)


class _LazyBlocks:
    """List-of-BlockRecord view over the raw [B, 5] block array.

    The vectorized packer uses plan.blocks_arr directly; the object list
    is only materialized if someone iterates plan.blocks (oracle paths)."""

    def __init__(self, arr):
        self._arr = arr
        self._list = None

    def _mat(self):
        if self._list is None:
            self._list = [BlockRecord(*row) for row in self._arr.tolist()]
        return self._list

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return self._arr.shape[0]

    def __getitem__(self, i):
        return self._mat()[i]

    def __bool__(self):
        return self._arr.shape[0] > 0


class ShowExisting:
    def __init__(self, idx):
        self.frame_to_show = idx


class NativeParser:
    """One decoding context (persistent contexts live in C++)."""

    def __init__(self, threads: int = 1):
        self._lib = _load()
        self._h = self._lib.vp9h_create()
        self._last_plan = None
        self._packin_cache = {}
        if threads > 1:
            self.set_threads(threads)

    def set_threads(self, n: int):
        """Tile-parallel entropy parse (vpx_codec_dec_cfg_t.threads)."""
        self._lib.vp9h_set_threads(self._h, int(n))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vp9h_destroy(self._h)
            self._h = None

    def _packin(self, caps, layout, lossless, mi_rows):
        """Static-per-layout PackIn template (crop/slot filled per call).

        The cache entry holds the LAYOUT reference too: keyed by
        id(layout) alone, a garbage-collected layout would let a new
        object reuse the id and pick up stale offsets — heap corruption
        in the C++ packer (caught by the scaled-pack ASAN fuzz)."""
        key = id(layout)
        hit = self._packin_cache.get(key)
        pi = hit[1] if hit is not None and hit[0] is layout else None
        if pi is None:
            from ..runtime.lfmeta import K as LF_K
            pi = _PackIn()
            # padded to a whole page: C++ zero-fills the entire buffer
            pi.total_len = ((layout.size + 511) // 512) * 512
            pi.lossless = int(lossless)
            pi.ha = ((mi_rows + 7) & ~7) * 8
            pi.lf_k = LF_K
            pi.highbd = int("coeffh_tx0" in layout.segs)
            for i, name in enumerate(_COEFF_NAMES):
                if lossless and name != "tx0":
                    continue
                pi.coeff_off[i] = layout.segs[f"coeff_{name}"][0]
                pi.cpos_off[i] = layout.segs[f"cpos_{name}"][0]
                pi.coeff_cap[i] = caps[name]
                if pi.highbd:
                    pi.coeffh_off[i] = layout.segs[f"coeffh_{name}"][0]
            if "coeff_tx3c" in layout.segs:
                pi.c3_off = layout.segs["coeff_tx3c"][0]
                pi.c3pos_off = layout.segs["cpos_tx3c"][0]
                pi.c3_cap = caps["tx3c"]
                pi.c3s_off = layout.segs["coeff_tx3cs"][0]
                pi.c3spos_off = layout.segs["cpos_tx3cs"][0]
                pi.c3s_cap = caps["tx3cs"]
            for i, name in enumerate(("mc4", "mc8", "mc16")):
                pi.mc_off[i] = layout.segs[name][0]
                pi.mch_off[i] = layout.segs[name + "h"][0]
                pi.mc_cap[i] = caps[name]
                pi.mc_chunk[i] = layout.segs[name][1][1]
            pi.mc32_off = layout.segs["mc32"][0]
            pi.mc32h_off = layout.segs["mc32h"][0]
            pi.mc32_cap = caps["mc32"]
            pi.mc32_chunk = layout.segs["mc32"][1][1]
            if "mcs" in layout.segs:
                pi.mcs_off = layout.segs["mcs"][0]
                pi.mcsh_off = layout.segs["mcsh"][0]
                pi.mcs_cap = caps["mcs"]
            pi.intra_off = layout.segs["intra"][0]
            pi.intra_chunk = layout.segs["intra"][1][1]
            pi.chunkbs_off = layout.segs["chunk_bs"][0]
            pi.intra_cap = caps["intra"]
            pi.mimask_off = layout.segs["mi_mask"][0]
            pi.lfm_off = layout.segs["lfm"][0]
            pi.lfthr_off = layout.segs["lf_thr"][0]
            pi.misc_off = layout.segs["misc"][0]
            self._packin_cache[key] = (layout, pi)
        return pi

    def pack(self, plan, refs, caps, layout, ring_slot=0, pool_ha=None):
        """Pack the MOST RECENTLY PARSED frame (must be `plan`) into a
        fresh flat int16 buffer entirely in C++ (mirrors
        runtime/pack.pack_frame byte-for-byte, including the scaled-
        reference mcs class).  Returns None on tier overflow (caller
        falls back to the host oracle)."""
        assert plan is self._last_plan, \
            "native pack must run on the parser's live state"
        hdr = plan.hdr
        pi = self._packin(caps, layout, bool(hdr.lossless), hdr.mi_rows)
        pi.ring_slot = ring_slot
        pi.pool_ha = int(pool_ha or 0)
        for k in (1, 2, 3):
            rb = refs.get(k) if refs else None
            for p in range(3):
                if rb is None:
                    pi.crop[k - 1][p][0] = 1
                    pi.crop[k - 1][p][1] = 1
                else:
                    sx = hdr.subsampling_x if p else 0
                    sy = hdr.subsampling_y if p else 0
                    pi.crop[k - 1][p][0] = (rb.width + sx) >> sx
                    pi.crop[k - 1][p][1] = (rb.height + sy) >> sy
        PAGE = 512
        buf = np.empty(((layout.size + PAGE - 1) // PAGE) * PAGE, np.int16)
        err = self._lib.vp9h_pack(
            self._h, ct.byref(pi), buf.ctypes.data_as(ct.POINTER(ct.c_int16)))
        if err:
            from ..runtime import pack as _p
            _p.last_overflow = ("native", int(err), 0)
            return None
        return buf

    def parse(self, payload: bytes):
        """Parse one (non-superframe) frame; returns FramePlan or
        ShowExisting.  Raises ValueError on corrupt data.

        The returned plan's arrays VIEW the parser's internal buffers and
        are valid until the next parse() call.
        """
        out = _PlanOut()
        ok = self._lib.vp9h_parse(self._h, payload, len(payload),
                                  ct.byref(out))
        if not ok:
            self._last_plan = None
            raise ValueError("frame data corrupted (native parse)")
        if out.show_existing:
            self._last_plan = None
            return ShowExisting(out.frame_to_show)

        hdr = FrameHeader()
        hdr.frame_type = out.frame_type
        hdr.show_frame = out.show_frame
        hdr.intra_only = out.intra_only
        hdr.width = out.width
        hdr.height = out.height
        hdr.bit_depth = out.bit_depth
        hdr.subsampling_x = out.subsampling_x
        hdr.subsampling_y = out.subsampling_y
        hdr.lossless = out.lossless
        hdr.base_qindex = out.base_qindex
        hdr.refresh_frame_flags = out.refresh_frame_flags
        hdr.ref_frame_idx = list(out.ref_frame_idx)
        hdr.interp_filter = out.interp_filter
        hdr.allow_high_precision_mv = out.allow_hp
        hdr.log2_tile_cols = out.log2_tile_cols
        hdr.log2_tile_rows = out.log2_tile_rows
        hdr.compute_geometry()
        lf = LoopFilterParams()
        lf.filter_level = out.lf_filter_level
        lf.sharpness_level = out.lf_sharpness
        lf.mode_ref_delta_enabled = out.lf_mode_ref_delta_enabled
        lf.ref_deltas = list(out.lf_ref_deltas)
        lf.mode_deltas = list(out.lf_mode_deltas)
        hdr.lf = lf
        seg = SegmentationParams()
        seg.enabled = out.seg_enabled
        seg.abs_delta = out.seg_abs_delta
        seg.feature_enabled = [list(out.seg_feature_enabled[i])
                               for i in range(8)]
        seg.feature_data = [list(out.seg_feature_data[i]) for i in range(8)]
        hdr.seg = seg

        R, Cc = out.mi_rows, out.mi_cols
        mi = MiGrid.__new__(MiGrid)
        mi.mi_rows = R
        mi.mi_cols = Cc
        mi.sb_type = _wrap(out.sb_type, (R, Cc), np.int8)
        mi.mode = _wrap(out.mode, (R, Cc), np.int8)
        mi.uv_mode = _wrap(out.uv_mode, (R, Cc), np.int8)
        mi.tx_size = _wrap(out.tx_size, (R, Cc), np.int8)
        mi.skip = _wrap(out.skip, (R, Cc), np.int8)
        mi.segment_id = _wrap(out.segment_id, (R, Cc), np.int8)
        mi.seg_id_predicted = np.zeros((R, Cc), np.int8)
        mi.interp_filter = _wrap(out.interp, (R, Cc), np.int8)
        ref0 = _wrap(out.ref0, (R, Cc), np.int8)
        ref1 = _wrap(out.ref1, (R, Cc), np.int8)
        mi.ref = np.stack([ref0, ref1], axis=-1)
        mi.mv = _wrap(out.mv, (R, Cc, 2, 2), np.int32)
        mi.bmi_mode = _wrap(out.bmi_mode, (R, Cc, 4), np.int8)
        mi.bmi_mv = _wrap(out.bmi_mv, (R, Cc, 4, 2, 2), np.int32)

        plan = FramePlan(hdr=hdr, ch=None, mi=mi,
                         seg_map=_wrap(out.seg_map, (R, Cc), np.uint8))
        blocks = _wrap(out.blocks, (out.n_blocks, 5), np.int32) \
            if out.n_blocks else np.zeros((0, 5), np.int32)
        # copy: zero-copy views die at the next parse(), but block lists
        # are retained by deferred pack/recon work
        blocks = blocks.copy()
        plan.blocks_arr = blocks  # [B, 5] (mi_row, mi_col, bsize, bwl, bhl)
        plan.blocks = _LazyBlocks(blocks)
        plan.eob_maps = []
        plan.coeff_off_maps = []
        plan.coeffs = []
        for p in range(3):
            h4, w4 = out.plane_h4[p], out.plane_w4[p]
            plan.eob_maps.append(_wrap(out.eob_map[p], (h4, w4), np.int32))
            plan.coeff_off_maps.append(
                _wrap(out.off_map[p], (h4, w4), np.int64))
            n = out.coeff_len[p]
            plan.coeffs.append(
                _wrap(out.coeffs[p], (n,), np.int32) if n
                else np.zeros(0, np.int32))

        class _Ch:
            reference_mode = out.reference_mode
        plan.ch = _Ch()
        plan.native_parser = self   # enables the C++ fast-path packer
        self._last_plan = plan
        return plan
