"""VP9 normative tables: the auto-generated spec constants (tables_gen.py)
as numpy arrays, and the `FrameContext` / `FrameCounts` probability state
(parity with libvpx `FRAME_CONTEXT` / `FRAME_COUNTS`,
vp9/common/vp9_entropymode.h).  The decoder's contexts and their
adaptation live in the C++ parser (native/); `FrameContext` is here for
the encoder (encoder/) and the Python parse helpers it writes against.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np

from . import tables_gen as T

# ---------------------------------------------------------------- geometry

B_WIDTH_LOG2 = np.array(T.B_WIDTH_LOG2_LOOKUP, np.int32)
B_HEIGHT_LOG2 = np.array(T.B_HEIGHT_LOG2_LOOKUP, np.int32)
NUM_4X4_W = np.array(T.NUM_4X4_BLOCKS_WIDE_LOOKUP, np.int32)
NUM_4X4_H = np.array(T.NUM_4X4_BLOCKS_HIGH_LOOKUP, np.int32)
MI_WIDTH_LOG2 = np.array(T.MI_WIDTH_LOG2_LOOKUP, np.int32)
NUM_8X8_W = np.array(T.NUM_8X8_BLOCKS_WIDE_LOOKUP, np.int32)
NUM_8X8_H = np.array(T.NUM_8X8_BLOCKS_HIGH_LOOKUP, np.int32)
SIZE_GROUP = np.array(T.SIZE_GROUP_LOOKUP, np.int32)
NUM_PELS_LOG2 = np.array(T.NUM_PELS_LOG2_LOOKUP, np.int32)
PARTITION_LOOKUP = np.array(T.PARTITION_LOOKUP, np.int32)
SUBSIZE_LOOKUP = np.array(T.SUBSIZE_LOOKUP, np.int32)
MAX_TXSIZE_LOOKUP = np.array(T.MAX_TXSIZE_LOOKUP, np.int32)
TXSIZE_TO_BSIZE = np.array(T.TXSIZE_TO_BSIZE, np.int32)
TX_MODE_TO_BIGGEST_TX_SIZE = np.array(T.TX_MODE_TO_BIGGEST_TX_SIZE, np.int32)
SS_SIZE_LOOKUP = np.array(T.SS_SIZE_LOOKUP, np.int32)
UV_TXSIZE_LOOKUP = np.array(T.UV_TXSIZE_LOOKUP, np.int32)
PARTITION_CONTEXT_LOOKUP = np.array(T.PARTITION_CONTEXT_LOOKUP, np.int32)
MV_REF_BLOCKS = np.array(T.MV_REF_BLOCKS, np.int32)
IDX_N_COLUMN_TO_SUBBLOCK = np.array(T.IDX_N_COLUMN_TO_SUBBLOCK, np.int32)

# ---------------------------------------------------------------- trees

INTRA_MODE_TREE = np.array(T.VP9_INTRA_MODE_TREE, np.int32)
INTER_MODE_TREE = np.array(T.VP9_INTER_MODE_TREE, np.int32)
PARTITION_TREE = np.array(T.VP9_PARTITION_TREE, np.int32)
SWITCHABLE_INTERP_TREE = np.array(T.VP9_SWITCHABLE_INTERP_TREE, np.int32)
MV_JOINT_TREE = np.array(T.VP9_MV_JOINT_TREE, np.int32)
MV_CLASS_TREE = np.array(T.VP9_MV_CLASS_TREE, np.int32)
MV_CLASS0_TREE = np.array(T.VP9_MV_CLASS0_TREE, np.int32)
MV_FP_TREE = np.array(T.VP9_MV_FP_TREE, np.int32)
# the 8-segment balanced tree (vp9/common/vp9_entropymode.c vp9_segment_tree)
SEGMENT_TREE = np.array([2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7],
                        np.int32)

# ---------------------------------------------------------------- probs

KF_Y_MODE_PROB = np.array(T.VP9_KF_Y_MODE_PROB, np.uint8)
KF_UV_MODE_PROB = np.array(T.VP9_KF_UV_MODE_PROB, np.uint8)
KF_PARTITION_PROBS = np.array(T.VP9_KF_PARTITION_PROBS, np.uint8)
PARETO8_FULL = np.array(T.VP9_PARETO8_FULL, np.uint8)
CAT_PROBS = [np.array(getattr(T, f"VP9_CAT{i}_PROB"), np.uint8)
             for i in range(1, 7)]
CAT6_PROB_HIGH12 = np.array(T.VP9_CAT6_PROB_HIGH12, np.uint8)
COEFBAND_8X8PLUS = np.array(T.VP9_COEFBAND_TRANS_8X8PLUS, np.int32)
COEFBAND_4X4 = np.array(T.VP9_COEFBAND_TRANS_4X4, np.int32)
ENERGY_CLASS = np.array(T.VP9_PT_ENERGY_CLASS, np.int32)
INV_MAP_TABLE = np.array(T.INV_MAP_TABLE, np.int32)


def _pad_coef(raw):
    """[2][2][6][3 or 6][6? ctx][3] → full [2][2][6][6][3] (C zero-fill)."""
    a = np.zeros((2, 2, 6, 6, 3), np.uint8)
    for i in range(2):
        for j in range(2):
            for k in range(6):
                band = raw[i][j][k]
                for l, probs in enumerate(band):
                    a[i, j, k, l] = probs
    return a


DEFAULT_COEF_PROBS = np.stack([
    _pad_coef(T.DEFAULT_COEF_PROBS_4X4),
    _pad_coef(T.DEFAULT_COEF_PROBS_8X8),
    _pad_coef(T.DEFAULT_COEF_PROBS_16X16),
    _pad_coef(T.DEFAULT_COEF_PROBS_32X32),
])  # [TX_SIZES][PLANE_TYPES][REF_TYPES][COEF_BANDS][COEFF_CONTEXTS][3]

# ---------------------------------------------------------------- scans

_scan = {
    (0, "default"): T.DEFAULT_SCAN_4X4, (0, "col"): T.COL_SCAN_4X4,
    (0, "row"): T.ROW_SCAN_4X4,
    (1, "default"): T.DEFAULT_SCAN_8X8, (1, "col"): T.COL_SCAN_8X8,
    (1, "row"): T.ROW_SCAN_8X8,
    (2, "default"): T.DEFAULT_SCAN_16X16, (2, "col"): T.COL_SCAN_16X16,
    (2, "row"): T.ROW_SCAN_16X16,
    (3, "default"): T.DEFAULT_SCAN_32X32,
}
_nb = {
    (0, "default"): T.DEFAULT_SCAN_4X4_NEIGHBORS,
    (0, "col"): T.COL_SCAN_4X4_NEIGHBORS,
    (0, "row"): T.ROW_SCAN_4X4_NEIGHBORS,
    (1, "default"): T.DEFAULT_SCAN_8X8_NEIGHBORS,
    (1, "col"): T.COL_SCAN_8X8_NEIGHBORS,
    (1, "row"): T.ROW_SCAN_8X8_NEIGHBORS,
    (2, "default"): T.DEFAULT_SCAN_16X16_NEIGHBORS,
    (2, "col"): T.COL_SCAN_16X16_NEIGHBORS,
    (2, "row"): T.ROW_SCAN_16X16_NEIGHBORS,
    (3, "default"): T.DEFAULT_SCAN_32X32_NEIGHBORS,
}


class ScanOrder:
    __slots__ = ("scan", "neighbors", "iscan")

    def __init__(self, scan, neighbors):
        self.scan = np.array(scan, np.int32)
        nb = np.array(neighbors, np.int32).reshape(-1, 2)
        self.neighbors = nb
        self.iscan = np.argsort(self.scan).astype(np.int32)


_SCAN_CACHE = {k: ScanOrder(v, _nb[k]) for k, v in _scan.items()}

# vp9_scan_orders[tx_size][tx_type] mapping (vp9/common/vp9_scan.c:697):
# DCT_DCT→default, ADST_DCT→row, DCT_ADST→col, ADST_ADST→default; 32x32 all
# default.
SCAN_ORDERS = [[None] * 4 for _ in range(4)]
for _tx in range(4):
    for _tt, _kind in enumerate(("default", "row", "col", "default")):
        _k = (_tx, _kind if _tx < 3 else "default")
        SCAN_ORDERS[_tx][_tt] = _SCAN_CACHE[_k]

# ---------------------------------------------------------------- quant

DC_QLOOKUP = {8: np.array(T.DC_QLOOKUP, np.int32),
              10: np.array(T.DC_QLOOKUP_10, np.int32),
              12: np.array(T.DC_QLOOKUP_12, np.int32)}
AC_QLOOKUP = {8: np.array(T.AC_QLOOKUP, np.int32),
              10: np.array(T.AC_QLOOKUP_10, np.int32),
              12: np.array(T.AC_QLOOKUP_12, np.int32)}

# ---------------------------------------------------------------- filters

# index order matches the InterpFilter enum: EIGHTTAP, EIGHTTAP_SMOOTH,
# EIGHTTAP_SHARP, BILINEAR (vp9/common/vp9_filter.c:79 vp9_filter_kernels)
FILTER_KERNELS = np.stack([
    np.array(T.SUB_PEL_FILTERS_8, np.int32),
    np.array(T.SUB_PEL_FILTERS_8LP, np.int32),
    np.array(T.SUB_PEL_FILTERS_8S, np.int32),
    np.array(T.BILINEAR_FILTERS, np.int32),
])
FILTER_4TAP = np.array(T.SUB_PEL_FILTERS_4, np.int32)

# ---------------------------------------------------------------- contexts


def _nmv_default():
    j, comps = T.DEFAULT_NMV_CONTEXT
    out = {"joints": np.array(j, np.uint8)}
    names = ["sign", "classes", "class0", "bits", "class0_fp", "fp",
             "class0_hp", "hp"]
    for n in names:
        out[n] = np.stack([np.array(c[names.index(n)], np.uint8)
                           for c in comps])
    return out


@dataclass
class FrameContext:
    """All backward-adaptable probabilities (libvpx FRAME_CONTEXT)."""

    y_mode: np.ndarray          # [BLOCK_SIZE_GROUPS][9]
    uv_mode: np.ndarray         # [INTRA_MODES][9]
    partition: np.ndarray       # [PARTITION_CONTEXTS][3]
    coef: np.ndarray            # [TX][PLANE][REF][BAND][CTX][3]
    switchable_interp: np.ndarray  # [4][2]
    inter_mode: np.ndarray      # [7][3]
    intra_inter: np.ndarray     # [4]
    comp_inter: np.ndarray      # [5]
    comp_ref: np.ndarray        # [5]
    single_ref: np.ndarray      # [5][2]
    tx32: np.ndarray            # [2][3]
    tx16: np.ndarray            # [2][2]
    tx8: np.ndarray             # [2][1]
    skip: np.ndarray            # [3]
    mv_joints: np.ndarray       # [3]
    mv_sign: np.ndarray         # [2]
    mv_classes: np.ndarray      # [2][10]
    mv_class0: np.ndarray       # [2][1]
    mv_bits: np.ndarray         # [2][10]
    mv_class0_fp: np.ndarray    # [2][2][3]
    mv_fp: np.ndarray           # [2][3]
    mv_class0_hp: np.ndarray    # [2]
    mv_hp: np.ndarray           # [2]

    @staticmethod
    def default() -> "FrameContext":
        nmv = _nmv_default()
        return FrameContext(
            y_mode=np.array(T.DEFAULT_IF_Y_PROBS, np.uint8),
            uv_mode=np.array(T.DEFAULT_IF_UV_PROBS, np.uint8),
            partition=np.array(T.DEFAULT_PARTITION_PROBS, np.uint8),
            coef=DEFAULT_COEF_PROBS.copy(),
            switchable_interp=np.array(T.DEFAULT_SWITCHABLE_INTERP_PROB,
                                       np.uint8),
            inter_mode=np.array(T.DEFAULT_INTER_MODE_PROBS, np.uint8),
            intra_inter=np.array(T.DEFAULT_INTRA_INTER_P, np.uint8),
            comp_inter=np.array(T.DEFAULT_COMP_INTER_P, np.uint8),
            comp_ref=np.array(T.DEFAULT_COMP_REF_P, np.uint8),
            single_ref=np.array(T.DEFAULT_SINGLE_REF_P, np.uint8),
            tx32=np.array(T.DEFAULT_TX_PROBS[0], np.uint8),
            tx16=np.array(T.DEFAULT_TX_PROBS[1], np.uint8),
            tx8=np.array(T.DEFAULT_TX_PROBS[2], np.uint8),
            skip=np.array(T.DEFAULT_SKIP_PROBS, np.uint8),
            mv_joints=nmv["joints"][:3] if nmv["joints"].shape == (3,)
            else nmv["joints"],
            mv_sign=nmv["sign"],
            mv_classes=nmv["classes"],
            mv_class0=nmv["class0"],
            mv_bits=nmv["bits"],
            mv_class0_fp=nmv["class0_fp"],
            mv_fp=nmv["fp"],
            mv_class0_hp=nmv["class0_hp"],
            mv_hp=nmv["hp"],
        )

    def copy(self) -> "FrameContext":
        return FrameContext(**{f.name: getattr(self, f.name).copy()
                               for f in fields(self)})


@dataclass
class FrameCounts:
    """Symbol counts accumulated during decode for backward adaptation."""

    y_mode: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 10), np.uint32))
    uv_mode: np.ndarray = field(
        default_factory=lambda: np.zeros((10, 10), np.uint32))
    partition: np.ndarray = field(
        default_factory=lambda: np.zeros((16, 4), np.uint32))
    coef: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 2, 2, 6, 6, 4), np.uint32))
    eob_branch: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 2, 2, 6, 6), np.uint32))
    switchable_interp: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 3), np.uint32))
    inter_mode: np.ndarray = field(
        default_factory=lambda: np.zeros((7, 4), np.uint32))
    intra_inter: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 2), np.uint32))
    comp_inter: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 2), np.uint32))
    comp_ref: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 2), np.uint32))
    single_ref: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 2, 2), np.uint32))
    tx32: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 4), np.uint32))
    tx16: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 3), np.uint32))
    tx8: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.uint32))
    skip: np.ndarray = field(
        default_factory=lambda: np.zeros((3, 2), np.uint32))
    mv_joints: np.ndarray = field(
        default_factory=lambda: np.zeros(4, np.uint32))
    mv_sign: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.uint32))
    mv_classes: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 11), np.uint32))
    mv_class0: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.uint32))
    mv_bits: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 10, 2), np.uint32))
    mv_class0_fp: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2, 4), np.uint32))
    mv_fp: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 4), np.uint32))
    mv_class0_hp: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.uint32))
    mv_hp: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.uint32))
