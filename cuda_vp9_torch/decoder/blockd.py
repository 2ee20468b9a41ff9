"""Per-frame parse output: the mode-info grid, block records and the plan.

Parity with the reference's MACROBLOCKD / MODE_INFO structures
(vp9/common/vp9_blockd.h:120-210) re-shaped as dense numpy arrays over the
mode-info (8x8) grid, the layout the packer and the host oracle read.
`MiRef` and `TokenBlock` serve the Python parse helpers the encoder
(encoder/) writes against; the C++ parser (native/) fills the rest.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import constants as C


class MiGrid:
    """Dense per-8x8-unit mode info (values replicated over block extent)."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        shape = (mi_rows, mi_cols)
        self.sb_type = np.zeros(shape, np.int8)
        self.mode = np.zeros(shape, np.int8)
        self.uv_mode = np.zeros(shape, np.int8)
        self.tx_size = np.zeros(shape, np.int8)
        self.skip = np.zeros(shape, np.int8)
        self.segment_id = np.zeros(shape, np.int8)
        self.seg_id_predicted = np.zeros(shape, np.int8)
        self.interp_filter = np.zeros(shape, np.int8)
        self.ref = np.zeros(shape + (2,), np.int8)
        self.mv = np.zeros(shape + (2, 2), np.int32)  # [.., ref, (row,col)]
        self.bmi_mode = np.zeros(shape + (4,), np.int8)
        self.bmi_mv = np.zeros(shape + (4, 2, 2), np.int32)

    def at(self, r: int, c: int) -> "MiRef":
        return MiRef(self, r, c)


class MiRef:
    """Lightweight view of one mi cell (a MODE_INFO reference)."""

    __slots__ = ("g", "r", "c")

    def __init__(self, g: MiGrid, r: int, c: int):
        self.g = g
        self.r = r
        self.c = c

    @property
    def sb_type(self):
        return int(self.g.sb_type[self.r, self.c])

    @property
    def mode(self):
        return int(self.g.mode[self.r, self.c])

    @property
    def skip(self):
        return int(self.g.skip[self.r, self.c])

    @property
    def tx_size(self):
        return int(self.g.tx_size[self.r, self.c])

    @property
    def interp_filter(self):
        return int(self.g.interp_filter[self.r, self.c])

    @property
    def seg_id_predicted(self):
        return int(self.g.seg_id_predicted[self.r, self.c])

    def ref_frame(self, i: int) -> int:
        return int(self.g.ref[self.r, self.c, i])

    @property
    def is_inter(self) -> bool:
        return self.g.ref[self.r, self.c, 0] > C.INTRA_FRAME

    @property
    def has_second_ref(self) -> bool:
        return self.g.ref[self.r, self.c, 1] > C.INTRA_FRAME

    def mv(self, i: int):
        m = self.g.mv[self.r, self.c, i]
        return (int(m[0]), int(m[1]))

    def bmi_as_mode(self, i: int) -> int:
        return int(self.g.bmi_mode[self.r, self.c, i])

    def bmi_mv(self, i: int, ref: int):
        m = self.g.bmi_mv[self.r, self.c, i, ref]
        return (int(m[0]), int(m[1]))

    def y_mode(self, block: int) -> int:
        """get_y_mode (vp9_blockd.h): sub-8x8 uses per-4x4 sub-mode."""
        if self.sb_type < C.BLOCK_8X8:
            return self.bmi_as_mode(block)
        return self.mode


@dataclass
class TokenBlock:
    """One coded transform block, recorded in exact parse order."""
    plane: int
    x4: int       # 4x4-unit col within the plane (frame coords)
    y4: int
    tx_size: int
    tx_type: int
    eob: int
    coeff_off: int  # offset into the plane's flat dqcoeff stream


@dataclass
class BlockRecord:
    """One coded prediction block, in parse order (the recon work list)."""
    mi_row: int
    mi_col: int
    bsize: int
    bwl: int
    bhl: int


@dataclass
class FramePlan:
    """Everything the reconstruction stage needs, emitted by the host parse.

    The counterpart of the reference's per-frame `frameBuf`/`ModeInfoBuf`
    work buffers (vpx-master/buffers_struct.h), as dense arrays.
    """

    hdr: object = None
    ch: object = None
    mi: Optional[MiGrid] = None
    blocks: List[BlockRecord] = field(default_factory=list)
    tokens: List[TokenBlock] = field(default_factory=list)
    coeffs: List[np.ndarray] = field(default_factory=lambda: [None, None, None])
    seg_map: Optional[np.ndarray] = None
    # per-plane eob maps in 4x4 units, [h4, w4]
    eob_maps: List[np.ndarray] = field(default_factory=list)
    corrupted: bool = False
