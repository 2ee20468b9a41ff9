"""Per-frame parse output: the mode-info grid, block records and the plan.

Parity with the reference's MACROBLOCKD / MODE_INFO structures
(vp9/common/vp9_blockd.h:120-210) re-shaped as dense numpy arrays over the
mode-info (8x8) grid, the layout the packer and the host oracle read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


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
    coeffs: List[np.ndarray] = field(default_factory=lambda: [None, None, None])
    seg_map: Optional[np.ndarray] = None
    # per-plane eob maps in 4x4 units, [h4, w4]
    eob_maps: List[np.ndarray] = field(default_factory=list)
