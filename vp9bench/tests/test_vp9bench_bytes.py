"""The roofline byte functions on a hand-worked frame, and the facts of a
hand-worked block."""

from __future__ import annotations

import numpy as np

from vp9bench.corpus.facts import _round_q4, _uv_tx, frame_facts
from vp9bench.metrics.intra_roofline import intra_bytes
from vp9bench.metrics.mc_roofline import mc_bytes

FRAME = {
    # luma: one 16x16 read at integer pel, one 8x8 read sub-pel in x and
    # y, one 4x8 read sub-pel in y; chroma U: two 8x8 reads, one
    # sub-pel in x; V: nothing
    "mc_reads": [{"16x16": [1, 0, 0, 0], "8x8": [0, 0, 0, 1],
                  "4x8": [0, 0, 1, 0]},
                 {"8x8": [1, 1, 0, 0]}, {}],
    "inter_4x4": [22, 4, 0],
    "intra_4x4": [16, 4, 4],
    # [tx blocks, above samples, left samples, corners]
    "intra_edges": [[1, 16, 16, 1], [1, 8, 0, 0], [4, 0, 0, 0]],
}


def test_mc_bytes_hand_worked():
    y = 16 * 16 + 15 * 15 + 4 * 15 + 16 * 22
    u = 8 * 8 + 15 * 8 + 16 * 4
    assert mc_bytes(FRAME, 1) == y + u
    assert mc_bytes(FRAME, 2) == 2 * (y + u)


def test_intra_bytes_hand_worked():
    y = 16 * 16 + 16 + 16 + 1
    u = 4 * 16 + 8
    v = 4 * 16
    assert intra_bytes(FRAME, 1) == y + u + v


def test_show_existing_frame_costs_nothing():
    f = {"shown": 1, "show_existing": 1}
    assert mc_bytes(f, 1) == 0 and intra_bytes(f, 1) == 0


def test_helpers():
    assert [_round_q4(v) for v in (6, -6, 1, -1, 2, -2, 10)] == \
        [2, -2, 0, 0, 1, -1, 3]
    # 64x64 luma tx 32 -> chroma 32; 16x8 -> chroma 8x4 -> 4x4; 8x8 -> 4x4
    assert _uv_tx(16, 16, 3) == 3 and _uv_tx(4, 2, 1) == 0
    assert _uv_tx(2, 2, 1) == 0 and _uv_tx(8, 8, 2) == 2


class _Plan:
    """One 16x16 block at the frame's origin, compound, 16x16 frame."""

    def __init__(self, inter):
        class H:
            subsampling_x = subsampling_y = 1
            log2_tile_cols = 0
            width = height = 16
            frame_type = 1
            intra_only = 0
            show_frame = 1

            class lf:
                filter_level = 5
        self.hdr = H
        g = type("G", (), {})()
        g.mi_rows = g.mi_cols = 2
        g.ref = np.zeros((2, 2, 2), np.int8)
        g.mv = np.zeros((2, 2, 2, 2), np.int32)
        g.bmi_mv = np.zeros((2, 2, 4, 2, 2), np.int32)
        g.tx_size = np.full((2, 2), 1, np.int8)        # TX_8X8
        if inter:
            g.ref[..., 0], g.ref[..., 1] = 1, 2
            g.mv[..., 0, :] = (8, 3)      # ref 1: luma full-pel rows, x 3/8
            g.mv[..., 1, :] = (16, 16)    # ref 2: full-pel in luma and chroma
        self.mi = g
        self.blocks_arr = np.array([[0, 0, 6, 2, 2]])  # BLOCK_16X16


def test_facts_of_an_inter_block():
    f = frame_facts(_Plan(inter=True))
    assert f["inter_4x4"] == [16, 4, 4] and f["compound_4x4"] == [16, 4, 4]
    # luma: ref 1 sub-pel in x only, ref 2 integer; chroma (1/16 pel):
    # ref 1 row 8 is half-pel, col 3 sub-pel; ref 2 integer
    assert f["mc_reads"][0] == {"16x16": [1, 1, 0, 0]}
    assert f["mc_reads"][1] == {"8x8": [1, 0, 0, 1]}
    assert f["subpel_4x4"] == [16, 4, 4]
    assert f["intra_4x4"] == [0, 0, 0]


def test_facts_of_an_intra_block():
    f = frame_facts(_Plan(inter=False))
    assert f["intra_4x4"] == [16, 4, 4]
    # luma: four 8x8 transforms; the top-left has no neighbour, the
    # top-right a left one, the bottom-left an above one, the last all
    assert f["intra_edges"][0] == [4, 16, 16, 1]
    # chroma 8x8 block: one 8x8 transform at the frame's corner
    assert f["intra_edges"][1] == [1, 0, 0, 0]
