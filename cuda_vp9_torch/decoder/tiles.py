"""Tile decode: partition tree walk, per-block parse, plan emission.

Parity with the reference's entropy pass of `decode_tiles`
(vp9/decoder/vp9_decodeframe.c:2303-2430), `decode_partition` (:1386),
`decode_block` (:1198), `detoken_block` (:919), and tile splitting
(`get_tile_buffers` (:1910), vp9/common/vp9_tile_common.c).

Instead of the reference's MiBuf/frameBuf pointer soup, the parse emits a
dense `FramePlan` (numpy tensors).

The port parses every stream it decodes with the C++ parser (native/);
this module, with decodemv, mvref, detokenize and compressed_header, is
here for the encoder (encoder/), which takes its symbol contexts
(`FrameParseState`, `TileInfo`, `Xd`, the partition contexts) from the
parse side so that the writer cannot drift from it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import models as M
from . import constants as C
from . import decodemv, detokenize
from .bitreader import BoolDecoder
from .blockd import BlockRecord, FramePlan, MiGrid
from .headers import BitstreamError, FrameHeader

_INTRA_MODE_TO_TX_TYPE = [C.DCT_DCT, C.ADST_DCT, C.DCT_ADST, C.DCT_DCT,
                          C.ADST_ADST, C.ADST_DCT, C.DCT_ADST, C.DCT_ADST,
                          C.ADST_DCT, C.ADST_ADST]


@dataclass
class TileInfo:
    mi_row_start: int = 0
    mi_row_end: int = 0
    mi_col_start: int = 0
    mi_col_end: int = 0


class Xd:
    """Per-block decode context (MACROBLOCKD subset)."""

    __slots__ = ("tile", "above", "left", "mb_to_top_edge",
                 "mb_to_bottom_edge", "mb_to_left_edge", "mb_to_right_edge",
                 "bmode_blocks_wl", "bmode_blocks_hl")

    def __init__(self):
        self.tile = None
        self.above = None
        self.left = None
        self.mb_to_top_edge = 0
        self.mb_to_bottom_edge = 0
        self.mb_to_left_edge = 0
        self.mb_to_right_edge = 0
        self.bmode_blocks_wl = 1
        self.bmode_blocks_hl = 1


class FrameParseState:
    """All mutable state for one frame's entropy decode."""

    def __init__(self, hdr: FrameHeader, ch, fc, counts, dec_state):
        self.hdr = hdr
        self.fc = fc
        self.counts = counts
        self.seg = hdr.seg
        self.mi_rows = hdr.mi_rows
        self.mi_cols = hdr.mi_cols
        self.mi = MiGrid(hdr.mi_rows, hdr.mi_cols)
        self.frame_is_intra_only = hdr.frame_is_intra_only
        self.tx_mode = ch.tx_mode
        self.reference_mode = ch.reference_mode
        self.comp_fixed_ref = ch.comp_fixed_ref
        self.comp_var_ref = ch.comp_var_ref
        self.ref_frame_sign_bias = hdr.ref_frame_sign_bias
        self.allow_high_precision_mv = hdr.allow_high_precision_mv
        self.interp_filter = hdr.interp_filter
        self.lossless = hdr.lossless
        self.bit_depth = hdr.bit_depth
        self.subsampling_x = dec_state.subsampling_x
        self.subsampling_y = dec_state.subsampling_y
        self.corrupted = False

        # segmentation maps
        self.seg_map_cur = np.zeros(self.mi_rows * self.mi_cols,
                                    np.uint8).reshape(self.mi_rows,
                                                      self.mi_cols)
        self.seg_map_last = dec_state.seg_map_last

        # temporal mv prediction
        self.use_prev_frame_mvs = dec_state.use_prev_frame_mvs
        self.prev_ref = dec_state.prev_ref
        self.prev_mv = dec_state.prev_mv
        shape = (self.mi_rows, self.mi_cols)
        self.cur_ref = np.full(shape + (2,), C.INTRA_FRAME, np.int8)
        self.cur_mv = np.zeros(shape + (2, 2), np.int32)

        # dequant per segment: [plane_type][seg][dc/ac]
        bd = hdr.bit_depth
        dcq, acq = M.DC_QLOOKUP[bd], M.AC_QLOOKUP[bd]

        def qindex(seg_id):
            if self.seg.enabled and self.seg.active(seg_id, C.SEG_LVL_ALT_Q):
                data = self.seg.data(seg_id, C.SEG_LVL_ALT_Q)
                q = data if self.seg.abs_delta else hdr.base_qindex + data
                return max(0, min(C.MAXQ, q))
            return hdr.base_qindex

        def q(tab, delta, seg_id):
            return int(tab[max(0, min(C.MAXQ, qindex(seg_id) + delta))])

        self.seg_dequant = [
            [(q(dcq, hdr.y_dc_delta_q, s), q(acq, 0, s))
             for s in range(C.MAX_SEGMENTS)],
            [(q(dcq, hdr.uv_dc_delta_q, s), q(acq, hdr.uv_ac_delta_q, s))
             for s in range(C.MAX_SEGMENTS)],
        ]

        # frozen per-frame probability tables as python lists (fast access)
        self.coef_probs_list = fc.coef.tolist()
        self.partition_probs = (M.KF_PARTITION_PROBS.tolist()
                                if self.frame_is_intra_only
                                else fc.partition.tolist())
        self.scans = M.SCAN_ORDERS

        # entropy contexts (above per frame width, left per superblock row)
        aligned = (self.mi_cols + 7) & ~7
        ss = (0, self.subsampling_x, self.subsampling_x)
        ssy = (0, self.subsampling_y, self.subsampling_y)
        self.above_ctx = [np.zeros(((aligned * 2) >> ss[p]) + 8, np.uint8)
                          for p in range(3)]
        self.left_ctx = [np.zeros(16 >> ssy[p], np.uint8) for p in range(3)]
        self.above_seg_ctx = np.zeros(aligned + 8, np.uint8)
        self.left_seg_ctx = np.zeros(8, np.uint8)

        # plan output
        self.plan = FramePlan(hdr=hdr, ch=ch, mi=self.mi,
                              seg_map=self.seg_map_cur)
        w4y, h4y = self.mi_cols * 2, self.mi_rows * 2
        self.plane_w4 = [w4y, w4y >> self.subsampling_x,
                         w4y >> self.subsampling_x]
        self.plane_h4 = [h4y, h4y >> self.subsampling_y,
                         h4y >> self.subsampling_y]
        self.plan.eob_maps = [np.zeros((self.plane_h4[p], self.plane_w4[p]),
                                       np.int32) for p in range(3)]
        self.coeff_off_maps = [np.full((self.plane_h4[p], self.plane_w4[p]),
                                       -1, np.int64) for p in range(3)]
        self.coeff_chunks = [[], [], []]
        self.coeff_len = [0, 0, 0]
        self.plan.coeff_off_maps = self.coeff_off_maps

    # ---------------------------------------------------------------- ctx

    def zero_left_ctx(self):
        for p in range(3):
            self.left_ctx[p][:] = 0
        self.left_seg_ctx[:] = 0

    def plane_ss(self, plane):
        return ((self.subsampling_x if plane else 0),
                (self.subsampling_y if plane else 0))


def _uv_txsize(bsize, tx_size, ss_x, ss_y):
    return int(M.UV_TXSIZE_LOOKUP[bsize][tx_size][ss_x][ss_y])


def _dec_partition_plane_context(st: FrameParseState, mi_row, mi_col, bsl):
    above = (int(st.above_seg_ctx[mi_col]) >> bsl) & 1
    left = (int(st.left_seg_ctx[mi_row & 7]) >> bsl) & 1
    return (left * 2 + above) + bsl * C.PARTITION_PLOFFSET


def _dec_update_partition_context(st, mi_row, mi_col, subsize, bw):
    st.above_seg_ctx[mi_col:mi_col + bw] = \
        M.PARTITION_CONTEXT_LOOKUP[subsize][0]
    base = mi_row & 7
    st.left_seg_ctx[base:base + bw] = M.PARTITION_CONTEXT_LOOKUP[subsize][1]


def _read_partition(st, r, mi_row, mi_col, has_rows, has_cols, bsl):
    ctx = _dec_partition_plane_context(st, mi_row, mi_col, bsl)
    probs = st.partition_probs[ctx]
    if has_rows and has_cols:
        p = r.read_tree(M.PARTITION_TREE, probs)
    elif not has_rows and has_cols:
        p = C.PARTITION_SPLIT if r.read(probs[1]) else C.PARTITION_HORZ
    elif has_rows and not has_cols:
        p = C.PARTITION_SPLIT if r.read(probs[2]) else C.PARTITION_VERT
    else:
        p = C.PARTITION_SPLIT
    if st.counts is not None:
        st.counts.partition[ctx][p] += 1
    return p


# -------------------------------------------------------------- detokenize

def _detoken_block(st: FrameParseState, xd: Xd, r: BoolDecoder,
                   mi_row, mi_col, bsize, bwl, bhl):
    """Parse all transform-block tokens of one coded block; returns eobtotal.

    Mirrors detoken_block (vp9_decodeframe.c:919) + the stock traversal.
    """
    g = st.mi
    is_inter = g.ref[mi_row, mi_col, 0] > C.INTRA_FRAME
    tx_size_y = int(g.tx_size[mi_row, mi_col])
    seg_id = int(g.segment_id[mi_row, mi_col])
    eobtotal = 0
    counts = st.counts

    for plane in range(3):
        ss_x, ss_y = st.plane_ss(plane)
        plane_type = 1 if plane else 0
        if plane:
            tx_size = _uv_txsize(bsize, tx_size_y, ss_x, ss_y)
        else:
            tx_size = tx_size_y
        n4_w = (1 << bwl) >> ss_x
        n4_h = (1 << bhl) >> ss_y
        step = 1 << tx_size
        max_blocks_wide = n4_w + (0 if xd.mb_to_right_edge >= 0
                                  else xd.mb_to_right_edge >> (5 + ss_x))
        max_blocks_high = n4_h + (0 if xd.mb_to_bottom_edge >= 0
                                  else xd.mb_to_bottom_edge >> (5 + ss_y))
        clip_w = max_blocks_wide if xd.mb_to_right_edge < 0 else 0
        clip_h = max_blocks_high if xd.mb_to_bottom_edge < 0 else 0

        dq = st.seg_dequant[plane_type][seg_id]
        coef_probs = st.coef_probs_list[tx_size][plane_type][int(is_inter)]
        cc = ce = None
        if counts is not None:
            cc = counts.coef[tx_size][plane_type][int(is_inter)]
            ce = counts.eob_branch[tx_size][plane_type][int(is_inter)]

        above = st.above_ctx[plane]
        left = st.left_ctx[plane]
        apos = (mi_col * 2) >> ss_x
        lpos = ((mi_row * 2) & 15) >> ss_y
        bx4 = apos
        by4 = (mi_row * 2) >> ss_y
        eob_map = st.plan.eob_maps[plane]
        off_map = st.coeff_off_maps[plane]

        mode = int(g.mode[mi_row, mi_col]) if plane == 0 else \
            int(g.uv_mode[mi_row, mi_col])
        n = 16 << (tx_size << 1)

        row = 0
        while row < max_blocks_high:
            col = 0
            while col < max_blocks_wide:
                if not is_inter:
                    if bsize < C.BLOCK_8X8 and plane == 0:
                        mode = int(g.bmi_mode[mi_row, mi_col, (row << 1) + col])
                    tx_type = (C.DCT_DCT if (plane or st.lossless)
                               else _INTRA_MODE_TO_TX_TYPE[mode])
                else:
                    tx_type = C.DCT_DCT
                sc = st.scans[tx_size][tx_type if not (plane or st.lossless)
                                       else C.DCT_DCT]

                # entry context from above/left 4x4 flags
                if tx_size == C.TX_4X4:
                    ctx = int(above[apos + col] != 0) + int(
                        left[lpos + row] != 0)
                else:
                    ctx = int(above[apos + col:apos + col + step].any()) + \
                        int(left[lpos + row:lpos + row + step].any())

                dqcoeff = np.zeros(n, np.int32)
                eob = detokenize.decode_coefs(
                    r, coef_probs, cc, ce, plane_type, int(is_inter),
                    dqcoeff, tx_size, dq, ctx,
                    sc.scan.tolist(), sc.neighbors.reshape(-1).tolist(),
                    st.bit_depth)

                # write back entropy contexts with edge masking
                nz = 1 if eob > 0 else 0
                sh_a = (step - (clip_w - col)) if (clip_w and
                                                  step + col > clip_w) else 0
                sh_l = (step - (clip_h - row)) if (clip_h and
                                                  step + row > clip_h) else 0
                above[apos + col:apos + col + step] = 0
                above[apos + col:apos + col + step - sh_a] = nz
                left[lpos + row:lpos + row + step] = 0
                left[lpos + row:lpos + row + step - sh_l] = nz

                eob_map[by4 + row, bx4 + col] = eob
                if eob > 0:
                    off_map[by4 + row, bx4 + col] = st.coeff_len[plane]
                    st.coeff_chunks[plane].append(dqcoeff)
                    st.coeff_len[plane] += n
                eobtotal += eob
                col += step
            row += step
    return eobtotal


def _reset_skip_context(st, xd, mi_row, mi_col, bwl, bhl):
    for plane in range(3):
        ss_x, ss_y = st.plane_ss(plane)
        n4_w = (1 << bwl) >> ss_x
        n4_h = (1 << bhl) >> ss_y
        apos = (mi_col * 2) >> ss_x
        lpos = ((mi_row * 2) & 15) >> ss_y
        st.above_ctx[plane][apos:apos + n4_w] = 0
        st.left_ctx[plane][lpos:lpos + n4_h] = 0


# -------------------------------------------------------------- blocks

def _decode_block(st: FrameParseState, xd: Xd, r: BoolDecoder,
                  mi_row, mi_col, bsize, bwl, bhl):
    g = st.mi
    bw = 1 << (bwl - 1)
    bh = 1 << (bhl - 1)
    x_mis = min(bw, st.mi_cols - mi_col)
    y_mis = min(bh, st.mi_rows - mi_row)
    less8x8 = bsize < C.BLOCK_8X8

    # set_offsets
    g.sb_type[mi_row, mi_col] = bsize
    xd.mb_to_top_edge = -((mi_row * C.MI_SIZE) * 8)
    xd.mb_to_bottom_edge = ((st.mi_rows - bh - mi_row) * C.MI_SIZE) * 8
    xd.mb_to_left_edge = -((mi_col * C.MI_SIZE) * 8)
    xd.mb_to_right_edge = ((st.mi_cols - bw - mi_col) * C.MI_SIZE) * 8
    xd.above = g.at(mi_row - 1, mi_col) if mi_row > 0 else None
    xd.left = (g.at(mi_row, mi_col - 1)
               if mi_col > xd.tile.mi_col_start else None)

    decodemv.read_mode_info(st, xd, r, mi_row, mi_col, x_mis, y_mis)

    skip = int(g.skip[mi_row, mi_col])
    if skip:
        _reset_skip_context(st, xd, mi_row, mi_col, bwl, bhl)
    else:
        eobtotal = _detoken_block(st, xd, r, mi_row, mi_col, bsize, bwl, bhl)
        if (g.ref[mi_row, mi_col, 0] > C.INTRA_FRAME and not less8x8
                and eobtotal == 0):
            # inter block with no coded coefficients: becomes skip for
            # loop-filter and subsequent context purposes (stock decode_block)
            g.skip[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis] = 1

    st.plan.blocks.append(BlockRecord(mi_row, mi_col, bsize, bwl, bhl))
    st.corrupted |= r.has_error()


def _decode_partition(st: FrameParseState, xd: Xd, r: BoolDecoder,
                      mi_row, mi_col, bsize, n4x4_l2):
    if mi_row >= st.mi_rows or mi_col >= st.mi_cols:
        return
    n8x8_l2 = n4x4_l2 - 1
    num_8x8_wh = 1 << n8x8_l2
    hbs = num_8x8_wh >> 1
    has_rows = (mi_row + hbs) < st.mi_rows
    has_cols = (mi_col + hbs) < st.mi_cols

    partition = _read_partition(st, r, mi_row, mi_col, has_rows, has_cols,
                                n8x8_l2)
    subsize = int(M.SUBSIZE_LOOKUP[partition][bsize])
    if not hbs:
        xd.bmode_blocks_wl = 1 >> (1 if partition & C.PARTITION_VERT else 0)
        xd.bmode_blocks_hl = 1 >> (1 if partition & C.PARTITION_HORZ else 0)
        _decode_block(st, xd, r, mi_row, mi_col, subsize, 1, 1)
    elif partition == C.PARTITION_NONE:
        _decode_block(st, xd, r, mi_row, mi_col, subsize, n4x4_l2, n4x4_l2)
    elif partition == C.PARTITION_HORZ:
        _decode_block(st, xd, r, mi_row, mi_col, subsize, n4x4_l2, n8x8_l2)
        if has_rows:
            _decode_block(st, xd, r, mi_row + hbs, mi_col, subsize,
                          n4x4_l2, n8x8_l2)
    elif partition == C.PARTITION_VERT:
        _decode_block(st, xd, r, mi_row, mi_col, subsize, n8x8_l2, n4x4_l2)
        if has_cols:
            _decode_block(st, xd, r, mi_row, mi_col + hbs, subsize,
                          n8x8_l2, n4x4_l2)
    else:  # SPLIT
        _decode_partition(st, xd, r, mi_row, mi_col, subsize, n8x8_l2)
        _decode_partition(st, xd, r, mi_row, mi_col + hbs, subsize, n8x8_l2)
        _decode_partition(st, xd, r, mi_row + hbs, mi_col, subsize, n8x8_l2)
        _decode_partition(st, xd, r, mi_row + hbs, mi_col + hbs, subsize,
                          n8x8_l2)

    if bsize >= C.BLOCK_8X8 and (bsize == C.BLOCK_8X8
                                 or partition != C.PARTITION_SPLIT):
        _dec_update_partition_context(st, mi_row, mi_col, subsize, num_8x8_wh)


# -------------------------------------------------------------- tiles

def _get_tile_offset(idx, mis, log2):
    sb_cols = ((mis + 7) & ~7) >> C.MI_BLOCK_SIZE_LOG2
    offset = ((idx * sb_cols) >> log2) << C.MI_BLOCK_SIZE_LOG2
    return min(offset, mis)


def get_tile_buffers(data: bytes, offset: int, hdr: FrameHeader):
    """Split the tile data region into per-tile byte spans."""
    tile_cols = 1 << hdr.log2_tile_cols
    tile_rows = 1 << hdr.log2_tile_rows
    spans = []
    pos = offset
    for tr in range(tile_rows):
        row_spans = []
        for tc in range(tile_cols):
            is_last = (tr == tile_rows - 1) and (tc == tile_cols - 1)
            if is_last:
                size = len(data) - pos
            else:
                if pos + 4 > len(data):
                    raise BitstreamError("truncated tile length")
                size = int.from_bytes(data[pos:pos + 4], "big")
                pos += 4
            if pos + size > len(data):
                raise BitstreamError("tile overruns frame buffer")
            row_spans.append((pos, size))
            pos += size
        spans.append(row_spans)
    return spans


def parse_tiles(data: bytes, st: FrameParseState) -> FramePlan:
    hdr = st.hdr
    offset = (hdr.uncompressed_header_size_in_bytes
              + hdr.header_size_in_bytes)
    spans = get_tile_buffers(data, offset, hdr)
    tile_cols = 1 << hdr.log2_tile_cols
    tile_rows = 1 << hdr.log2_tile_rows

    for tr in range(tile_rows):
        row_start = _get_tile_offset(tr, st.mi_rows, hdr.log2_tile_rows)
        row_end = _get_tile_offset(tr + 1, st.mi_rows, hdr.log2_tile_rows)
        for tc in range(tile_cols):
            col_start = _get_tile_offset(tc, st.mi_cols, hdr.log2_tile_cols)
            col_end = _get_tile_offset(tc + 1, st.mi_cols, hdr.log2_tile_cols)
            pos, size = spans[tr][tc]
            r = BoolDecoder(data, pos, size)
            xd = Xd()
            xd.tile = TileInfo(row_start, row_end, col_start, col_end)
            for mi_row in range(row_start, row_end, C.MI_BLOCK_SIZE):
                st.zero_left_ctx()
                for mi_col in range(col_start, col_end, C.MI_BLOCK_SIZE):
                    _decode_partition(st, xd, r, mi_row, mi_col,
                                      C.BLOCK_64X64, 4)
            st.corrupted |= r.has_error()

    plan = st.plan
    plan.coeffs = [
        (np.concatenate(st.coeff_chunks[p]) if st.coeff_chunks[p]
         else np.zeros(0, np.int32)) for p in range(3)]
    plan.corrupted = st.corrupted
    return plan
