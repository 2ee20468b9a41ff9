"""Bit-exact inter prediction (motion compensation) oracle.

Parity with the decoder MC path: dec_build_inter_predictors
(vp9/decoder/vp9_decodeframe.c:556-800 — window derivation, border
extension via edge-clamped sampling at crop dims), the 8-tap two-stage
convolve (vpx_dsp/vpx_convolve.c: convolve_horiz/vert with intermediate
pixel rounding+clipping), compound averaging (convolve8_avg), scaled
references (vp9/common/vp9_scale.c scale factors and vp9_scale_mv), and
chroma MV averaging for sub-8x8 blocks (vp9_reconinter.c:112
average_split_mvs).
"""

from __future__ import annotations

import numpy as np

SUBPEL_BITS = 4
SUBPEL_SHIFTS = 16
SUBPEL_MASK = 15
FILTER_BITS = 7
SUBPEL_TAPS = 8
INTERP_EXTEND = 4
REF_SCALE_SHIFT = 14
REF_NO_SCALE = 1 << REF_SCALE_SHIFT
REF_INVALID_SCALE = -1


class ScaleFactors:
    """vp9/common/vp9_scale.c parity."""

    def __init__(self, other_w, other_h, this_w, this_h):
        if other_w <= 0 or other_h <= 0 or this_w <= 0 or this_h <= 0 \
                or other_w * 2 < this_w or other_h * 2 < this_h \
                or other_w > 16 * this_w or other_h > 16 * this_h:
            self.x_scale_fp = REF_INVALID_SCALE
            self.y_scale_fp = REF_INVALID_SCALE
            self.x_step_q4 = 16
            self.y_step_q4 = 16
            return
        self.x_scale_fp = (other_w << REF_SCALE_SHIFT) // this_w
        self.y_scale_fp = (other_h << REF_SCALE_SHIFT) // this_h
        self.x_step_q4 = self.scaled_x(16)
        self.y_step_q4 = self.scaled_y(16)

    def is_valid(self):
        return self.x_scale_fp != REF_INVALID_SCALE

    def is_scaled(self):
        return (self.is_valid()
                and (self.x_scale_fp != REF_NO_SCALE
                     or self.y_scale_fp != REF_NO_SCALE))

    def scaled_x(self, val):
        return (val * self.x_scale_fp) >> REF_SCALE_SHIFT

    def scaled_y(self, val):
        return (val * self.y_scale_fp) >> REF_SCALE_SHIFT

    def scale_mv(self, mv_row, mv_col, x, y):
        """vp9_scale_mv: returns MV32 (row, col) in q4."""
        x_off_q4 = self.scaled_x(x << SUBPEL_BITS) & SUBPEL_MASK
        y_off_q4 = self.scaled_y(y << SUBPEL_BITS) & SUBPEL_MASK
        row = self.scaled_y(mv_row) + y_off_q4
        col = self.scaled_x(mv_col) + x_off_q4
        return row, col


def _round_q2(v):
    """(v < 0 ? v - 1 : v + 1) / 2 with C truncating division."""
    q = v + 1 if v >= 0 else v - 1
    return q // 2 if q >= 0 else -((-q) // 2)


def _round_q4(v):
    q = v + 2 if v >= 0 else v - 2
    return q // 4 if q >= 0 else -((-q) // 4)


def average_split_mv(bmi_mv, ref, block, ss_x, ss_y):
    """vp9_reconinter.c average_split_mvs (chroma MV for sub-8x8 blocks)."""
    ss_idx = ((1 if ss_x else 0) << 1) | (1 if ss_y else 0)
    if ss_idx == 0:
        return int(bmi_mv[block, ref, 0]), int(bmi_mv[block, ref, 1])
    if ss_idx == 1:  # ss_y only
        b0, b1 = block, block + 2
    elif ss_idx == 2:  # ss_x only
        b0, b1 = block, block + 1
    else:
        r = sum(int(bmi_mv[b, ref, 0]) for b in range(4))
        c = sum(int(bmi_mv[b, ref, 1]) for b in range(4))
        return _round_q4(r), _round_q4(c)
    r = int(bmi_mv[b0, ref, 0]) + int(bmi_mv[b1, ref, 0])
    c = int(bmi_mv[b0, ref, 1]) + int(bmi_mv[b1, ref, 1])
    return _round_q2(r), _round_q2(c)


def convolve_block(ref_plane: np.ndarray, crop_w: int, crop_h: int,
                   x0: int, y0: int, subpel_x: int, subpel_y: int,
                   xs: int, ys: int, w: int, h: int, kernel: np.ndarray,
                   bd: int, avg_into: np.ndarray | None) -> np.ndarray:
    """General scaled 2-stage 8-tap convolve with edge-clamped sampling.

    Equivalent to build_mc_border + vpx_(highbd_)convolve8(_avg): every
    reference sample coordinate is clamped into [0, crop-1] (the border
    copy in build_mc_border clamps identically, and in-frame windows are
    unaffected).  Returns the [h, w] prediction.
    """
    maxval = (1 << bd) - 1
    # horizontal pass over the intermediate rows
    inter_h = (((h - 1) * ys + subpel_y) >> SUBPEL_BITS) + SUBPEL_TAPS
    # sample rows are y0 - 3 .. y0 - 3 + inter_h - 1
    rows = np.clip(np.arange(y0 - 3, y0 - 3 + inter_h), 0, crop_h - 1)
    x_q4 = subpel_x + np.arange(w) * xs
    src_x = x0 + (x_q4 >> SUBPEL_BITS)          # per output column
    taps_x = np.clip(src_x[:, None] - 3 + np.arange(8)[None, :], 0,
                     crop_w - 1)                # [w, 8]
    fx = kernel[x_q4 & SUBPEL_MASK]             # [w, 8]
    # gather [inter_h, w, 8]
    g = ref_plane[rows[:, None, None], taps_x[None, :, :]].astype(np.int64)
    temp = np.clip((np.sum(g * fx[None], axis=2) + 64) >> FILTER_BITS,
                   0, maxval)
    # vertical pass
    y_q4 = subpel_y + np.arange(h) * ys
    src_y = (y_q4 >> SUBPEL_BITS)                # row index into temp (rel -3)
    taps_y = src_y[:, None] + np.arange(8)[None, :]  # offsets into temp
    fy = kernel[y_q4 & SUBPEL_MASK]              # [h, 8]
    gv = temp[taps_y]                            # [h, 8, w]
    out = np.clip((np.sum(gv * fy[:, :, None], axis=1) + 64) >> FILTER_BITS,
                  0, maxval)
    if avg_into is not None:
        out = (avg_into.astype(np.int64) + out + 1) >> 1
    return out
