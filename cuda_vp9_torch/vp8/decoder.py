"""VP8 decoder (RFC 6386): frame header, mode/MV parse, token decode,
intra + inter reconstruction, loop filter.  NumPy host oracle.

Behavior parity with the reference's vp8/decoder/{decodeframe.c,
decodemv.c,detokenize.c} and vp8/common/{reconintra.c,reconintra4x4.c,
reconinter.c,findnearmv.c,filter.c,idctllm.c,vp8_loopfilter.c,
setupintrarecon.c,extend.c}.  Keyframes and inter frames (last/golden/
altref references, NEAREST/NEAR/ZERO/NEW/SPLIT motion, six-tap and
bilinear sub-pel MC) are decoded bit-exactly; validated per-frame
against libavcodec's normative `vp8` decoder MD5s.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..decoder.bitreader import BoolDecoder
from . import recon as R
from . import tables_gen as T


class Vp8Error(ValueError):
    pass


# reference-frame indices (vp8/common/blockd.h MV_REFERENCE_FRAME)
INTRA, LAST, GOLDEN, ALTREF = 0, 1, 2, 3
B_PRED, NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV = 4, 5, 6, 7, 8, 9

# canvas borders (vpx_scale yv12config VP8BORDERINPIXELS = 32)
BY = 32
BC = 16


@dataclass
class Vp8Header:
    frame_type: int = 0
    version: int = 0
    show_frame: int = 1
    width: int = 0
    height: int = 0
    hscale: int = 0
    vscale: int = 0
    seg_enabled: int = 0
    seg_update_map: int = 0
    seg_abs_delta: int = 0
    seg_tree_probs: List[int] = field(default_factory=lambda: [255] * 3)
    seg_quant: List[int] = field(default_factory=lambda: [0] * 4)
    seg_lf: List[int] = field(default_factory=lambda: [0] * 4)
    filter_type: int = 0
    filter_level: int = 0
    sharpness: int = 0
    lf_delta_enabled: int = 0
    ref_lf_deltas: List[int] = field(default_factory=lambda: [0] * 4)
    mode_lf_deltas: List[int] = field(default_factory=lambda: [0] * 4)
    base_qindex: int = 0
    y1dc_delta: int = 0
    y2dc_delta: int = 0
    y2ac_delta: int = 0
    uvdc_delta: int = 0
    uvac_delta: int = 0
    mb_no_coeff_skip: int = 0
    prob_skip_false: int = 0
    refresh_golden: int = 1
    refresh_alt: int = 1
    copy_to_gf: int = 0
    copy_to_arf: int = 0
    refresh_last: int = 1
    refresh_entropy: int = 1
    prob_intra: int = 0
    prob_last: int = 0
    prob_gf: int = 0


def _clamp_q(qi):
    return max(0, min(127, qi))


def _dq16(coeffs, dq):
    """Dequantize with the reference's int16 truncation (dqcoeff is a
    short array: vp8/common/dequantize.c)."""
    v = coeffs.astype(np.int64) * dq
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _dequant_factors(hdr: Vp8Header, seg_id: int):
    """(y1dc, y1ac, y2dc, y2ac, uvdc, uvac) (vp8/common/quant_common.c +
    vp8_mb_init_dequantizer segment handling)."""
    q = hdr.base_qindex
    if hdr.seg_enabled:
        if hdr.seg_abs_delta:
            q = hdr.seg_quant[seg_id]
        else:
            q = q + hdr.seg_quant[seg_id]
        q = _clamp_q(q)
    y1dc = T.DC_QLOOKUP[_clamp_q(q + hdr.y1dc_delta)]
    y1ac = T.AC_QLOOKUP[_clamp_q(q)]
    y2dc = T.DC_QLOOKUP[_clamp_q(q + hdr.y2dc_delta)] * 2
    y2ac = T.AC_QLOOKUP[_clamp_q(q + hdr.y2ac_delta)] * 155 // 100
    if y2ac < 8:
        y2ac = 8
    uvdc = T.DC_QLOOKUP[_clamp_q(q + hdr.uvdc_delta)]
    if uvdc > 132:
        uvdc = 132
    uvac = T.AC_QLOOKUP[_clamp_q(q + hdr.uvac_delta)]
    return y1dc, y1ac, y2dc, y2ac, uvdc, uvac


def _read_tree(bc, tree, probs):
    i = 0
    while True:
        i = tree[i + bc.read(probs[i >> 1])]
        if i <= 0:
            return -i


_KBANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CAT_BASE = [5, 7, 11, 19, 35, 67]
_CAT_PROBS = [T.PCAT1, T.PCAT2, T.PCAT3, T.PCAT4, T.PCAT5, T.PCAT6]


def _get_coeffs(bc, probs, ctx, first, out):
    """vp8/decoder/detokenize.c GetCoeffs: returns the position of the
    last nonzero coeff plus one, and 0 if there are none (`first` is 1
    when the DC lives in the Y2 block).  probs: [8][3][11]."""
    n = first
    p = probs[_KBANDS[n]][ctx]
    if not bc.read(p[0]):
        return 0
    while True:
        n += 1
        if not bc.read(p[1]):
            p = probs[_KBANDS[n]][0]
        else:
            if not bc.read(p[2]):
                p_next = probs[_KBANDS[n]][1]
                v = 1
            else:
                if not bc.read(p[3]):
                    if not bc.read(p[4]):
                        v = 2
                    else:
                        v = 3 + bc.read(p[5])
                else:
                    if not bc.read(p[6]):
                        if not bc.read(p[7]):
                            v = 5 + bc.read(159)
                        else:
                            v = 7 + 2 * bc.read(165)
                            v += bc.read(145)
                    else:
                        # cat 0..3 here selects DCT_VAL_CATEGORY3..6
                        bit1 = bc.read(p[8])
                        bit0 = bc.read(p[9 + bit1])
                        cat = 2 * bit1 + bit0
                        v = 0
                        for pr in _CAT_PROBS[cat + 2]:
                            v += v + bc.read(pr)
                        v += 3 + (8 << cat)
                p_next = probs[_KBANDS[n]][2]
            j = T.ZIGZAG[n - 1]
            out[j] = -v if bc.read(128) else v
            p = p_next
            if n == 16 or not bc.read(p[0]):
                return n
        if n == 16:
            return 16


# ------------------------------------------------------------------ MVs

def _read_mvcomponent(bc, p):
    """vp8/decoder/decodemv.c read_mvcomponent; p is a flat 19-prob MV
    context (is_short, sign, 7 short-tree, 10 long bits)."""
    if bc.read(p[0]):                      # large
        x = 0
        for i in range(3):
            x += bc.read(p[9 + i]) << i
        for i in range(9, 3, -1):          # skip bit 3 (often implicit)
            x += bc.read(p[9 + i]) << i
        if not (x & 0xFFF0) or bc.read(p[9 + 3]):
            x += 8
    else:                                  # small: 3-deep tree over 0..7
        x = _read_tree(bc, T.SMALL_MVTREE, p[2:9])
    if x and bc.read(p[1]):
        x = -x
    return x


def _read_mv(bc, mvc):
    """(row, col) in 1/8th pel (components coded in 1/4 pel, doubled)."""
    r = _read_mvcomponent(bc, mvc[0]) * 2
    c = _read_mvcomponent(bc, mvc[1]) * 2
    return r, c


def _mv_bias(sign_bias_ref, sign_bias_this, mv):
    if sign_bias_ref != sign_bias_this:
        return (-mv[0], -mv[1])
    return mv


def _clamp_mv(mv, lo_c, hi_c, lo_r, hi_r):
    r = min(max(mv[0], lo_r), hi_r)
    c = min(max(mv[1], lo_c), hi_c)
    return (r, c)


def _trunc_div(a, b):
    """C integer division (truncate toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


# ------------------------------------------------------- sub-pel filters

def _filter_2d(region, fx, fy, h, w, taps):
    """Two-pass separable filter with the reference's intermediate
    clamping (vp8/common/filter.c filter_block2d_*_pass).  region is
    [h + nt - 1, w + nt - 1] int32 at (y - off, x - off)."""
    HF = taps[fx]
    VF = taps[fy]
    nt = len(HF)
    F = np.zeros((h + nt - 1, w), np.int32)
    for k in range(nt):
        if HF[k]:
            F += HF[k] * region[:, k:k + w]
    F = np.clip((F + 64) >> 7, 0, 255)
    out = np.zeros((h, w), np.int32)
    for k in range(nt):
        if VF[k]:
            out += VF[k] * F[k:k + h, :]
    return np.clip((out + 64) >> 7, 0, 255)


def _bilinear_2d(region, fx, fy, h, w):
    """vp8_bilinear_predict (no intermediate clamp needed: outputs of a
    128-sum 2-tap stay in range)."""
    HF = T.BILINEAR_FILTERS[fx]
    VF = T.BILINEAR_FILTERS[fy]
    F = (HF[0] * region[:, 0:w] + HF[1] * region[:, 1:w + 1] + 64) >> 7
    out = (VF[0] * F[0:h, :] + VF[1] * F[1:h + 1, :] + 64) >> 7
    return out


def _predict_inter(canvas, base_y, base_x, mv, h, w, sixtap):
    """Predict one h x w block from a bordered reference canvas.
    base_y/base_x are canvas coordinates of the block origin; mv is
    (row, col) in 1/8th pel."""
    y = base_y + (mv[0] >> 3)
    x = base_x + (mv[1] >> 3)
    fy, fx = mv[0] & 7, mv[1] & 7
    if fx == 0 and fy == 0:
        return canvas[y:y + h, x:x + w].astype(np.int32)
    if sixtap:
        region = canvas[y - 2:y + h + 3, x - 2:x + w + 3].astype(np.int32)
        return _filter_2d(region, fx, fy, h, w, T.SUBPEL_FILTERS)
    region = canvas[y:y + h + 1, x:x + w + 1].astype(np.int32)
    return _bilinear_2d(region, fx, fy, h, w)


class Vp8Decoder:
    """Stateful VP8 stream decoder: decode() one frame payload at a
    time; maintains the last/golden/altref reference frames, persistent
    entropy contexts, segmentation and loop-filter delta state
    (vp8/decoder/onyxd_if.c + decodeframe.c)."""

    def __init__(self, ec_enabled: bool = False):
        # --enable-error-concealment parity (vp8/decoder/onyxd_if.c:97:
        # ec_enabled from oxcf->error_concealment; active only once a
        # keyframe has been decoded)
        self.ec_enabled = bool(ec_enabled)
        self.frame_corrupt = False
        self._prev_mi = None
        self._reset_all()

    def _reset_all(self):
        self.W = self.H = 0
        self.mb_rows = self.mb_cols = 0
        self.refs = {LAST: None, GOLDEN: None, ALTREF: None}
        self.sign_bias = [0, 0, 0, 0]
        self.seg_map = None
        self.decoded_key_frame = False
        self.hdr = Vp8Header()
        self._default_entropy()

    def _default_entropy(self):
        self.coef_probs = [
            [[list(T.DEFAULT_COEF_PROBS[i][j][k]) for k in range(3)]
             for j in range(8)] for i in range(4)]
        self.ymode_prob = list(T.YMODE_PROB)
        self.uv_mode_prob = list(T.UV_MODE_PROB)
        self.mvc = [list(T.DEFAULT_MV_CONTEXT[0][0]),
                    list(T.DEFAULT_MV_CONTEXT[1][0])]

    # ------------------------------------------------------------ header

    def decode(self, data: bytes):
        if len(data) < 3:
            raise Vp8Error("truncated VP8 frame")
        hdr = self.hdr
        b0 = data[0] | (data[1] << 8) | (data[2] << 16)
        hdr.frame_type = b0 & 1
        hdr.version = (b0 >> 1) & 7
        hdr.show_frame = (b0 >> 4) & 1
        first_part_size = b0 >> 5
        pos = 3

        if hdr.frame_type == 0:  # keyframe
            if len(data) < 10:
                raise Vp8Error("truncated VP8 keyframe header")
            if data[3:6] != b"\x9d\x01\x2a":
                raise Vp8Error("bad VP8 keyframe start code")
            w = data[6] | (data[7] << 8)
            h = data[8] | (data[9] << 8)
            width, hscale = w & 0x3FFF, w >> 14
            height, vscale = h & 0x3FFF, h >> 14
            if width == 0 or height == 0:
                raise Vp8Error("bad frame size")
            if (width, height) != (self.W, self.H):
                self._reset_all()
                hdr = self.hdr
                hdr.frame_type = 0
                hdr.version = (b0 >> 1) & 7
                hdr.show_frame = (b0 >> 4) & 1
                self.W, self.H = width, height
                self.mb_cols = (width + 15) >> 4
                self.mb_rows = (height + 15) >> 4
                self.seg_map = np.zeros((self.mb_rows, self.mb_cols),
                                        np.int32)
            hdr.width, hdr.hscale = width, hscale
            hdr.height, hdr.vscale = height, vscale
            pos = 10
            # init_frame keyframe resets (decodeframe.c:822-848)
            self._default_entropy()
            hdr.seg_quant = [0] * 4
            hdr.seg_lf = [0] * 4
            hdr.seg_abs_delta = 0
            hdr.ref_lf_deltas = [0] * 4
            hdr.mode_lf_deltas = [0] * 4
            hdr.refresh_golden = hdr.refresh_alt = 1
            hdr.copy_to_gf = hdr.copy_to_arf = 0
            self.sign_bias[GOLDEN] = self.sign_bias[ALTREF] = 0
        elif not self.decoded_key_frame:
            raise Vp8Error("stream must start with a keyframe")

        # vp8_error-concealment activation (decodeframe.c:863)
        ec_active = self.ec_enabled and self.decoded_key_frame
        self.frame_corrupt = False

        if pos + first_part_size > len(data):
            # decodeframe.c:927: only a hard error without EC; with EC
            # the bool decoder zero-fills past the real data
            if not ec_active:
                raise Vp8Error("first partition overruns frame")
            self.frame_corrupt = True
            first_part_size = len(data) - pos
        bc = BoolDecoder(data, pos, first_part_size, marker=False)

        if hdr.frame_type == 0:
            bc.read_bit()                  # colorspace
            bc.read_bit()                  # clamping type
        self._parse_segmentation(bc, hdr)
        hdr.filter_type = bc.read_bit()
        hdr.filter_level = bc.read_literal(6)
        hdr.sharpness = bc.read_literal(3)
        hdr.lf_delta_enabled = bc.read_bit()
        if hdr.lf_delta_enabled and bc.read_bit():
            for i in range(4):
                if bc.read_bit():
                    v = bc.read_literal(6)
                    hdr.ref_lf_deltas[i] = -v if bc.read_bit() else v
            for i in range(4):
                if bc.read_bit():
                    v = bc.read_literal(6)
                    hdr.mode_lf_deltas[i] = -v if bc.read_bit() else v

        # token partitions (count read from bc; sizes follow the first
        # partition in the byte stream)
        n_parts = 1 << bc.read_literal(2)
        part_base = pos + first_part_size
        sizes_len = 3 * (n_parts - 1)
        if part_base + sizes_len > len(data):
            if not ec_active:
                raise Vp8Error("partition size table overruns frame")
            # setup_token_decoder EC path: clamp and conceal
            self.frame_corrupt = True
            sizes_len = max(0, len(data) - part_base)
        parts = []
        off = part_base + sizes_len
        for i in range(n_parts):
            if i < n_parts - 1:
                o = part_base + 3 * i
                if o + 3 <= len(data):
                    sz = data[o] | (data[o + 1] << 8) | (data[o + 2] << 16)
                else:
                    sz = 0
            else:
                sz = len(data) - off
            if off + sz > len(data) or sz < 0:
                if not ec_active:
                    raise Vp8Error("token partition overruns frame")
                self.frame_corrupt = True
                sz = max(0, len(data) - off)
            parts.append(BoolDecoder(data, min(off, len(data)), sz,
                                     marker=False))
            off += sz

        hdr.base_qindex = bc.read_literal(7)
        hdr.y1dc_delta = self._delta_q(bc, hdr.y1dc_delta)
        hdr.y2dc_delta = self._delta_q(bc, hdr.y2dc_delta)
        hdr.y2ac_delta = self._delta_q(bc, hdr.y2ac_delta)
        hdr.uvdc_delta = self._delta_q(bc, hdr.uvdc_delta)
        hdr.uvac_delta = self._delta_q(bc, hdr.uvac_delta)

        if hdr.frame_type != 0:
            hdr.refresh_golden = bc.read_bit()
            hdr.refresh_alt = bc.read_bit()
            hdr.copy_to_gf = 0 if hdr.refresh_golden else bc.read_literal(2)
            hdr.copy_to_arf = 0 if hdr.refresh_alt else bc.read_literal(2)
            self.sign_bias[GOLDEN] = bc.read_bit()
            self.sign_bias[ALTREF] = bc.read_bit()

        hdr.refresh_entropy = bc.read_bit()
        saved_entropy = None
        if hdr.refresh_entropy == 0 or ec_active:
            saved_entropy = (copy.deepcopy(self.coef_probs),
                             list(self.ymode_prob), list(self.uv_mode_prob),
                             copy.deepcopy(self.mvc))
        hdr.refresh_last = 1 if hdr.frame_type == 0 else bc.read_bit()

        # coef prob updates (persistent across frames; reset on keyframe)
        probs = self.coef_probs
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    up = T.COEF_UPDATE_PROBS[i][j][k]
                    for l in range(11):
                        if bc.read(up[l]):
                            probs[i][j][k][l] = bc.read_literal(8)

        hdr.mb_no_coeff_skip = bc.read_bit()
        hdr.prob_skip_false = (bc.read_literal(8)
                               if hdr.mb_no_coeff_skip else 0)
        if hdr.frame_type != 0:
            hdr.prob_intra = bc.read_literal(8)
            hdr.prob_last = bc.read_literal(8)
            hdr.prob_gf = bc.read_literal(8)
            if bc.read_bit():
                self.ymode_prob = [bc.read_literal(8) for _ in range(4)]
            if bc.read_bit():
                self.uv_mode_prob = [bc.read_literal(8) for _ in range(3)]
            # MV context updates (read_mvcontexts)
            for comp in range(2):
                up = T.MV_UPDATE_PROBS[comp][0]
                p = self.mvc[comp]
                for i in range(19):
                    if bc.read(up[i]):
                        x = bc.read_literal(7)
                        p[i] = (x << 1) if x else 1

        self._ec_active = ec_active
        result = self._decode_frame_body(data, hdr, bc, parts)

        if hdr.refresh_entropy == 0 or (ec_active and self.frame_corrupt):
            # decodeframe.c:1156: a corrupt frame never refreshes the
            # persistent entropy contexts
            (self.coef_probs, self.ymode_prob, self.uv_mode_prob,
             self.mvc) = saved_entropy
        if hdr.frame_type == 0:
            self.decoded_key_frame = True
        return result

    @staticmethod
    def _delta_q(bc, prev):
        """decodeframe.c get_delta_q: deltas are re-coded every frame
        (absent bit means zero, not "keep previous")."""
        del prev
        if bc.read_bit():
            v = bc.read_literal(4)
            return -v if bc.read_bit() else v
        return 0

    def _parse_segmentation(self, bc, hdr):
        hdr.seg_enabled = bc.read_bit()
        if not hdr.seg_enabled:
            hdr.seg_update_map = 0
            return
        hdr.seg_update_map = bc.read_bit()
        update_data = bc.read_bit()
        if update_data:
            hdr.seg_abs_delta = bc.read_bit()
            hdr.seg_quant = [0] * 4
            hdr.seg_lf = [0] * 4
            for i in range(4):
                if bc.read_bit():
                    v = bc.read_literal(7)
                    hdr.seg_quant[i] = -v if bc.read_bit() else v
            for i in range(4):
                if bc.read_bit():
                    v = bc.read_literal(6)
                    hdr.seg_lf[i] = -v if bc.read_bit() else v
        if hdr.seg_update_map:
            for i in range(3):
                hdr.seg_tree_probs[i] = (bc.read_literal(8)
                                         if bc.read_bit() else 255)

    # ------------------------------------------------------ mode/MV pass

    def _read_kf_modes(self, bc, r, c, bmodes, uvmodes, above_sub,
                       left_sub, mode):
        ym = _read_tree(bc, T.KF_YMODE_TREE, T.KF_YMODE_PROB)
        mode[r + 1, c + 1] = ym
        bm = bmodes[r, c].reshape(4, 4)
        if ym == B_PRED:
            for i in range(16):
                br, bcol = i >> 2, i & 3
                A = bm[br - 1, bcol] if br > 0 else above_sub[c, bcol]
                L = bm[br, bcol - 1] if bcol > 0 else left_sub[br]
                bm[br, bcol] = _read_tree(bc, T.BMODE_TREE,
                                          T.KF_BMODE_PROB[A][L])
        else:
            # above/left_block_mode map whole-MB DC/V/H/TM -> B_* ctx
            bm[:, :] = {0: 0, 1: 2, 2: 3, 3: 1}[ym]
        uvmodes[r, c] = _read_tree(bc, T.UV_MODE_TREE, T.KF_UV_MODE_PROB)
        above_sub[c] = bm[3]
        left_sub[:] = bm[:, 3]

    def _read_mb_modes_mv(self, hdr, bc, r, c, ref_frame, mode, mvs,
                          bmvs, bmodes, uvmodes, part, clamp):
        """decodemv.c read_mb_modes_mv (inter-frame MB)."""
        br_, bc_ = r + 1, c + 1
        if not bc.read(hdr.prob_intra):
            # intra MB on an inter frame: context-free trees with the
            # frame-persistent ymode/uv_mode probs
            ref_frame[br_, bc_] = INTRA
            mvs[br_, bc_] = 0
            ym = _read_tree(bc, T.YMODE_TREE, self.ymode_prob)
            mode[br_, bc_] = ym
            if ym == B_PRED:
                bm = bmodes[r, c]
                for i in range(16):
                    bm[i] = _read_tree(bc, T.BMODE_TREE, T.BMODE_PROB)
            uvmodes[r, c] = _read_tree(bc, T.UV_MODE_TREE,
                                       self.uv_mode_prob)
            return

        ref = LAST
        if bc.read(hdr.prob_last):
            ref = 2 + bc.read(hdr.prob_gf)
        ref_frame[br_, bc_] = ref
        sb = self.sign_bias

        # near-MV scan over above / left / aboveleft (find_near_mvs
        # inlined in read_mb_modes_mv)
        near = [(0, 0), (0, 0), (0, 0), (0, 0)]
        cnt = [0, 0, 0, 0]
        nmv_i = 0   # index of the last filled near MV
        cnt_i = 0   # "cntx" pointer
        a_ref = ref_frame[br_ - 1, bc_]
        a_mv = (int(mvs[br_ - 1, bc_, 0]), int(mvs[br_ - 1, bc_, 1]))
        a_mode = mode[br_ - 1, bc_]
        l_ref = ref_frame[br_, bc_ - 1]
        l_mv = (int(mvs[br_, bc_ - 1, 0]), int(mvs[br_, bc_ - 1, 1]))
        l_mode = mode[br_, bc_ - 1]
        al_ref = ref_frame[br_ - 1, bc_ - 1]
        al_mv = (int(mvs[br_ - 1, bc_ - 1, 0]),
                 int(mvs[br_ - 1, bc_ - 1, 1]))
        al_mode = mode[br_ - 1, bc_ - 1]

        if a_ref != INTRA:
            if a_mv != (0, 0):
                nmv_i += 1
                near[nmv_i] = _mv_bias(sb[a_ref], sb[ref], a_mv)
                cnt_i = nmv_i
            cnt[cnt_i] += 2
        if l_ref != INTRA:
            if l_mv != (0, 0):
                this = _mv_bias(sb[l_ref], sb[ref], l_mv)
                if this != near[nmv_i]:
                    nmv_i += 1
                    near[nmv_i] = this
                    cnt_i = nmv_i
                cnt[cnt_i] += 2
            else:
                cnt[0] += 2
        if al_ref != INTRA:
            if al_mv != (0, 0):
                this = _mv_bias(sb[al_ref], sb[ref], al_mv)
                if this != near[nmv_i]:
                    nmv_i += 1
                    near[nmv_i] = this
                    cnt_i = nmv_i
                cnt[cnt_i] += 1
            else:
                cnt[0] += 1

        mb_to_top = -((r * 16) << 3)
        mb_to_bottom = ((self.mb_rows - 1 - r) * 16) << 3
        mb_to_left = -((c * 16) << 3)
        mb_to_right = ((self.mb_cols - 1 - c) * 16) << 3
        M = 16 << 3  # LEFT_TOP_MARGIN / RIGHT_BOTTOM_MARGIN

        if bc.read(T.MODE_CONTEXTS[cnt[0]][0]):
            # merge above-left into NEAREST if it matches
            cnt[1] += (1 if (cnt[3] > 0 and near[nmv_i] == near[1])
                       else 0)
            if cnt[2] > cnt[1]:
                cnt[1], cnt[2] = cnt[2], cnt[1]
                near[1], near[2] = near[2], near[1]
            if bc.read(T.MODE_CONTEXTS[cnt[1]][1]):
                if bc.read(T.MODE_CONTEXTS[cnt[2]][2]):
                    # NEWMV or SPLITMV; best_mv = clamped near entry
                    near_index = 0 + (1 if cnt[1] >= cnt[0] else 0)
                    best = _clamp_mv(near[near_index],
                                     mb_to_left - M, mb_to_right + M,
                                     mb_to_top - M, mb_to_bottom + M)
                    # NOTE: explicit int() — a_mode/l_mode are numpy
                    # scalars and np.bool_ + np.bool_ saturates to True
                    # under NumPy 2, which would collapse context 4 to 2.
                    cnt[3] = ((int(a_mode == SPLITMV)
                               + int(l_mode == SPLITMV)) * 2
                              + int(al_mode == SPLITMV))
                    if bc.read(T.MODE_CONTEXTS[cnt[3]][3]):
                        nc = self._decode_split_mv(
                            bc, r, c, mode, bmvs, best,
                            mb_to_left - M, mb_to_right + M,
                            mb_to_top - M, mb_to_bottom + M, part)
                        mvs[br_, bc_] = bmvs[r, c, 15]
                        mode[br_, bc_] = SPLITMV
                        clamp[r, c] = nc
                    else:
                        dr, dc = _read_mv(bc, self.mvc)
                        mv = (best[0] + dr, best[1] + dc)
                        mvs[br_, bc_] = mv
                        mode[br_, bc_] = NEWMV
                        clamp[r, c] = not (
                            mb_to_left - M <= mv[1] <= mb_to_right + M
                            and mb_to_top - M <= mv[0]
                            <= mb_to_bottom + M)
                else:
                    mode[br_, bc_] = NEARMV
                    mvs[br_, bc_] = _clamp_mv(
                        near[2], mb_to_left - M, mb_to_right + M,
                        mb_to_top - M, mb_to_bottom + M)
            else:
                mode[br_, bc_] = NEARESTMV
                mvs[br_, bc_] = _clamp_mv(
                    near[1], mb_to_left - M, mb_to_right + M,
                    mb_to_top - M, mb_to_bottom + M)
        else:
            mode[br_, bc_] = ZEROMV
            mvs[br_, bc_] = 0

    def _decode_split_mv(self, bc, r, c, mode, bmvs, best, lo_c, hi_c,
                         lo_r, hi_r, part):
        """decodemv.c decode_split_mv.  Returns need_to_clamp."""
        s = 3
        num_p = 16
        if bc.read(110):
            s = 2
            num_p = 4
            if bc.read(111):
                s = bc.read(150)
                num_p = 2
        part[r, c] = s
        mb = bmvs[r, c]
        need_clamp = False
        l_split = mode[r + 1, c] == SPLITMV
        a_split = mode[r, c + 1] == SPLITMV
        for j in range(num_p):
            k = T.MBSPLIT_OFFSET[s][j]
            if not (k & 3):      # on MB left edge
                if l_split:
                    leftmv = tuple(bmvs[r, c - 1, k + 3])
                else:
                    # left MB's mbmi.mv lives in the bordered array
                    from_mv = self._mvs_tmp[r + 1, c]
                    leftmv = (int(from_mv[0]), int(from_mv[1]))
            else:
                leftmv = tuple(mb[k - 1])
            if not (k >> 2):     # on MB top edge
                if a_split:
                    abovemv = tuple(bmvs[r - 1, c, k + 12])
                else:
                    from_mv = self._mvs_tmp[r, c + 1]
                    abovemv = (int(from_mv[0]), int(from_mv[1]))
            else:
                abovemv = tuple(mb[k - 4])

            lez = int(leftmv == (0, 0))
            aez = int(abovemv == (0, 0))
            lea = int(leftmv == abovemv)
            prob = T.SUB_MV_REF_PROB3[(aez << 2) | (lez << 1) | lea]

            if bc.read(prob[0]):
                if bc.read(prob[1]):
                    blockmv = (0, 0)
                    if bc.read(prob[2]):
                        dr = _read_mvcomponent(bc, self.mvc[0]) * 2
                        dc = _read_mvcomponent(bc, self.mvc[1]) * 2
                        blockmv = (best[0] + dr, best[1] + dc)
                else:
                    blockmv = abovemv
            else:
                blockmv = leftmv

            need_clamp |= not (lo_c <= blockmv[1] <= hi_c
                               and lo_r <= blockmv[0] <= hi_r)
            fc = T.MBSPLIT_FILL_COUNT[s]
            for off in T.MBSPLIT_FILL_OFFSET[s][j * fc:j * fc + fc]:
                mb[off] = blockmv
        return need_clamp

    # ------------------------------------------------------- frame body

    def _decode_frame_body(self, data, hdr, bc, parts):
        mr, mc = self.mb_rows, self.mb_cols
        W16, H16 = mc * 16, mr * 16
        sixtap = not (hdr.version >= 1)
        full_pixel = hdr.version == 3
        fp_mask = ~7 if full_pixel else ~0

        # fresh canvases with reference borders; intra edge init
        # (setup_intra_recon_top_line + setup_intra_recon_left)
        Y = np.zeros((BY + H16 + BY, BY + W16 + BY), np.uint8)
        U = np.zeros((BC + H16 // 2 + BC, BC + W16 // 2 + BC), np.uint8)
        V = np.zeros_like(U)
        Y[BY - 1, BY - 1:BY + W16 + 5] = 127
        U[BC - 1, BC - 1:BC + W16 // 2 + 5] = 127
        V[BC - 1, BC - 1:BC + W16 // 2 + 5] = 127
        Y[BY:BY + H16, BY - 1] = 129
        U[BC:BC + H16 // 2, BC - 1] = 129
        V[BC:BC + H16 // 2, BC - 1] = 129

        if hdr.frame_type != 0:
            for ref in (LAST, GOLDEN, ALTREF):
                if self.refs[ref] is None:
                    raise Vp8Error("missing reference frame")

        self._mvs_tmp = None
        mi = self._parse_modes_mvs_entry(hdr, bc)
        ec = getattr(self, "_ec_active", False)
        if ec and self._mvs_corrupt_from is not None:
            # mode/MV partition lost from some MB on: estimate the tail
            # of the MV field from the previous frame's projected MVs
            # (vp8_estimate_missing_mvs, onyxd_if.c:353)
            from .concealment import estimate_missing_mvs
            estimate_missing_mvs(mi, self._prev_mi, mr, mc,
                                 self._mvs_corrupt_from)
            self.frame_corrupt = True
        # per-MB reference-frame ids for loop-filter ref deltas
        self._lf_refs = mi["ref_frame"][1:mr + 1, 1:mc + 1]

        probs = self.coef_probs
        mb_mode = np.zeros((mr, mc), np.int32)
        mb_skip_lf = np.zeros((mr, mc), bool)
        mb_skip = np.zeros((mr, mc), bool)  # mb_skip_coeff (postproc)
        above_ctx = np.zeros((mc, 9), np.int32)
        for r in range(mr):
            part = parts[r % len(parts)]
            left_ctx = np.zeros(9, np.int32)
            for c in range(mc):
                ym = int(mi["mode"][r + 1, c + 1])
                is_intra = mi["ref_frame"][r + 1, c + 1] == INTRA
                skip = bool(mi["skips"][r, c])
                has_y2 = ym != B_PRED and ym != SPLITMV
                coeffs = np.zeros((25, 16), np.int32)
                eobs = np.zeros(25, np.int32)
                a = above_ctx[c]
                l = left_ctx
                if skip:
                    # vp8_reset_mb_tokens_context
                    a[:8] = 0
                    l[:8] = 0
                    if has_y2:
                        a[8] = l[8] = 0
                else:
                    eobtotal = 0
                    first = 0
                    if has_y2:
                        ctx = int(a[8] + l[8])
                        nz = _get_coeffs(part, probs[1], ctx, 0,
                                         coeffs[24])
                        a[8] = l[8] = int(nz > 0)
                        eobs[24] = nz
                        eobtotal += nz - 16
                        ptype = 0
                        first = 1
                    else:
                        ptype = 3
                    for i in range(16):
                        ai = i & 3
                        li = (i & 0xC) >> 2
                        ctx = int(a[ai] + l[li])
                        nz = _get_coeffs(part, probs[ptype], ctx, first,
                                         coeffs[i])
                        a[ai] = l[li] = int(nz > 0)
                        nz += first
                        eobs[i] = nz
                        eobtotal += nz
                    for i in range(16, 24):
                        ai = 4 + (((i > 19) << 1) + (i & 1))
                        li = 4 + (((i > 19) << 1) + int((i & 3) > 1))
                        ctx = int(a[ai] + l[li])
                        nz = _get_coeffs(part, probs[2], ctx, 0,
                                         coeffs[i])
                        a[ai] = l[li] = int(nz > 0)
                        eobs[i] = nz
                        eobtotal += nz
                    if eobtotal == 0:
                        # decode_macroblock: force the loop filter (and
                        # residual application) to skip
                        skip = True
                if ec and part.has_error():
                    # corrupt residual data: conceal (decodeframe.c:539).
                    # Inter MBs keep their parsed MVs with zero residual;
                    # intra MBs can't be predicted from corrupt neighbor
                    # pixels, so their motion is interpolated from the
                    # surrounding blocks (vp8_interpolate_motion)
                    self.frame_corrupt = True
                    coeffs[:] = 0
                    eobs[:] = 0
                    skip = True
                    if is_intra:
                        from .concealment import interpolate_motion
                        interpolate_motion(mi, r, c, mr, mc)
                        ym = SPLITMV
                        is_intra = False
                        has_y2 = False
                    a[:8] = 0
                    l[:8] = 0
                    if has_y2:
                        a[8] = l[8] = 0
                mb_mode[r, c] = ym
                mb_skip_lf[r, c] = has_y2 and skip
                mb_skip[r, c] = skip
                seg = int(self.seg_map[r, c])
                if is_intra:
                    self._recon_intra_mb(Y, U, V, hdr, r, c, ym,
                                         mi["bmodes"][r, c].reshape(4, 4),
                                         int(mi["uvmodes"][r, c]), seg,
                                         skip, coeffs, eobs, W16)
                else:
                    self._recon_inter_mb(Y, U, V, hdr, mi, r, c, ym, seg,
                                         skip, coeffs, eobs, sixtap,
                                         fp_mask)
            # extend right border for this MB row (vp8_extend_mb_row)
            y0, y1 = BY + r * 16, BY + (r + 1) * 16
            Y[y0:y1, BY + W16:] = Y[y0:y1, BY + W16 - 1:BY + W16]
            c0, c1 = BC + r * 8, BC + (r + 1) * 8
            U[c0:c1, BC + W16 // 2:] = U[c0:c1,
                                         BC + W16 // 2 - 1:BC + W16 // 2]
            V[c0:c1, BC + W16 // 2:] = V[c0:c1,
                                         BC + W16 // 2 - 1:BC + W16 // 2]

        if not ec and (bc.has_error()
                       or any(p.has_error() for p in parts)):
            # decodeframe.c:1206: bool-decoder overrun detected at frame
            # end is a hard error without error concealment
            raise Vp8Error("corrupt frame data (bool decoder overrun)")

        self._loop_filter(Y, U, V, hdr, mb_mode, mb_skip_lf, W16, H16)
        self._extend_borders(Y, U, V, W16, H16)
        if ec and self.frame_corrupt:
            # decodeframe.c:1112-1167: a concealed frame must never
            # update golden/altref and always refreshes LAST
            hdr.refresh_golden = 0
            hdr.refresh_alt = 0
            hdr.copy_to_gf = 0
            hdr.copy_to_arf = 0
            hdr.refresh_last = 1
        self._update_refs(hdr, (Y, U, V))
        if self.ec_enabled:
            # previous-frame MV field for estimate_missing_mvs
            mask = mi["mode"][1:mr + 1, 1:mc + 1] == SPLITMV
            bmv_all = np.where(mask[:, :, None, None], mi["bmvs"],
                               mi["mvs"][1:mr + 1, 1:mc + 1][:, :, None, :])
            self._prev_mi = {
                "bmv": bmv_all.astype(np.int64),
                "ref": mi["ref_frame"][1:mr + 1, 1:mc + 1].copy()}

        # postproc inputs: mb-aligned views (borders replicate edges)
        # + the final per-MB skip flags (vp8_post_proc_frame reads
        # mbmi.mb_skip_coeff; filters must not modify these buffers —
        # they are shared with the reference pool)
        self.pp_planes = (Y[BY:BY + H16, BY:BY + W16],
                          U[BC:BC + H16 // 2, BC:BC + W16 // 2],
                          V[BC:BC + H16 // 2, BC:BC + W16 // 2])
        self.pp_skip = mb_skip
        self.pp_filter_level = hdr.filter_level
        # MFQE inputs (vp8_multiframe_quality_enhance reads per-MB
        # mode / mv / sub-MVs alongside mb_skip_coeff)
        self.pp_mode = mi["mode"][1:mr + 1, 1:mc + 1].copy()
        self.pp_mvs = mi["mvs"][1:mr + 1, 1:mc + 1].copy()
        self.pp_bmvs = mi["bmvs"]
        self.pp_base_qindex = hdr.base_qindex
        self.pp_frame_type = hdr.frame_type

        y = Y[BY:BY + hdr.height, BY:BY + hdr.width].copy()
        u = U[BC:BC + (hdr.height + 1) // 2,
              BC:BC + (hdr.width + 1) // 2].copy()
        v = V[BC:BC + (hdr.height + 1) // 2,
              BC:BC + (hdr.width + 1) // 2].copy()
        return copy.deepcopy(hdr), (y, u, v)

    def _parse_modes_mvs_entry(self, hdr, bc):
        """Run the mode/MV pass with the bordered mvs array exposed for
        split-MV neighbor reads."""
        mr, mc = self.mb_rows, self.mb_cols
        mi = None

        # _parse_modes_mvs needs self._mvs_tmp set *during* the loop for
        # split-MV left/above lookups; restructure: allocate here.
        ref_frame = np.zeros((mr + 1, mc + 2), np.int32)
        mode = np.zeros((mr + 1, mc + 2), np.int32)
        mvs = np.zeros((mr + 1, mc + 2, 2), np.int32)
        bmvs = np.zeros((mr, mc, 16, 2), np.int32)
        bmodes = np.zeros((mr, mc, 16), np.int32)
        uvmodes = np.zeros((mr, mc), np.int32)
        skips = np.zeros((mr, mc), bool)
        part = np.zeros((mr, mc), np.int32)
        clamp = np.zeros((mr, mc), bool)
        above_sub = np.zeros((mc, 4), np.int32)
        self._mvs_tmp = mvs

        is_kf = hdr.frame_type == 0
        # EC: raster index of the first MB whose mode info came (even
        # partially) from past the end of partition 0
        # (pbi->mvs_corrupt_from_mb)
        self._mvs_corrupt_from = None
        ec = getattr(self, "_ec_active", False)
        for r in range(mr):
            left_sub = np.zeros(4, np.int32)
            for c in range(mc):
                if hdr.seg_enabled and hdr.seg_update_map:
                    p = hdr.seg_tree_probs
                    if bc.read(p[0]):
                        self.seg_map[r, c] = 2 + bc.read(p[2])
                    else:
                        self.seg_map[r, c] = bc.read(p[1])
                elif is_kf:
                    self.seg_map[r, c] = 0
                if hdr.mb_no_coeff_skip:
                    skips[r, c] = bc.read(hdr.prob_skip_false)
                if is_kf:
                    self._read_kf_modes(bc, r, c, bmodes, uvmodes,
                                        above_sub, left_sub, mode)
                else:
                    self._read_mb_modes_mv(
                        hdr, bc, r, c, ref_frame, mode, mvs, bmvs,
                        bmodes, uvmodes, part, clamp)
                if ec and self._mvs_corrupt_from is None \
                        and bc.has_error():
                    self._mvs_corrupt_from = r * mc + c
        return dict(ref_frame=ref_frame, mode=mode, mvs=mvs, bmvs=bmvs,
                    bmodes=bmodes, uvmodes=uvmodes, skips=skips,
                    part=part, clamp=clamp)

    # ------------------------------------------------------------- intra

    def _recon_intra_mb(self, Y, U, V, hdr, r, c, ym, bmode, uvm, seg,
                        skip, coeffs, eobs, W16):
        y1dc, y1ac, y2dc, y2ac, uvdc, uvac = _dequant_factors(hdr, seg)
        y0, x0 = BY + r * 16, BY + c * 16
        up = r > 0
        left = c > 0

        # chroma prediction
        cy, cx = BC + r * 8, BC + c * 8
        for P in (U, V):
            above = P[cy - 1, cx:cx + 8]
            lcol = P[cy:cy + 8, cx - 1]
            tl = P[cy - 1, cx - 1]
            P[cy:cy + 8, cx:cx + 8] = R.mb_pred(uvm, above, lcol, tl,
                                                8, up, left)

        if ym == B_PRED:
            if skip:
                eobs = np.zeros(25, np.int32)
            # intra_prediction_down_copy: replicate above-right 4 pixels
            # into rows +4/+8/+12 at x+16
            ar = Y[y0 - 1, x0 + 16:x0 + 20]
            for dy in (4, 8, 12):
                Y[y0 - 1 + dy, x0 + 16:x0 + 20] = ar
            dq = np.array([y1dc] + [y1ac] * 15, np.int64)
            for i in range(16):
                br, bcol = i >> 2, i & 3
                by, bx = y0 + br * 4, x0 + bcol * 4
                above8 = Y[by - 1, bx:bx + 8]
                tl = Y[by - 1, bx - 1]
                lcol = Y[by:by + 4, bx - 1]
                pred = R.b_pred_4x4(int(bmode[br, bcol]), above8, tl, lcol)
                Y[by:by + 4, bx:bx + 4] = pred
                if eobs[i] > 1:
                    resid = R.idct4x4(_dq16(coeffs[i], dq))
                    blk = Y[by:by + 4, bx:bx + 4].astype(np.int32) + resid
                    Y[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)
                elif eobs[i] == 1:
                    dc = (R._s16(int(coeffs[i][0]) * y1dc) + 4) >> 3
                    blk = Y[by:by + 4, bx:bx + 4].astype(np.int32) + dc
                    Y[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)
        else:
            above = Y[y0 - 1, x0:x0 + 16]
            lcol = Y[y0:y0 + 16, x0 - 1]
            tl = Y[y0 - 1, x0 - 1]
            Y[y0:y0 + 16, x0:x0 + 16] = R.mb_pred(ym, above, lcol, tl,
                                                  16, up, left)
            if not skip:
                self._add_y_residual_y2(Y, y0, x0, coeffs, eobs,
                                        y1dc, y1ac, y2dc, y2ac)

        if not skip:
            self._add_uv_residual(U, V, r, c, coeffs, eobs, uvdc, uvac)

    # ------------------------------------------------------------- inter

    def _recon_inter_mb(self, Y, U, V, hdr, mi, r, c, ym, seg, skip,
                        coeffs, eobs, sixtap, fp_mask):
        y1dc, y1ac, y2dc, y2ac, uvdc, uvac = _dequant_factors(hdr, seg)
        ref = int(mi["ref_frame"][r + 1, c + 1])
        refY, refU, refV = self.refs[ref]
        y0, x0 = BY + r * 16, BY + c * 16
        cy, cx = BC + r * 8, BC + c * 8
        need_clamp = bool(mi["clamp"][r, c])
        mb_to_top = -((r * 16) << 3)
        mb_to_bottom = ((self.mb_rows - 1 - r) * 16) << 3
        mb_to_left = -((c * 16) << 3)
        mb_to_right = ((self.mb_cols - 1 - c) * 16) << 3

        def clamp_y(mv):
            """reconinter.c clamp_mv_to_umv_border."""
            row, col = mv
            if col < mb_to_left - (19 << 3):
                col = mb_to_left - (16 << 3)
            elif col > mb_to_right + (18 << 3):
                col = mb_to_right + (16 << 3)
            if row < mb_to_top - (19 << 3):
                row = mb_to_top - (16 << 3)
            elif row > mb_to_bottom + (18 << 3):
                row = mb_to_bottom + (16 << 3)
            return (row, col)

        if ym != SPLITMV:
            mv = (int(mi["mvs"][r + 1, c + 1, 0]),
                  int(mi["mvs"][r + 1, c + 1, 1]))
            if need_clamp:
                mv = clamp_y(mv)
            Y[y0:y0 + 16, x0:x0 + 16] = _predict_inter(
                refY, y0, x0, mv, 16, 16, sixtap)
            # chroma MV: rounded halving, full-pel masked
            uvr = _trunc_div(mv[0] + (1 if mv[0] >= 0 else -1), 2)
            uvc = _trunc_div(mv[1] + (1 if mv[1] >= 0 else -1), 2)
            uvr &= fp_mask
            uvc &= fp_mask
            if not (2 * uvc < mb_to_left - (19 << 3)
                    or 2 * uvc > mb_to_right + (18 << 3)
                    or 2 * uvr < mb_to_top - (19 << 3)
                    or 2 * uvr > mb_to_bottom + (18 << 3)):
                U[cy:cy + 8, cx:cx + 8] = _predict_inter(
                    refU, cy, cx, (uvr, uvc), 8, 8, sixtap)
                V[cy:cy + 8, cx:cx + 8] = _predict_inter(
                    refV, cy, cx, (uvr, uvc), 8, 8, sixtap)
        else:
            bmv = mi["bmvs"][r, c]
            partition = int(mi["part"][r, c])
            if partition < 3:
                # 4 8x8 luma quadrants from bmi 0, 2, 8, 10
                for (bi, dy, dx) in ((0, 0, 0), (2, 0, 8),
                                     (8, 8, 0), (10, 8, 8)):
                    mv = (int(bmv[bi, 0]), int(bmv[bi, 1]))
                    if need_clamp:
                        mv = clamp_y(mv)
                    Y[y0 + dy:y0 + dy + 8, x0 + dx:x0 + dx + 8] = \
                        _predict_inter(refY, y0 + dy, x0 + dx, mv, 8, 8,
                                       sixtap)
            else:
                for i in range(16):
                    dy, dx = (i >> 2) * 4, (i & 3) * 4
                    mv = (int(bmv[i, 0]), int(bmv[i, 1]))
                    if need_clamp:
                        mv = clamp_y(mv)
                    Y[y0 + dy:y0 + dy + 4, x0 + dx:x0 + dx + 4] = \
                        _predict_inter(refY, y0 + dy, x0 + dx, mv, 4, 4,
                                       sixtap)
            # chroma: per-quadrant averaged MVs (build_4x4uvmvs)
            for qi in range(2):
                for qj in range(2):
                    yo = qi * 8 + qj * 2
                    tr = int(bmv[yo, 0] + bmv[yo + 1, 0]
                             + bmv[yo + 4, 0] + bmv[yo + 5, 0])
                    tc = int(bmv[yo, 1] + bmv[yo + 1, 1]
                             + bmv[yo + 4, 1] + bmv[yo + 5, 1])
                    tr = tr + 4 + (-8 if tr < 0 else 0)
                    tc = tc + 4 + (-8 if tc < 0 else 0)
                    uvr = _trunc_div(tr, 8) & fp_mask
                    uvc = _trunc_div(tc, 8) & fp_mask
                    if need_clamp:
                        # clamp_uvmv_to_umv_border
                        if 2 * uvc < mb_to_left - (19 << 3):
                            uvc = (mb_to_left - (16 << 3)) >> 1
                        if 2 * uvc > mb_to_right + (18 << 3):
                            uvc = (mb_to_right + (16 << 3)) >> 1
                        if 2 * uvr < mb_to_top - (19 << 3):
                            uvr = (mb_to_top - (16 << 3)) >> 1
                        if 2 * uvr > mb_to_bottom + (18 << 3):
                            uvr = (mb_to_bottom + (16 << 3)) >> 1
                    by, bx = cy + qi * 4, cx + qj * 4
                    U[by:by + 4, bx:bx + 4] = _predict_inter(
                        refU, by, bx, (uvr, uvc), 4, 4, sixtap)
                    V[by:by + 4, bx:bx + 4] = _predict_inter(
                        refV, by, bx, (uvr, uvc), 4, 4, sixtap)

        if not skip:
            if ym != B_PRED and ym != SPLITMV:
                self._add_y_residual_y2(Y, y0, x0, coeffs, eobs,
                                        y1dc, y1ac, y2dc, y2ac)
            else:   # SPLITMV: 16 independent Y blocks, no Y2
                dq = np.array([y1dc] + [y1ac] * 15, np.int64)
                for i in range(16):
                    br, bcol = i >> 2, i & 3
                    by, bx = y0 + br * 4, x0 + bcol * 4
                    if eobs[i] > 1:
                        resid = R.idct4x4(_dq16(coeffs[i], dq))
                        blk = (Y[by:by + 4, bx:bx + 4].astype(np.int32)
                               + resid)
                        Y[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)
                    elif eobs[i] == 1:
                        dc = (R._s16(int(coeffs[i][0]) * y1dc) + 4) >> 3
                        blk = (Y[by:by + 4, bx:bx + 4].astype(np.int32)
                               + dc)
                        Y[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)
            self._add_uv_residual(U, V, r, c, coeffs, eobs, uvdc, uvac)

    # -------------------------------------------------- shared residual

    def _add_y_residual_y2(self, Y, y0, x0, coeffs, eobs, y1dc, y1ac,
                           y2dc, y2ac):
        """Y2 walsh-distributed DCs + 16 Y blocks (decode_macroblock
        has_y2 path)."""
        if eobs[24] > 1:
            y2 = _dq16(coeffs[24],
                       np.array([y2dc] + [y2ac] * 15, np.int64))
            dcs = R.iwalsh4x4(y2)
        else:
            dc0 = R._s16(int(coeffs[24][0]) * y2dc)
            d = R._s16((dc0 + 3) >> 3)
            dcs = np.full(16, d, np.int32)
        dq = np.array([y1dc] + [y1ac] * 15, np.int64)
        for i in range(16):
            br, bcol = i >> 2, i & 3
            by, bx = y0 + br * 4, x0 + bcol * 4
            blkc = _dq16(coeffs[i], dq)
            blkc[0] = dcs[i]
            if eobs[i] > 1 or dcs[i]:
                resid = R.idct4x4(blkc)
                blk = Y[by:by + 4, bx:bx + 4].astype(np.int32) + resid
                Y[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)

    def _add_uv_residual(self, U, V, r, c, coeffs, eobs, uvdc, uvac):
        dqc = np.array([uvdc] + [uvac] * 15, np.int64)
        for i in range(16, 24):
            P = U if i < 20 else V
            j = i - 16 if i < 20 else i - 20
            br, bcol = j >> 1, j & 1
            by = BC + r * 8 + br * 4
            bx = BC + c * 8 + bcol * 4
            if eobs[i] > 1:
                resid = R.idct4x4(_dq16(coeffs[i], dqc))
                blk = P[by:by + 4, bx:bx + 4].astype(np.int32) + resid
                P[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)
            elif eobs[i] == 1:
                dc = (R._s16(int(coeffs[i][0]) * uvdc) + 4) >> 3
                blk = P[by:by + 4, bx:bx + 4].astype(np.int32) + dc
                P[by:by + 4, bx:bx + 4] = np.clip(blk, 0, 255)

    # ------------------------------------------------------ loop filter

    def _loop_filter(self, Y, U, V, hdr, mb_mode, mb_skip_lf, W16, H16):
        if hdr.filter_level == 0:
            return
        limits = R.lf_limits(hdr.sharpness)
        mb_rows, mb_cols = mb_mode.shape
        frame_type = hdr.frame_type  # 0 key, 1 inter (hev lut index)
        Yl = Y.astype(np.int32)
        Ul = U.astype(np.int32)
        Vl = V.astype(np.int32)
        for r in range(mb_rows):
            for c in range(mb_cols):
                ym = int(mb_mode[r, c])
                ref = (int(self._lf_refs[r, c])
                       if self._lf_refs is not None else INTRA)
                lvl = hdr.filter_level
                if hdr.seg_enabled:
                    seg = int(self.seg_map[r, c])
                    if hdr.seg_abs_delta:
                        lvl = hdr.seg_lf[seg]
                    else:
                        lvl = lvl + hdr.seg_lf[seg]
                    lvl = max(0, min(63, lvl))
                if hdr.lf_delta_enabled:
                    # vp8_loop_filter_frame_init lvl[seg][ref][mode]
                    lvl += hdr.ref_lf_deltas[ref]
                    if ym == B_PRED:
                        lvl += hdr.mode_lf_deltas[0]
                    elif ym == ZEROMV:
                        lvl += hdr.mode_lf_deltas[1]
                    elif ym in (NEARESTMV, NEARMV, NEWMV):
                        lvl += hdr.mode_lf_deltas[2]
                    elif ym == SPLITMV:
                        lvl += hdr.mode_lf_deltas[3]
                    # other intra modes: ref delta only
                    lvl = max(0, min(63, lvl))
                if lvl == 0:
                    continue
                blim, mblim, lim = limits[lvl]
                thr = R.hev_threshold(frame_type, lvl)
                skip = bool(mb_skip_lf[r, c])
                y0, x0 = BY + r * 16, BY + c * 16
                cy, cx = BC + r * 8, BC + c * 8
                if hdr.filter_type == 0:   # normal
                    if c > 0:
                        R._edge_v(Yl, y0, x0, 16, mblim, lim, thr, True)
                        R._edge_v(Ul, cy, cx, 8, mblim, lim, thr, True)
                        R._edge_v(Vl, cy, cx, 8, mblim, lim, thr, True)
                    if not skip:
                        for dx in (4, 8, 12):
                            R._edge_v(Yl, y0, x0 + dx, 16, blim, lim,
                                      thr, False)
                        R._edge_v(Ul, cy, cx + 4, 8, blim, lim, thr, False)
                        R._edge_v(Vl, cy, cx + 4, 8, blim, lim, thr, False)
                    if r > 0:
                        R._edge_h(Yl, y0, x0, 16, mblim, lim, thr, True)
                        R._edge_h(Ul, cy, cx, 8, mblim, lim, thr, True)
                        R._edge_h(Vl, cy, cx, 8, mblim, lim, thr, True)
                    if not skip:
                        for dy in (4, 8, 12):
                            R._edge_h(Yl, y0 + dy, x0, 16, blim, lim,
                                      thr, False)
                        R._edge_h(Ul, cy + 4, cx, 8, blim, lim, thr, False)
                        R._edge_h(Vl, cy + 4, cx, 8, blim, lim, thr, False)
                else:                       # simple: luma only
                    if c > 0:
                        R._simple_edge(Yl, y0, x0, False, mblim)
                    if not skip:
                        for dx in (4, 8, 12):
                            R._simple_edge(Yl, y0, x0 + dx, False, blim)
                    if r > 0:
                        R._simple_edge(Yl, y0, x0, True, mblim)
                    if not skip:
                        for dy in (4, 8, 12):
                            R._simple_edge(Yl, y0 + dy, x0, True, blim)
        Y[:] = Yl.astype(np.uint8)
        U[:] = Ul.astype(np.uint8)
        V[:] = Vl.astype(np.uint8)

    # ------------------------------------------------- borders and refs

    @staticmethod
    def _extend_borders(Y, U, V, W16, H16):
        """vp8_yv12_extend_frame_borders: replicate the image edge into
        the full border (left/right first, then top/bottom rows copy the
        already-extended rows -> corners filled)."""
        for P, B, w, h in ((Y, BY, W16, H16),
                           (U, BC, W16 // 2, H16 // 2),
                           (V, BC, W16 // 2, H16 // 2)):
            P[B:B + h, :B] = P[B:B + h, B:B + 1]
            P[B:B + h, B + w:] = P[B:B + h, B + w - 1:B + w]
            P[:B, :] = P[B:B + 1, :]
            P[B + h:, :] = P[B + h - 1:B + h, :]

    def _update_refs(self, hdr, frame):
        """onyxd_if.c swap_frame_buffers order: arf copy, gf copy (may
        see the just-copied arf), then refreshes from the new frame."""
        refs = self.refs
        if hdr.copy_to_arf == 1:
            refs[ALTREF] = refs[LAST]
        elif hdr.copy_to_arf == 2:
            refs[ALTREF] = refs[GOLDEN]
        if hdr.copy_to_gf == 1:
            refs[GOLDEN] = refs[LAST]
        elif hdr.copy_to_gf == 2:
            refs[GOLDEN] = refs[ALTREF]
        if hdr.refresh_golden:
            refs[GOLDEN] = frame
        if hdr.refresh_alt:
            refs[ALTREF] = frame
        if hdr.refresh_last:
            refs[LAST] = frame

    # loop-filter needs per-MB ref_frame; stashed by the body
    _lf_refs = None


class Vp8KeyframeDecoder(Vp8Decoder):
    """Back-compat alias: the stateful decoder handles keyframes (and
    now inter frames) identically."""
