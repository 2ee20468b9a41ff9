"""VP8 encoder: keyframe intra + inter P-frames, fixed-QP or one-pass RC.

Reference counterparts: vp8/encoder/onyx_if.c (frame pipeline),
vp8/encoder/bitstream.c (header + token write), vp8/encoder/encodemb.c /
dct.c (forward transforms), vp8/encoder/quantize.c, vp8/encoder/
pickinter.c (mode decision).  Design notes: the encoder is
a capability-parity component (SURVEY S18 - the reference ships the full
stock VP8 codec); it runs host-side in vectorized NumPy.  The in-loop
reconstruction calls the SAME normative routines the decoder uses
(`Vp8Decoder._recon_intra_mb` / `_recon_inter_mb`), so encoder state and
decoder output are bit-identical by construction.

The token/mode writers mirror `vp8/decoder.py`'s readers exactly - the
decode tree IS the spec.
"""

from __future__ import annotations

import numpy as np

from ..encoder.bitwriter import BoolEncoder, tree_paths
from . import recon as R
from . import tables_gen as T
from .decoder import (ALTREF, BC, BY, GOLDEN, INTRA, LAST, NEARESTMV,
                      NEARMV, NEWMV, ZEROMV, Vp8Decoder, Vp8Header,
                      _dequant_factors, _dq16, _KBANDS, _CAT_PROBS)

DC_PRED, V_PRED, H_PRED, TM_PRED = 0, 1, 2, 3

_KF_YMODE_PATHS = tree_paths(T.KF_YMODE_TREE)
_YMODE_PATHS = tree_paths(T.YMODE_TREE)
_UV_PATHS = tree_paths(T.UV_MODE_TREE)
_SMALL_MV_PATHS = tree_paths(T.SMALL_MVTREE)


# ----------------------------------------------------------- transforms


def fdct4x4(b):
    """Forward 4x4 DCT (vp8/encoder/dct.c vp8_short_fdct4x4 math).
    b: int residual [4, 4]; returns 16 coefficients in natural order."""
    ip = b.astype(np.int64)
    o = np.empty((4, 4), np.int64)
    a1 = (ip[:, 0] + ip[:, 3]) * 8
    b1 = (ip[:, 1] + ip[:, 2]) * 8
    c1 = (ip[:, 1] - ip[:, 2]) * 8
    d1 = (ip[:, 0] - ip[:, 3]) * 8
    o[:, 0] = a1 + b1
    o[:, 2] = a1 - b1
    o[:, 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12
    o[:, 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12
    out = np.empty((4, 4), np.int64)
    a1 = o[0] + o[3]
    b1 = o[1] + o[2]
    c1 = o[1] - o[2]
    d1 = o[0] - o[3]
    out[0] = (a1 + b1 + 7) >> 4
    out[2] = (a1 - b1 + 7) >> 4
    out[1] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
    out[3] = (d1 * 2217 - c1 * 5352 + 51000) >> 16
    return out.reshape(-1)


def fwalsh4x4(d):
    """Forward WHT over the 16 per-block DC coefficients.  The decoder's
    iwalsh4x4 is the scaled Hadamard `H.w / 8` with `H^2 = 16 I`, so the
    exact forward is `round(H.d / 2)` via the same butterfly structure
    (recon.iwalsh4x4 without the final >>3).  d: int [16] in Y-block
    raster order; returns 16 Y2 coefficients in natural order."""
    ip = d.astype(np.int64).reshape(4, 4)
    out = np.empty((4, 4), np.int64)
    a1 = ip[0] + ip[3]
    b1 = ip[1] + ip[2]
    c1 = ip[1] - ip[2]
    d1 = ip[0] - ip[3]
    out[0] = a1 + b1
    out[1] = c1 + d1
    out[2] = a1 - b1
    out[3] = d1 - c1
    hd = np.empty((4, 4), np.int64)
    a1 = out[:, 0] + out[:, 3]
    b1 = out[:, 1] + out[:, 2]
    c1 = out[:, 1] - out[:, 2]
    d1 = out[:, 0] - out[:, 3]
    hd[:, 0] = a1 + b1
    hd[:, 1] = c1 + d1
    hd[:, 2] = a1 - b1
    hd[:, 3] = d1 - c1
    # round-half-away /2
    return np.where(hd >= 0, (hd + 1) >> 1, -((1 - hd) >> 1)).reshape(-1)


def quantize(coeffs, dq, first=0):
    """Round-half-away quantization; levels clamped so dequantization
    stays inside int16 (the decoder's _dq16 wraps) and the top token
    category (|v| <= 2114)."""
    lv = np.zeros(16, np.int64)
    for i in range(first, 16):
        q = int(dq[0] if i == 0 else dq[1])
        cap = min(2114, 32767 // q)
        a = (abs(int(coeffs[i])) + (q >> 1)) // q
        lv[i] = min(a, cap) * (1 if coeffs[i] >= 0 else -1)
    return lv


# --------------------------------------------------------- token writer


def _emit_coeffs(bw, probs, ctx, first, levels):
    """Mirror of decoder._get_coeffs: emit the token string for one
    block.  levels: 16 quantized values in NATURAL order.  Returns the
    nz position (same value _get_coeffs returns) for context updates."""
    zz = [int(levels[T.ZIGZAG[i]]) for i in range(16)]
    eob = 0
    for i in range(first, 16):
        if zz[i]:
            eob = i + 1
    p = probs[_KBANDS[first]][ctx]
    if eob == 0:
        bw.write(0, p[0])
        return 0
    bw.write(1, p[0])
    n = first
    while True:
        v = zz[n]
        n += 1
        a = abs(v)
        if a == 0:
            bw.write(0, p[1])
            p = probs[_KBANDS[n]][0]
            continue
        bw.write(1, p[1])
        if a == 1:
            bw.write(0, p[2])
            nctx = 1
        else:
            bw.write(1, p[2])
            nctx = 2
            if a <= 4:
                bw.write(0, p[3])
                if a == 2:
                    bw.write(0, p[4])
                else:
                    bw.write(1, p[4])
                    bw.write(a - 3, p[5])
            else:
                bw.write(1, p[3])
                if a <= 10:
                    bw.write(0, p[6])
                    if a <= 6:
                        bw.write(0, p[7])
                        bw.write(a - 5, 159)
                    else:
                        bw.write(1, p[7])
                        bw.write((a - 7) >> 1, 165)
                        bw.write((a - 7) & 1, 145)
                else:
                    bw.write(1, p[6])
                    if a >= 67:
                        cat = 3
                    elif a >= 35:
                        cat = 2
                    elif a >= 19:
                        cat = 1
                    else:
                        cat = 0
                    bit1 = cat >> 1
                    bw.write(bit1, p[8])
                    bw.write(cat & 1, p[9 + bit1])
                    e = a - (3 + (8 << cat))
                    cp = _CAT_PROBS[cat + 2]
                    nb = len(cp)
                    for bi, pr in enumerate(cp):
                        bw.write((e >> (nb - 1 - bi)) & 1, pr)
        bw.write(1 if v < 0 else 0, 128)
        p = probs[_KBANDS[n]][nctx]
        if n == 16:
            return 16
        if n == eob:
            bw.write(0, p[0])
            return eob
        bw.write(1, p[0])


# -------------------------------------------------------------- encoder


class Vp8Encoder:
    """Stateful VP8 encoder.  encode(planes) -> frame payload bytes.

    The first frame (and any frame after request_keyframe()) is a
    keyframe; subsequent frames are P-frames predicting from LAST with
    ZEROMV/NEWMV (vp8/encoder/pickinter.c's realtime subset).
    """

    def __init__(self, width: int, height: int, qindex: int = 40,
                 filter_level: int = 0, bitrate_kbps: int = 0,
                 fps: float = 30.0, kf_interval: int = 0):
        self.W, self.H = width, height
        self.mb_cols = (width + 15) >> 4
        self.mb_rows = (height + 15) >> 4
        self.qindex = int(qindex)
        self.filter_level = int(filter_level)
        self.kf_interval = kf_interval
        self._force_kf = True
        self._frame_idx = 0
        # normative in-loop reconstruction: a decoder instance whose
        # recon methods the encoder calls MB by MB
        self._loop = Vp8Decoder()
        self.refs = {LAST: None, GOLDEN: None, ALTREF: None}
        # one-pass rate control (vp8/encoder/ratectrl.c shape)
        self.rc_enabled = bitrate_kbps > 0
        self._rc_target = bitrate_kbps * 1000.0 / 8.0 / fps  # bytes/frame
        self._q = float(qindex)

    def request_keyframe(self):
        self._force_kf = True

    def encode_frame(self, planes) -> bytes:
        """vpxenc-facing alias (the VP9 encoder's method name)."""
        return self.encode(planes)

    @property
    def _last_recon(self):
        """Cropped in-loop reconstruction planes (vpxenc --psnr)."""
        if self.refs[LAST] is None:
            return None
        Y, U, V = self.refs[LAST]
        ch, cw = (self.H + 1) // 2, (self.W + 1) // 2
        return (Y[BY:BY + self.H, BY:BY + self.W],
                U[BC:BC + ch, BC:BC + cw], V[BC:BC + ch, BC:BC + cw])

    # ------------------------------------------------------------- RC

    def _rc_pre(self, is_key):
        if not self.rc_enabled:
            return
        self.qindex = int(np.clip(round(self._q - (8 if is_key else 0)),
                                  0, 127))

    def _rc_post(self, nbytes, is_key):
        if not self.rc_enabled:
            return
        target = self._rc_target * (4.0 if is_key else 1.0)
        err = (nbytes - target) / max(target, 1.0)
        self._q = float(np.clip(self._q + np.clip(10.0 * err, -6, 6),
                                0, 127))

    # ----------------------------------------------------------- frames

    def encode(self, planes) -> bytes:
        y, u, v = (np.asarray(p, np.uint8) for p in planes)
        assert y.shape == (self.H, self.W), "frame size mismatch"
        is_key = self._force_kf or self.refs[LAST] is None or (
            self.kf_interval and self._frame_idx % self.kf_interval == 0)
        self._force_kf = False
        self._rc_pre(is_key)
        payload = (self._encode_keyframe(y, u, v) if is_key
                   else self._encode_interframe(y, u, v))
        self._frame_idx += 1
        self._rc_post(len(payload), is_key)
        return payload

    def _make_header(self, is_key) -> Vp8Header:
        hdr = Vp8Header()
        hdr.frame_type = 0 if is_key else 1
        hdr.version = 0
        hdr.show_frame = 1
        hdr.width, hdr.height = self.W, self.H
        hdr.hscale = hdr.vscale = 0
        hdr.seg_enabled = 0
        hdr.seg_quant = [0] * 4
        hdr.seg_lf = [0] * 4
        hdr.seg_abs_delta = 0
        hdr.filter_type = 0
        hdr.filter_level = self.filter_level
        hdr.sharpness = 0
        hdr.lf_delta_enabled = 0
        hdr.ref_lf_deltas = [0] * 4
        hdr.mode_lf_deltas = [0] * 4
        hdr.base_qindex = self.qindex
        hdr.y1dc_delta = hdr.y2dc_delta = hdr.y2ac_delta = 0
        hdr.uvdc_delta = hdr.uvac_delta = 0
        hdr.refresh_entropy = 0        # default probs every frame
        hdr.refresh_last = 1
        hdr.refresh_golden = 1 if is_key else 0
        hdr.refresh_alt = 1 if is_key else 0
        hdr.copy_to_gf = hdr.copy_to_arf = 0
        hdr.mb_no_coeff_skip = 1
        hdr.prob_skip_false = 128      # patched after MB analysis
        return hdr

    @staticmethod
    def _canvases(mr, mc):
        """Bordered recon canvases, identical init to the decoder's
        (_decode_frame_body:728-738)."""
        H16, W16 = mr * 16, mc * 16
        Y = np.zeros((BY + H16 + BY, BY + W16 + BY), np.uint8)
        U = np.zeros((BC + H16 // 2 + BC, BC + W16 // 2 + BC), np.uint8)
        V = np.zeros_like(U)
        Y[BY - 1, BY - 1:BY + W16 + 5] = 127
        U[BC - 1, BC - 1:BC + W16 // 2 + 5] = 127
        V[BC - 1, BC - 1:BC + W16 // 2 + 5] = 127
        Y[BY:BY + H16, BY - 1] = 129
        U[BC:BC + H16 // 2, BC - 1] = 129
        V[BC:BC + H16 // 2, BC - 1] = 129
        return Y, U, V

    def _pad_source(self, y, u, v):
        """Source planes padded to whole macroblocks by edge replication
        (the encoder analog of the decoder's border clamp)."""
        H16, W16 = self.mb_rows * 16, self.mb_cols * 16
        cw, ch = (self.W + 1) // 2, (self.H + 1) // 2
        ys = np.empty((H16, W16), np.uint8)
        ys[:self.H, :self.W] = y
        ys[self.H:, :self.W] = y[-1:, :]
        ys[:, self.W:] = ys[:, self.W - 1:self.W]
        us = np.empty((H16 // 2, W16 // 2), np.uint8)
        vs = np.empty_like(us)
        for src, dst in ((u, us), (v, vs)):
            dst[:ch, :cw] = src
            dst[ch:, :cw] = src[ch - 1:ch, :]
            dst[:, cw:] = dst[:, cw - 1:cw]
        return ys, us, vs

    # --------------------------------------------------- MB coding core

    def _code_mb_residual(self, hdr, ysrc, usrc, vsrc, Y, U, V, r, c,
                          ym, uvm, predY, predU, predV):
        """Transform + quantize one MB's residual against the given
        predictions.  Returns (coeffs [25,16] levels, eobs, skip)."""
        y1dc, y1ac, y2dc, y2ac, uvdc, uvac = _dequant_factors(hdr, 0)
        y0, x0 = BY + r * 16, BY + c * 16
        cy, cx = BC + r * 8, BC + c * 8
        coeffs = np.zeros((25, 16), np.int64)
        eobs = np.zeros(25, np.int32)
        resid = (ysrc[r * 16:r * 16 + 16, c * 16:c * 16 + 16]
                 .astype(np.int64) - predY.astype(np.int64))
        dcs = np.zeros(16, np.int64)
        dqy = (y1dc, y1ac)
        for i in range(16):
            br, bcol = i >> 2, i & 3
            blk = fdct4x4(resid[br * 4:br * 4 + 4, bcol * 4:bcol * 4 + 4])
            dcs[i] = blk[0]
            coeffs[i] = quantize(blk, dqy, first=1)
        coeffs[24] = quantize(fwalsh4x4(dcs), (y2dc, y2ac))
        dqc = (uvdc, uvac)
        for pi, (src, pred) in enumerate(((usrc, predU), (vsrc, predV))):
            cres = (src[r * 8:r * 8 + 8, c * 8:c * 8 + 8].astype(np.int64)
                    - pred.astype(np.int64))
            for j in range(4):
                br, bcol = j >> 1, j & 1
                blk = fdct4x4(cres[br * 4:br * 4 + 4, bcol * 4:bcol * 4 + 4])
                coeffs[16 + pi * 4 + j] = quantize(blk, dqc)
        # eobs exactly as the decoder computes them: _get_coeffs returns
        # the position after the last nonzero (0 if none), and Y1 blocks
        # get `+ first` added on top (_decode_frame_body:802)
        skip = True
        for i in range(25):
            first = 1 if i < 16 else 0
            nz = 0
            for k in range(first, 16):
                if coeffs[i][T.ZIGZAG[k]]:
                    nz = k + 1
            if nz:
                skip = False
            eobs[i] = nz + (first if i < 16 else 0)
        return coeffs, eobs, skip

    def _pick_intra_modes(self, ysrc, usrc, vsrc, Y, U, V, r, c):
        """Best 16x16 Y mode and UV mode by SAD against the in-loop
        reconstruction's neighbors (pickinter.c's non-RD selection)."""
        y0, x0 = BY + r * 16, BY + c * 16
        cy, cx = BC + r * 8, BC + c * 8
        up, left = r > 0, c > 0
        sy = ysrc[r * 16:r * 16 + 16, c * 16:c * 16 + 16].astype(np.int64)
        best_ym, best_cost, best_pred = 0, None, None
        for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
            pred = R.mb_pred(m, Y[y0 - 1, x0:x0 + 16],
                             Y[y0:y0 + 16, x0 - 1], Y[y0 - 1, x0 - 1],
                             16, up, left)
            cost = int(np.abs(sy - pred).sum())
            if best_cost is None or cost < best_cost:
                best_ym, best_cost, best_pred = m, cost, pred
        su = usrc[r * 8:r * 8 + 8, c * 8:c * 8 + 8].astype(np.int64)
        sv = vsrc[r * 8:r * 8 + 8, c * 8:c * 8 + 8].astype(np.int64)
        best_uv, best_ucost, bu, bv = 0, None, None, None
        for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
            pu = R.mb_pred(m, U[cy - 1, cx:cx + 8], U[cy:cy + 8, cx - 1],
                           U[cy - 1, cx - 1], 8, up, left)
            pv = R.mb_pred(m, V[cy - 1, cx:cx + 8], V[cy:cy + 8, cx - 1],
                           V[cy - 1, cx - 1], 8, up, left)
            cost = int(np.abs(su - pu).sum() + np.abs(sv - pv).sum())
            if best_ucost is None or cost < best_ucost:
                best_uv, best_ucost, bu, bv = m, cost, pu, pv
        return best_ym, best_pred, best_uv, bu, bv

    def _emit_mb_tokens(self, bw, probs, a, l, coeffs, eobs, skip,
                        has_y2):
        """Token emission + entropy context updates, mirroring
        _decode_frame_body:773-813."""
        if skip:
            a[:8] = 0
            l[:8] = 0
            if has_y2:
                a[8] = l[8] = 0
            return
        first = 0
        if has_y2:
            ctx = int(a[8] + l[8])
            nz = _emit_coeffs(bw, probs[1], ctx, 0, coeffs[24])
            a[8] = l[8] = int(nz > 0)
            ptype = 0
            first = 1
        else:
            ptype = 3
        for i in range(16):
            ai, li = i & 3, (i & 0xC) >> 2
            ctx = int(a[ai] + l[li])
            nz = _emit_coeffs(bw, probs[ptype], ctx, first, coeffs[i])
            a[ai] = l[li] = int(nz > 0)
        for i in range(16, 24):
            ai = 4 + (((i > 19) << 1) + (i & 1))
            li = 4 + (((i > 19) << 1) + int((i & 3) > 1))
            ctx = int(a[ai] + l[li])
            nz = _emit_coeffs(bw, probs[2], ctx, 0, coeffs[i])
            a[ai] = l[li] = int(nz > 0)

    def _write_common_header(self, bc1, hdr, is_key):
        """First-partition fields up to the per-MB data, mirroring
        decoder.decode():364-464."""
        if is_key:
            bc1.write_bit(0)               # colorspace
            bc1.write_bit(0)               # clamping
        bc1.write_bit(hdr.seg_enabled)
        bc1.write_bit(hdr.filter_type)
        bc1.write_literal(hdr.filter_level, 6)
        bc1.write_literal(hdr.sharpness, 3)
        bc1.write_bit(hdr.lf_delta_enabled)
        bc1.write_literal(0, 2)            # log2 token partitions = 0
        bc1.write_literal(hdr.base_qindex, 7)
        for _ in range(5):
            bc1.write_bit(0)               # q deltas absent
        if not is_key:
            bc1.write_bit(hdr.refresh_golden)
            bc1.write_bit(hdr.refresh_alt)
            if not hdr.refresh_golden:
                bc1.write_literal(hdr.copy_to_gf, 2)
            if not hdr.refresh_alt:
                bc1.write_literal(hdr.copy_to_arf, 2)
            bc1.write_bit(0)               # sign bias golden
            bc1.write_bit(0)               # sign bias altref
        bc1.write_bit(hdr.refresh_entropy)
        if not is_key:
            bc1.write_bit(hdr.refresh_last)
        # no coefficient prob updates
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    up = T.COEF_UPDATE_PROBS[i][j][k]
                    for li in range(11):
                        bc1.write(0, up[li])
        bc1.write_bit(hdr.mb_no_coeff_skip)
        bc1.write_literal(hdr.prob_skip_false, 8)

    @staticmethod
    def _assemble(hdr, is_key, first_part: bytes, tokens: bytes,
                  W, H) -> bytes:
        tag = (hdr.frame_type | (hdr.version << 1) | (hdr.show_frame << 4)
               | (len(first_part) << 5))
        out = bytearray([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
        if is_key:
            out += b"\x9d\x01\x2a"
            out += bytes([W & 0xFF, (W >> 8) & 0x3F, H & 0xFF,
                          (H >> 8) & 0x3F])
        out += first_part
        out += tokens
        return bytes(out)

    # --------------------------------------------------------- keyframe

    def _encode_keyframe(self, y, u, v) -> bytes:
        mr, mc = self.mb_rows, self.mb_cols
        hdr = self._make_header(True)
        ysrc, usrc, vsrc = self._pad_source(y, u, v)
        Y, U, V = self._canvases(mr, mc)
        probs = [[[list(T.DEFAULT_COEF_PROBS[i][j][k]) for k in range(3)]
                  for j in range(8)] for i in range(4)]

        # pass 1: mode decision + transform/quant + in-loop recon
        mbs = []
        for r in range(mr):
            for c in range(mc):
                ym, predY, uvm, pu, pv = self._pick_intra_modes(
                    ysrc, usrc, vsrc, Y, U, V, r, c)
                coeffs, eobs, skip = self._code_mb_residual(
                    hdr, ysrc, usrc, vsrc, Y, U, V, r, c, ym, uvm,
                    predY, pu, pv)
                # normative in-loop reconstruction (the decoder's own)
                self._loop._recon_intra_mb(
                    Y, U, V, hdr, r, c, ym, np.zeros((4, 4), np.int32),
                    uvm, 0, bool(skip), coeffs.astype(np.int32), eobs,
                    mc * 16)
                mbs.append((ym, uvm, coeffs, eobs, skip))
            # right-border extension per MB row (decoder:851-857)
            y0r, y1r = BY + r * 16, BY + (r + 1) * 16
            Y[y0r:y1r, BY + mc * 16:] = Y[y0r:y1r,
                                          BY + mc * 16 - 1:BY + mc * 16]
            c0, c1 = BC + r * 8, BC + (r + 1) * 8
            U[c0:c1, BC + mc * 8:] = U[c0:c1, BC + mc * 8 - 1:BC + mc * 8]
            V[c0:c1, BC + mc * 8:] = V[c0:c1, BC + mc * 8 - 1:BC + mc * 8]

        nskip = sum(1 for mb in mbs if mb[4])
        hdr.prob_skip_false = int(np.clip(
            256 - (256 * nskip) // max(len(mbs), 1), 1, 255))

        # pass 2: write partitions
        bc1 = BoolEncoder(marker=False)
        self._write_common_header(bc1, hdr, True)
        for (ym, uvm, _, _, skip) in mbs:
            bc1.write(1 if skip else 0, hdr.prob_skip_false)
            bc1.write_tree(T.KF_YMODE_TREE, T.KF_YMODE_PROB,
                           _KF_YMODE_PATHS, ym)
            bc1.write_tree(T.UV_MODE_TREE, T.KF_UV_MODE_PROB,
                           _UV_PATHS, uvm)
        first_part = bc1.stop()

        bc2 = BoolEncoder(marker=False)
        above_ctx = np.zeros((mc, 9), np.int32)
        k = 0
        for r in range(mr):
            left_ctx = np.zeros(9, np.int32)
            for c in range(mc):
                (_, _, coeffs, eobs, skip) = mbs[k]
                k += 1
                self._emit_mb_tokens(bc2, probs, above_ctx[c], left_ctx,
                                     coeffs, eobs, skip, True)
        tokens = bc2.stop()

        self._finish_frame(hdr, Y, U, V, mr, mc)
        return self._assemble(hdr, True, first_part, tokens,
                              self.W, self.H)

    # ------------------------------------------------------ inter frame

    def _find_near_mvs(self, r, c, ref_frame, mode_arr, mvs):
        """Mirror of _read_mb_modes_mv's candidate scan (all our refs
        share sign bias 0, so _mv_bias is the identity)."""
        br_, bc_ = r + 1, c + 1
        near = [(0, 0), (0, 0), (0, 0), (0, 0)]
        cnt = [0, 0, 0, 0]
        nmv_i = 0
        cnt_i = 0
        a_ref = ref_frame[br_ - 1, bc_]
        a_mv = (int(mvs[br_ - 1, bc_, 0]), int(mvs[br_ - 1, bc_, 1]))
        l_ref = ref_frame[br_, bc_ - 1]
        l_mv = (int(mvs[br_, bc_ - 1, 0]), int(mvs[br_, bc_ - 1, 1]))
        al_ref = ref_frame[br_ - 1, bc_ - 1]
        al_mv = (int(mvs[br_ - 1, bc_ - 1, 0]),
                 int(mvs[br_ - 1, bc_ - 1, 1]))
        if a_ref != INTRA:
            if a_mv != (0, 0):
                nmv_i += 1
                near[nmv_i] = a_mv
                cnt_i = nmv_i
            cnt[cnt_i] += 2
        if l_ref != INTRA:
            if l_mv != (0, 0):
                if l_mv != near[nmv_i]:
                    nmv_i += 1
                    near[nmv_i] = l_mv
                    cnt_i = nmv_i
                cnt[cnt_i] += 2
            else:
                cnt[0] += 2
        if al_ref != INTRA:
            if al_mv != (0, 0):
                if al_mv != near[nmv_i]:
                    nmv_i += 1
                    near[nmv_i] = al_mv
                    cnt_i = nmv_i
                cnt[cnt_i] += 1
            else:
                cnt[0] += 1
        return near, cnt, nmv_i

    @staticmethod
    def _mv_bounds(r, c, mr, mc):
        M = 16 << 3
        return (-((c * 16) << 3) - M, ((mc - 1 - c) * 16 << 3) + M,
                -((r * 16) << 3) - M, ((mr - 1 - r) * 16 << 3) + M)

    # ---- MV writing (mirror of decoder._read_mvcomponent / _read_mv)

    @staticmethod
    def _write_mvcomponent(bw, v, p):
        """v in 1/4-pel units; p = flat 19-prob context (mvc[comp])."""
        a = abs(int(v))
        assert a < 1024
        if a >= 8:
            bw.write(1, p[0])
            for i in range(3):
                bw.write((a >> i) & 1, p[9 + i])
            for i in range(9, 3, -1):
                bw.write((a >> i) & 1, p[9 + i])
            if a & 0xFFF0:
                bw.write((a >> 3) & 1, p[9 + 3])
            # else bit 3 is implicit (a in 8..15)
        else:
            bw.write(0, p[0])
            bw.write_tree(T.SMALL_MVTREE, p[2:9], _SMALL_MV_PATHS, a)
        if a:
            bw.write(1 if v < 0 else 0, p[1])

    def _write_mv(self, bw, mv, best):
        """Residual vs best_mv, components in 1/4 pel (decoder _read_mv
        doubles them back to 1/8 pel)."""
        dr = (mv[0] - best[0]) >> 1
        dc = (mv[1] - best[1]) >> 1
        self._write_mvcomponent(bw, dr, self._mvc[0])
        self._write_mvcomponent(bw, dc, self._mvc[1])

    _mvc = [list(T.DEFAULT_MV_CONTEXT[0][0]),
            list(T.DEFAULT_MV_CONTEXT[1][0])]

    def _search_newmv(self, ysrc, refY, r, c, best_mv, bounds):
        """Diamond full-pel SAD search + quarter-pel refinement around
        best_mv (vp8/encoder/mcomp.c's realtime subset).  Returns an
        MV in 1/8-pel units (even components) inside `bounds`."""
        lo_c, hi_c, lo_r, hi_r = bounds
        y0, x0 = BY + r * 16, BY + c * 16
        src = ysrc[r * 16:r * 16 + 16, c * 16:c * 16 + 16].astype(np.int64)

        def inb(dr, dc):
            # full-pel candidate must stay inside the UMV bounds (so
            # the coded MV never needs the decoder's clamp) and the
            # canvas border read margin
            return (abs(dr) <= 24 and abs(dc) <= 24
                    and lo_r <= dr * 8 <= hi_r and lo_c <= dc * 8 <= hi_c)

        def sad_fullpel(dr, dc):
            yy, xx = y0 + dr, x0 + dc
            blk = refY[yy:yy + 16, xx:xx + 16]
            if blk.shape != (16, 16):
                return 1 << 40
            return int(np.abs(src - blk.astype(np.int64)).sum())

        cr, cc = (best_mv[0] + 4) >> 3, (best_mv[1] + 4) >> 3
        cr = max(-24, min(24, cr))
        cc = max(-24, min(24, cc))
        best, best_sad = (0, 0), sad_fullpel(0, 0)
        if inb(cr, cc) and sad_fullpel(cr, cc) < best_sad:
            best, best_sad = (cr, cc), sad_fullpel(cr, cc)
        step = 8
        while step:
            improved = True
            while improved:
                improved = False
                for dr, dc in ((-step, 0), (step, 0), (0, -step),
                               (0, step)):
                    cand = (best[0] + dr, best[1] + dc)
                    if not inb(*cand):
                        continue
                    sc = sad_fullpel(*cand)
                    if sc < best_sad:
                        best, best_sad, improved = cand, sc, True
            step >>= 1
        # quarter-pel refinement with the normative 6-tap filters
        from .decoder import _predict_inter
        bq = (best[0] * 8, best[1] * 8)
        best_q, bq_sad = bq, None
        for dr in (-2, 0, 2):
            for dc in (-2, 0, 2):
                cand = (bq[0] + dr, bq[1] + dc)
                if not (lo_r <= cand[0] <= hi_r
                        and lo_c <= cand[1] <= hi_c):
                    continue
                pred = _predict_inter(refY, y0, x0, cand, 16, 16, True)
                sc = int(np.abs(src - pred.astype(np.int64)).sum())
                if bq_sad is None or sc < bq_sad:
                    best_q, bq_sad = cand, sc
        return best_q, bq_sad if bq_sad is not None else best_sad

    def _encode_interframe(self, y, u, v) -> bytes:
        mr, mc = self.mb_rows, self.mb_cols
        hdr = self._make_header(False)
        ysrc, usrc, vsrc = self._pad_source(y, u, v)
        Y, U, V = self._canvases(mr, mc)
        refY, refU, refV = self.refs[LAST]
        probs = [[[list(T.DEFAULT_COEF_PROBS[i][j][k]) for k in range(3)]
                  for j in range(8)] for i in range(4)]

        # mode arrays with the decoder's borders
        ref_frame = np.zeros((mr + 1, mc + 2), np.int32)
        mode_arr = np.zeros((mr + 1, mc + 2), np.int32)
        mvs = np.zeros((mr + 1, mc + 2, 2), np.int32)

        # loop-recon needs a decoder whose refs point at OUR refs
        loop = self._loop
        loop.refs = {LAST: self.refs[LAST], GOLDEN: self.refs[GOLDEN],
                     ALTREF: self.refs[ALTREF]}
        loop.mb_rows, loop.mb_cols = mr, mc
        loop.seg_map = np.zeros((mr, mc), np.int32)

        clamp_arr = np.zeros((mr, mc), bool)
        M = 16 << 3
        mbs = []
        for r in range(mr):
            for c in range(mc):
                near, cnt, nmv_i = self._find_near_mvs(
                    r, c, ref_frame, mode_arr, mvs)
                mb_to_top = -((r * 16) << 3)
                mb_to_bottom = ((mr - 1 - r) * 16) << 3
                mb_to_left = -((c * 16) << 3)
                mb_to_right = ((mc - 1 - c) * 16) << 3
                bounds = (mb_to_left - M, mb_to_right + M,
                          mb_to_top - M, mb_to_bottom + M)
                # candidate post-merge near MVs exactly as the decoder
                # derives them (decoder:608-621)
                cnt2 = list(cnt)
                nearm = [tuple(near[i]) for i in range(4)]
                cnt2[1] += (1 if (cnt2[3] > 0
                                  and nearm[nmv_i] == nearm[1]) else 0)
                if cnt2[2] > cnt2[1]:
                    cnt2[1], cnt2[2] = cnt2[2], cnt2[1]
                    nearm[1], nearm[2] = nearm[2], nearm[1]
                from .decoder import _clamp_mv, _predict_inter
                mv_nearest = _clamp_mv(nearm[1], *bounds)
                mv_near = _clamp_mv(nearm[2], *bounds)
                near_index = 1 if cnt2[1] >= cnt2[0] else 0
                best_ref = _clamp_mv(nearm[near_index], *bounds)

                y0, x0 = BY + r * 16, BY + c * 16
                src16 = ysrc[r * 16:r * 16 + 16,
                             c * 16:c * 16 + 16].astype(np.int64)

                def mv_sad(mv):
                    pred = _predict_inter(refY, y0, x0, mv, 16, 16, True)
                    return int(np.abs(src16 - pred.astype(np.int64)).sum())

                cands = [(ZEROMV, (0, 0), mv_sad((0, 0)))]
                if mv_nearest != (0, 0):
                    cands.append((NEARESTMV, mv_nearest,
                                  mv_sad(mv_nearest) + 96))
                if mv_near not in ((0, 0), mv_nearest):
                    cands.append((NEARMV, mv_near, mv_sad(mv_near) + 160))
                mv_new, new_sad = self._search_newmv(
                    ysrc, refY, r, c, best_ref, bounds)
                # NEWMV residual components must fit the 10-bit coder
                if mv_new not in ((0, 0), mv_nearest, mv_near) \
                        and abs((mv_new[0] - best_ref[0]) >> 1) < 1024 \
                        and abs((mv_new[1] - best_ref[1]) >> 1) < 1024:
                    cands.append((NEWMV, mv_new, new_sad + 320))
                mb_mode, mb_mv, _ = min(cands, key=lambda t: t[2])

                cy, cx = BC + r * 8, BC + c * 8
                if mb_mode == ZEROMV:
                    predY = refY[y0:y0 + 16, x0:x0 + 16]
                    predU = refU[cy:cy + 8, cx:cx + 8]
                    predV = refV[cy:cy + 8, cx:cx + 8]
                else:
                    # prediction + chroma MV derivation mirror
                    # _recon_inter_mb's non-split path exactly
                    # (decoder:1034-1048; rounded halving, no fp mask)
                    from .decoder import _trunc_div
                    predY = _predict_inter(refY, y0, x0, mb_mv, 16, 16,
                                           True)
                    uvr = _trunc_div(mb_mv[0]
                                     + (1 if mb_mv[0] >= 0 else -1), 2)
                    uvc = _trunc_div(mb_mv[1]
                                     + (1 if mb_mv[1] >= 0 else -1), 2)
                    predU = _predict_inter(refU, cy, cx, (uvr, uvc),
                                           8, 8, True)
                    predV = _predict_inter(refV, cy, cx, (uvr, uvc),
                                           8, 8, True)
                coeffs, eobs, skip = self._code_mb_residual(
                    hdr, ysrc, usrc, vsrc, Y, U, V, r, c, mb_mode, 0,
                    predY, predU, predV)
                # every candidate is inside the UMV bounds by
                # construction, so the decoder's NEWMV clamp check
                # (decoder:641-644) always comes out False
                clamp_arr[r, c] = False
                mi = dict(ref_frame=ref_frame, mode=mode_arr, mvs=mvs,
                          bmvs=np.zeros((mr, mc, 16, 2), np.int32),
                          clamp=clamp_arr)
                ref_frame[r + 1, c + 1] = LAST
                mode_arr[r + 1, c + 1] = mb_mode
                mvs[r + 1, c + 1] = mb_mv
                loop.hdr = hdr
                loop._recon_inter_mb(Y, U, V, hdr, mi, r, c, mb_mode, 0,
                                     bool(skip),
                                     coeffs.astype(np.int32), eobs,
                                     True, ~0)
                mbs.append((dict(cnt=cnt, cnt2=cnt2, mode=mb_mode,
                                 mv=mb_mv, best_ref=best_ref),
                            coeffs, eobs, skip))
            y0r, y1r = BY + r * 16, BY + (r + 1) * 16
            Y[y0r:y1r, BY + mc * 16:] = Y[y0r:y1r,
                                          BY + mc * 16 - 1:BY + mc * 16]
            c0, c1 = BC + r * 8, BC + (r + 1) * 8
            U[c0:c1, BC + mc * 8:] = U[c0:c1, BC + mc * 8 - 1:BC + mc * 8]
            V[c0:c1, BC + mc * 8:] = V[c0:c1, BC + mc * 8 - 1:BC + mc * 8]

        nskip = sum(1 for mb in mbs if mb[3])
        hdr.prob_skip_false = int(np.clip(
            256 - (256 * nskip) // max(len(mbs), 1), 1, 255))
        hdr.prob_intra = 1      # P(intra bit reads 1=inter) high
        hdr.prob_last = 255     # always LAST: read gives 0
        hdr.prob_gf = 128

        bc1 = BoolEncoder(marker=False)
        self._write_common_header(bc1, hdr, False)
        bc1.write_literal(hdr.prob_intra, 8)
        bc1.write_literal(hdr.prob_last, 8)
        bc1.write_literal(hdr.prob_gf, 8)
        bc1.write_bit(0)           # no ymode prob update
        bc1.write_bit(0)           # no uvmode prob update
        for comp in range(2):      # no MV context updates
            up = T.MV_UPDATE_PROBS[comp][0]
            for i in range(19):
                bc1.write(0, up[i])
        for (info, _, _, skip) in mbs:
            bc1.write(1 if skip else 0, hdr.prob_skip_false)
            bc1.write(1, hdr.prob_intra)       # inter MB
            bc1.write(0, hdr.prob_last)        # ref = LAST
            cnt, cnt2 = info["cnt"], info["cnt2"]
            mode = info["mode"]
            if mode == ZEROMV:
                bc1.write(0, T.MODE_CONTEXTS[cnt[0]][0])
                continue
            bc1.write(1, T.MODE_CONTEXTS[cnt[0]][0])
            if mode == NEARESTMV:
                bc1.write(0, T.MODE_CONTEXTS[cnt2[1]][1])
                continue
            bc1.write(1, T.MODE_CONTEXTS[cnt2[1]][1])
            if mode == NEARMV:
                bc1.write(0, T.MODE_CONTEXTS[cnt2[2]][2])
                continue
            bc1.write(1, T.MODE_CONTEXTS[cnt2[2]][2])
            # NEWMV (never SPLITMV: cnt[3] context is the neighbors'
            # SPLITMV count, which this encoder never codes -> 0)
            bc1.write(0, T.MODE_CONTEXTS[0][3])
            self._write_mv(bc1, info["mv"], info["best_ref"])
        first_part = bc1.stop()

        bc2 = BoolEncoder(marker=False)
        above_ctx = np.zeros((mc, 9), np.int32)
        k = 0
        for r in range(mr):
            left_ctx = np.zeros(9, np.int32)
            for c in range(mc):
                (_, coeffs, eobs, skip) = mbs[k]
                k += 1
                self._emit_mb_tokens(bc2, probs, above_ctx[c], left_ctx,
                                     coeffs, eobs, skip, True)
        tokens = bc2.stop()

        self._finish_frame(hdr, Y, U, V, mr, mc)
        return self._assemble(hdr, False, first_part, tokens,
                              self.W, self.H)

    # ----------------------------------------------------------- refs

    def _finish_frame(self, hdr, Y, U, V, mr, mc, mb_mode=None,
                      mb_skip_lf=None, lf_refs_val=INTRA):
        """Loop filter + border extension + reference update, all via
        the decoder's own normative routines."""
        loop = self._loop
        loop.mb_rows, loop.mb_cols = mr, mc
        loop.seg_map = np.zeros((mr, mc), np.int32)
        if hdr.filter_level:
            loop._lf_refs = np.full((mr, mc), lf_refs_val, np.int32)
            if mb_mode is None:
                mb_mode = np.zeros((mr, mc), np.int32)
            if mb_skip_lf is None:
                mb_skip_lf = np.zeros((mr, mc), bool)
            loop._loop_filter(Y, U, V, hdr, mb_mode, mb_skip_lf,
                              mc * 16, mr * 16)
        Vp8Decoder._extend_borders(Y, U, V, mc * 16, mr * 16)
        frame = (Y, U, V)
        if hdr.refresh_last:
            self.refs[LAST] = frame
        if hdr.refresh_golden:
            self.refs[GOLDEN] = frame
        if hdr.refresh_alt:
            self.refs[ALTREF] = frame
