"""Transform-coefficient token encoding.

Encoder-side mirror of `decoder/detokenize.py` (decode_coefs), with
capability parity to vp9/encoder/vp9_tokenize.c + the pack step of
vp9_bitstream.c (pack_mb_tokens).  Symbols and probabilities match the
decode tree exactly: EOB / ZERO / ONE nodes from the frame-context coef
probs, the ≥2 tail from the Pareto table keyed by the ONE-node prob,
then category extra bits and a sign bit at prob 128.

Quantization happens here too: `quantize_block` maps float forward-
transform coefficients to quantized levels `val` such that the decoder's
dequant `(val * dq) >> dq_shift` best approximates the coefficient.
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from ..decoder import constants as C

_PARETO = M.PARETO8_FULL.tolist()
_CAT_PROBS = [p.tolist() for p in M.CAT_PROBS]
_CAT6_HIGH12 = M.CAT6_PROB_HIGH12.tolist()
_BAND_4X4 = M.COEFBAND_4X4.tolist()
_BAND_8X8PLUS = M.COEFBAND_8X8PLUS.tolist()

# energy class written into the token cache per token (decode_coefs parity)
_CAT_MINS = (C.CAT1_MIN_VAL, C.CAT2_MIN_VAL, C.CAT3_MIN_VAL,
             C.CAT4_MIN_VAL, C.CAT5_MIN_VAL, C.CAT6_MIN_VAL)


def quantize_block(coeffs_f: np.ndarray, dq_dc: int, dq_ac: int,
                   tx_size: int, bd: int) -> np.ndarray:
    """Quantize float coefficients to levels the decoder dequants back.

    Decoder dequant: v = (val * dq) >> dq_shift  (dq_shift=1 for TX_32X32,
    detokenize.decode_coefs:39).  Uses round-to-nearest with a mild
    deadzone on AC terms (fraction 0.45) like libvpx's quantizer rounding.
    Returns int32 levels with sign, clamped to the category-6 range.
    """
    dq_shift = 1 if tx_size == C.TX_32X32 else 0
    scale = 1 << dq_shift
    dq = np.full(coeffs_f.shape[-1], float(dq_ac))
    dq[0] = float(dq_dc)
    mag = np.abs(coeffs_f) * scale / dq
    levels = np.floor(mag + 0.45).astype(np.int64)
    # category 6 extra-bit budget bounds the codable magnitude
    cat6_bits = {8: 14, 10: 16, 12: 18}[bd]
    vmax = C.CAT6_MIN_VAL + (1 << cat6_bits) - 1
    np.clip(levels, 0, vmax, out=levels)
    return (np.sign(coeffs_f) * levels).astype(np.int32)


def encode_coefs(w, coef_probs, levels, tx_size: int, ctx: int,
                 scan, nb, bit_depth: int) -> int:
    """Write one transform block's tokens; mirror of decode_coefs.

    `levels` are signed quantized values in natural (raster) order;
    `scan`/`nb` are the scan order and neighbor lists.  Returns eob.
    """
    max_eob = 16 << (tx_size << 1)
    band_translate = _BAND_4X4 if tx_size == C.TX_4X4 else _BAND_8X8PLUS
    if bit_depth == 12:
        cat6_prob, cat6_bits = _CAT6_HIGH12, 18
    elif bit_depth == 10:
        cat6_prob, cat6_bits = _CAT6_HIGH12[2:], 16
    else:
        cat6_prob, cat6_bits = _CAT_PROBS[5], 14

    # eob = 1 + index of last nonzero scan position
    eob = 0
    for i in range(max_eob):
        if levels[scan[i]]:
            eob = i + 1
    if eob == 0:
        # empty block: a lone EOB token at position 0
        band = band_translate[0]
        w.write(0, coef_probs[band][ctx][0])
        return 0

    token_cache = [0] * max_eob
    write = w.write
    c = 0
    bt_idx = 0
    while c < max_eob:
        band = band_translate[bt_idx]
        bt_idx += 1
        prob = coef_probs[band][ctx]
        if c >= eob:
            write(0, prob[0])  # EOB
            break
        write(1, prob[0])  # more coefficients follow

        # run of zeros up to the next nonzero
        v = int(levels[scan[c]])
        while v == 0:
            write(0, prob[1])
            token_cache[scan[c]] = 0
            c += 1
            # c < eob guaranteed: eob position is nonzero
            ctx = (1 + token_cache[nb[2 * c]] + token_cache[nb[2 * c + 1]]) >> 1
            band = band_translate[bt_idx]
            bt_idx += 1
            prob = coef_probs[band][ctx]
            v = int(levels[scan[c]])
        write(1, prob[1])

        mag = abs(v)
        if mag == 1:
            write(0, prob[2])
            token_cache[scan[c]] = 1
        else:
            write(1, prob[2])
            p = _PARETO[prob[2] - 1]
            if mag <= 4:
                write(0, p[0])
                if mag == 2:
                    write(0, p[1])
                    token_cache[scan[c]] = 2
                else:
                    write(1, p[1])
                    write(mag - 3, p[2])
                    token_cache[scan[c]] = 3
            else:
                write(1, p[0])
                if mag < C.CAT3_MIN_VAL:  # CAT1 / CAT2
                    write(0, p[3])
                    token_cache[scan[c]] = 4
                    if mag < C.CAT2_MIN_VAL:
                        write(0, p[4])
                        _write_extra(write, _CAT_PROBS[0], 1,
                                     mag - C.CAT1_MIN_VAL)
                    else:
                        write(1, p[4])
                        _write_extra(write, _CAT_PROBS[1], 2,
                                     mag - C.CAT2_MIN_VAL)
                else:
                    write(1, p[3])
                    token_cache[scan[c]] = 5
                    if mag < C.CAT5_MIN_VAL:  # CAT3 / CAT4
                        write(0, p[5])
                        if mag < C.CAT4_MIN_VAL:
                            write(0, p[6])
                            _write_extra(write, _CAT_PROBS[2], 3,
                                         mag - C.CAT3_MIN_VAL)
                        else:
                            write(1, p[6])
                            _write_extra(write, _CAT_PROBS[3], 4,
                                         mag - C.CAT4_MIN_VAL)
                    else:
                        write(1, p[5])
                        if mag < C.CAT6_MIN_VAL:  # CAT5
                            write(0, p[7])
                            _write_extra(write, _CAT_PROBS[4], 5,
                                         mag - C.CAT5_MIN_VAL)
                        else:
                            write(1, p[7])
                            _write_extra(write, cat6_prob, cat6_bits,
                                         mag - C.CAT6_MIN_VAL)
        write(1 if v < 0 else 0, 128)  # sign
        c += 1
        if c < max_eob:
            ctx = (1 + token_cache[nb[2 * c]] + token_cache[nb[2 * c + 1]]) >> 1
    return eob


def _write_extra(write, probs, n: int, val: int) -> None:
    for i in range(n):
        write((val >> (n - 1 - i)) & 1, probs[i])
