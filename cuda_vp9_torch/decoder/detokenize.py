"""Transform-coefficient token decode.

Parity with vp9/decoder/vp9_detokenize.c (decode_coefs:115,
vp9_decode_block_tokens:274): model-based coef probabilities with the
pareto-tail table, token cache of energy classes for neighbor contexts,
per-edge context masking, and dequantization during decode.

The port parses with the C++ parser (native/); this module is here for
the encoder (encoder/), whose symbol contexts come from the parse side.
"""

from __future__ import annotations

import numpy as np

from .. import models as M
from . import constants as C

_PARETO = M.PARETO8_FULL.tolist()
_CAT_PROBS = [p.tolist() for p in M.CAT_PROBS]
_CAT6_HIGH12 = M.CAT6_PROB_HIGH12.tolist()
_BAND_4X4 = M.COEFBAND_4X4.tolist()
_BAND_8X8PLUS = M.COEFBAND_8X8PLUS.tolist()

_INT32_MIN, _INT32_WRAP = -(1 << 31), 1 << 32


def _wrap32(v: int) -> int:
    v &= _INT32_WRAP - 1
    return v - _INT32_WRAP if v >= (1 << 31) else v


def decode_coefs(r, coef_probs, counts_coef, counts_eob, plane_type, ref,
                 dqcoeff, tx_size, dq, ctx, scan, nb, bit_depth):
    """Decode one transform block's tokens into `dqcoeff` (int32 ndarray).

    `coef_probs` is fc.coef[tx_size][plane_type][ref] as nested python lists;
    counts_* may be None.  Returns eob.
    """
    max_eob = 16 << (tx_size << 1)
    band_translate = _BAND_4X4 if tx_size == C.TX_4X4 else _BAND_8X8PLUS
    dq_shift = 1 if tx_size == C.TX_32X32 else 0
    if bit_depth == 12:
        cat6_prob, cat6_bits = _CAT6_HIGH12, 18
    elif bit_depth == 10:
        cat6_prob, cat6_bits = _CAT6_HIGH12[2:], 16
    else:
        cat6_prob, cat6_bits = _CAT_PROBS[5], 14
    token_cache = [0] * max_eob
    read = r.read
    dqv = dq[0]
    c = 0
    bt_idx = 0
    while c < max_eob:
        band = band_translate[bt_idx]
        bt_idx += 1
        prob = coef_probs[band][ctx]
        if counts_eob is not None:
            counts_eob[band][ctx] += 1
        if not read(prob[0]):  # EOB_CONTEXT_NODE
            if counts_coef is not None:
                counts_coef[band][ctx][3] += 1  # EOB_MODEL_TOKEN
            break
        while not read(prob[1]):  # ZERO_CONTEXT_NODE
            if counts_coef is not None:
                counts_coef[band][ctx][0] += 1
            dqv = dq[1]
            token_cache[scan[c]] = 0
            c += 1
            if c >= max_eob:
                return c
            ctx = (1 + token_cache[nb[2 * c]] + token_cache[nb[2 * c + 1]]) >> 1
            band = band_translate[bt_idx]
            bt_idx += 1
            prob = coef_probs[band][ctx]

        if read(prob[2]):  # ONE_CONTEXT_NODE: token >= 2
            p = _PARETO[prob[2] - 1]
            if counts_coef is not None:
                counts_coef[band][ctx][2] += 1
            if read(p[0]):
                if read(p[3]):
                    token_cache[scan[c]] = 5
                    if read(p[5]):
                        if read(p[7]):
                            val = C.CAT6_MIN_VAL + _read_coeff(
                                read, cat6_prob, cat6_bits)
                        else:
                            val = C.CAT5_MIN_VAL + _read_coeff(
                                read, _CAT_PROBS[4], 5)
                    elif read(p[6]):
                        val = C.CAT4_MIN_VAL + _read_coeff(
                            read, _CAT_PROBS[3], 4)
                    else:
                        val = C.CAT3_MIN_VAL + _read_coeff(
                            read, _CAT_PROBS[2], 3)
                else:
                    token_cache[scan[c]] = 4
                    if read(p[4]):
                        val = C.CAT2_MIN_VAL + _read_coeff(
                            read, _CAT_PROBS[1], 2)
                    else:
                        val = C.CAT1_MIN_VAL + _read_coeff(
                            read, _CAT_PROBS[0], 1)
                v = (val * dqv) >> dq_shift
            else:
                if read(p[1]):
                    token_cache[scan[c]] = 3
                    v = ((3 + read(p[2])) * dqv) >> dq_shift
                else:
                    token_cache[scan[c]] = 2
                    v = (2 * dqv) >> dq_shift
        else:
            if counts_coef is not None:
                counts_coef[band][ctx][1] += 1
            token_cache[scan[c]] = 1
            v = dqv >> dq_shift
        dqcoeff[scan[c]] = _wrap32(-v if read(128) else v)
        c += 1
        ctx = (1 + token_cache[nb[2 * c]] + token_cache[nb[2 * c + 1]]) >> 1
        dqv = dq[1]
    return c


def _read_coeff(read, probs, n):
    val = 0
    for i in range(n):
        val = (val << 1) | read(probs[i])
    return val
