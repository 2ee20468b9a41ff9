"""VP9 compressed header: forward probability updates.

Parity with `read_compressed_header` (vp9/decoder/vp9_decodeframe.c:3340),
`vp9_diff_update_prob` / subexponential delta decode (vp9/decoder/
vp9_dsubexp.c), `read_coef_probs` / `read_mv_probs` (vp9/decoder/
vp9_decodemv.c is separate; mv prob updates live here per spec §6.3).

The port parses with the C++ parser (native/); this module is here for
the encoder (encoder/), whose symbol contexts come from the parse side.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import models as M
from . import constants as C
from .bitreader import BoolDecoder
from .headers import BitstreamError, FrameHeader

_INV_MAP = M.INV_MAP_TABLE


def _inv_recenter_nonneg(v: int, m: int) -> int:
    if v > 2 * m:
        return v
    return m - ((v + 1) >> 1) if (v & 1) else m + (v >> 1)


def _decode_uniform(r: BoolDecoder) -> int:
    m = (1 << 8) - 191
    v = r.read_literal(7)
    return v if v < m else (v << 1) - m + r.read_bit()


def _decode_term_subexp(r: BoolDecoder) -> int:
    if not r.read_bit():
        return r.read_literal(4)
    if not r.read_bit():
        return r.read_literal(4) + 16
    if not r.read_bit():
        return r.read_literal(5) + 32
    return _decode_uniform(r) + 64


def _inv_remap_prob(v: int, m: int) -> int:
    v = int(_INV_MAP[v])
    m -= 1
    if (m << 1) <= C.MAX_PROB:
        return 1 + _inv_recenter_nonneg(v, m)
    return C.MAX_PROB - _inv_recenter_nonneg(v, C.MAX_PROB - 1 - m)


def diff_update_prob(r: BoolDecoder, arr, idx) -> None:
    if r.read(C.DIFF_UPDATE_PROB):
        delp = _decode_term_subexp(r)
        arr[idx] = _inv_remap_prob(delp, int(arr[idx]))


def _update_mv_prob(r: BoolDecoder, arr, idx) -> None:
    if r.read(C.MV_UPDATE_PROB):
        arr[idx] = (r.read_literal(7) << 1) | 1


@dataclass
class CompressedHeader:
    tx_mode: int = C.ONLY_4X4
    reference_mode: int = C.SINGLE_REFERENCE
    comp_fixed_ref: int = C.ALTREF_FRAME
    comp_var_ref: tuple = (C.LAST_FRAME, C.GOLDEN_FRAME)
    allow_comp_inter_inter: bool = False


def _read_tx_mode(r: BoolDecoder) -> int:
    tx_mode = r.read_literal(2)
    if tx_mode == C.ALLOW_32X32:
        tx_mode += r.read_bit()
    return tx_mode


def _read_tx_probs(r: BoolDecoder, fc: M.FrameContext):
    for i in range(C.TX_SIZE_CONTEXTS):
        for j in range(1):
            diff_update_prob(r, fc.tx8, (i, j))
    for i in range(C.TX_SIZE_CONTEXTS):
        for j in range(2):
            diff_update_prob(r, fc.tx16, (i, j))
    for i in range(C.TX_SIZE_CONTEXTS):
        for j in range(3):
            diff_update_prob(r, fc.tx32, (i, j))


def _read_coef_probs(r: BoolDecoder, fc: M.FrameContext, tx_mode: int):
    max_tx_size = int(M.TX_MODE_TO_BIGGEST_TX_SIZE[tx_mode])
    for tx_size in range(max_tx_size + 1):
        if r.read_bit():
            probs = fc.coef[tx_size]
            for i in range(C.PLANE_TYPES):
                for j in range(C.REF_TYPES):
                    for k in range(C.COEF_BANDS):
                        for l in range(3 if k == 0 else C.COEFF_CONTEXTS):
                            for m in range(C.UNCONSTRAINED_NODES):
                                diff_update_prob(r, probs, (i, j, k, l, m))


def _is_compound_reference_allowed(hdr: FrameHeader) -> bool:
    sb = hdr.ref_frame_sign_bias
    for i in range(1, C.REFS_PER_FRAME):
        if sb[i + 1] != sb[1]:
            return True
    return False


def _setup_compound_reference_mode(hdr: FrameHeader, ch: CompressedHeader):
    sb = hdr.ref_frame_sign_bias
    if sb[C.LAST_FRAME] == sb[C.GOLDEN_FRAME]:
        ch.comp_fixed_ref = C.ALTREF_FRAME
        ch.comp_var_ref = (C.LAST_FRAME, C.GOLDEN_FRAME)
    elif sb[C.LAST_FRAME] == sb[C.ALTREF_FRAME]:
        ch.comp_fixed_ref = C.GOLDEN_FRAME
        ch.comp_var_ref = (C.LAST_FRAME, C.ALTREF_FRAME)
    else:
        ch.comp_fixed_ref = C.LAST_FRAME
        ch.comp_var_ref = (C.GOLDEN_FRAME, C.ALTREF_FRAME)


def _read_frame_reference_mode(hdr: FrameHeader, r: BoolDecoder,
                               ch: CompressedHeader) -> int:
    ch.allow_comp_inter_inter = _is_compound_reference_allowed(hdr)
    if ch.allow_comp_inter_inter:
        if r.read_bit():
            return (C.REFERENCE_MODE_SELECT if r.read_bit()
                    else C.COMPOUND_REFERENCE)
        return C.SINGLE_REFERENCE
    return C.SINGLE_REFERENCE


def _read_frame_reference_mode_probs(r: BoolDecoder, fc: M.FrameContext,
                                     mode: int):
    if mode == C.REFERENCE_MODE_SELECT:
        for i in range(C.COMP_INTER_CONTEXTS):
            diff_update_prob(r, fc.comp_inter, i)
    if mode != C.COMPOUND_REFERENCE:
        for i in range(C.REF_CONTEXTS):
            diff_update_prob(r, fc.single_ref, (i, 0))
            diff_update_prob(r, fc.single_ref, (i, 1))
    if mode != C.SINGLE_REFERENCE:
        for i in range(C.REF_CONTEXTS):
            diff_update_prob(r, fc.comp_ref, i)


def _read_mv_probs(r: BoolDecoder, fc: M.FrameContext, allow_hp: int):
    for j in range(C.MV_JOINTS - 1):
        _update_mv_prob(r, fc.mv_joints, j)
    for i in range(2):
        _update_mv_prob(r, fc.mv_sign, i)
        for j in range(C.MV_CLASSES - 1):
            _update_mv_prob(r, fc.mv_classes, (i, j))
        for j in range(C.CLASS0_SIZE - 1):
            _update_mv_prob(r, fc.mv_class0, (i, j))
        for j in range(C.MV_OFFSET_BITS):
            _update_mv_prob(r, fc.mv_bits, (i, j))
    for i in range(2):
        for j in range(C.CLASS0_SIZE):
            for k in range(C.MV_FP_SIZE - 1):
                _update_mv_prob(r, fc.mv_class0_fp, (i, j, k))
        for j in range(C.MV_FP_SIZE - 1):
            _update_mv_prob(r, fc.mv_fp, (i, j))
    if allow_hp:
        for i in range(2):
            _update_mv_prob(r, fc.mv_class0_hp, i)
            _update_mv_prob(r, fc.mv_hp, i)


def read_compressed_header(data, hdr: FrameHeader,
                           fc: M.FrameContext) -> CompressedHeader:
    """Parse the compressed header span; mutates `fc` probabilities."""
    off = hdr.uncompressed_header_size_in_bytes
    size = hdr.header_size_in_bytes
    if off + size > len(data):
        raise BitstreamError("compressed header overruns frame")
    r = BoolDecoder(data, off, size)
    ch = CompressedHeader()
    ch.tx_mode = C.ONLY_4X4 if hdr.lossless else _read_tx_mode(r)
    if ch.tx_mode == C.TX_MODE_SELECT:
        _read_tx_probs(r, fc)
    _read_coef_probs(r, fc, ch.tx_mode)
    for i in range(C.SKIP_CONTEXTS):
        diff_update_prob(r, fc.skip, i)
    if not hdr.frame_is_intra_only:
        for i in range(C.INTER_MODE_CONTEXTS):
            for j in range(C.INTER_MODES - 1):
                diff_update_prob(r, fc.inter_mode, (i, j))
        if hdr.interp_filter == C.SWITCHABLE:
            for i in range(C.SWITCHABLE_FILTER_CONTEXTS):
                for j in range(C.SWITCHABLE_FILTERS - 1):
                    diff_update_prob(r, fc.switchable_interp, (i, j))
        for i in range(C.INTRA_INTER_CONTEXTS):
            diff_update_prob(r, fc.intra_inter, i)
        ch.reference_mode = _read_frame_reference_mode(hdr, r, ch)
        if ch.allow_comp_inter_inter:
            _setup_compound_reference_mode(hdr, ch)
        _read_frame_reference_mode_probs(r, fc, ch.reference_mode)
        for i in range(C.BLOCK_SIZE_GROUPS):
            for j in range(C.INTRA_MODES - 1):
                diff_update_prob(r, fc.y_mode, (i, j))
        for i in range(C.PARTITION_CONTEXTS):
            for j in range(C.PARTITION_TYPES - 1):
                diff_update_prob(r, fc.partition, (i, j))
        _read_mv_probs(r, fc, hdr.allow_high_precision_mv)
    if r.has_error():
        raise BitstreamError("truncated compressed header")
    return ch
