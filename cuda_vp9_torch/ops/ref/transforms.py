"""Bit-exact inverse transforms (DCT/ADST/WHT 4..32), batched in NumPy.

Oracle implementations of the normative integer transforms
(vpx_dsp/inv_txfm.c: idct4_c:133, idct8_c:271, idct16_c:557, idct32_c:813,
iadst4_c:96, iadst8_c:196, iadst16_c:389, vpx_iwht4x4_16_add_c:18; 2-D
wrappers vp9/common/vp9_idct.c vp9_iht*).  All arithmetic is int64 with the
normative WRAPLOW points: int16 wrapping for the 8-bit path,
(bd+8)-bit wrapping for the high-bit-depth path.

Every function operates on a batch: input [N, n] (1-D) or [N, n, n] (2-D).
The 2-D entry returns the *residual* block after the final round shift;
callers add it to prediction with pixel clipping (clip_pixel_add).
"""

from __future__ import annotations

import numpy as np

# cosine/sine constants (vpx_dsp/txfm_common.h — normative)
COSPI = [16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137,
         14811, 14449, 14053, 13623, 13160, 12665, 12140, 11585, 11003,
         10394, 9760, 9102, 8423, 7723, 7005, 6270, 5520, 4756, 3981,
         3196, 2404, 1606, 804]
SINPI = [0, 5283, 9929, 13377, 15212]


def _c(i):
    return COSPI[i]


def make_wrap(bd: int):
    if bd == 8:
        def wrap(x):
            return ((x + 0x8000) & 0xFFFF) - 0x8000
    else:
        m = 1 << (bd + 7)

        def wrap(x):
            return ((x + m) & (2 * m - 1)) - m
    return wrap


def _rs(x):
    """dct_const_round_shift."""
    return (x + 8192) >> 14


class _EmulatedDomain:
    """WRAPLOW carried in wide ints via explicit masking (the oracle /
    high-bit-depth path; numerically identical to the pre-domain code).

    Narrow values are ints with |v| < 2^(bd+7) invariants maintained by
    n(); wide values are unbounded intermediates (pre-multiply sums,
    product accumulators)."""

    def __init__(self, wrap):
        self._wrap = wrap

    def w(self, x):          # narrow -> wide (no-op: same representation)
        return x

    def n(self, x):          # wrap a narrow-domain add/sub/neg result
        return self._wrap(x)

    def rs(self, x):         # wrap(dct_const_round_shift(wide))
        return self._wrap(_rs(x))


class _Native16Domain:
    """WRAPLOW as native int16 arithmetic (bd=8 device path).

    Narrow values are int16 tensors: adds/subs/negates wrap natively
    (modular arithmetic composes, so chained int16 adds equal the
    reference's single WRAPLOW of the exact sum).  Multiplies widen to
    int32 via w(); rs() rounds and truncates back to int16 (the
    truncating cast IS the WRAPLOW).  ~3x fewer HLO ops than the
    emulated masking on the capacity-sized butterfly chains."""

    def __init__(self, wide_dtype, narrow_dtype):
        self._wd = wide_dtype
        self._nd = narrow_dtype

    def w(self, x):
        return x.astype(self._wd)

    def n(self, x):
        return x            # int16 ops already wrapped

    def rs(self, x):
        return ((x + 8192) >> 14).astype(self._nd)


def _make_domain(bd: int, work_dtype):
    """(D, cast_in, no_cast, wide, work_dtype) for a transform run.

    work_dtype int16 (bd=8 only) selects the native-int16 WRAPLOW domain
    (device fast path); anything else uses the emulated masking domain
    (oracle / high bit depth).  `wide` is the dtype the final 2-D round
    shift must widen to in the native domain (None = no widening)."""
    if work_dtype is None:
        work_dtype = np.int64
    if np.dtype(work_dtype) == np.int16:
        assert bd == 8, "native int16 domain is 8-bit only"
        D = _Native16Domain(np.int32, np.int16)

        def cast_in(x):   # inputs are int16 already
            return x
        return D, cast_in, cast_in, np.int32, work_dtype
    wrap = make_wrap(bd)
    D = _EmulatedDomain(wrap)
    if bd == 8:
        def cast_in(x):
            return ((x + 0x8000) & 0xFFFF) - 0x8000
    else:
        def cast_in(x):
            return x

    # iadst reads inputs without the int16 cast even in the 8-bit path
    def no_cast(x):
        return x
    return D, cast_in, no_cast, None, work_dtype


def idct4(inp, D, cast_in, xp=np):
    i0, i1, i2, i3 = (cast_in(inp[:, k]) for k in range(4))
    s0 = D.rs((D.w(i0) + D.w(i2)) * _c(16))
    s1 = D.rs((D.w(i0) - D.w(i2)) * _c(16))
    s2 = D.rs(D.w(i1) * _c(24) - D.w(i3) * _c(8))
    s3 = D.rs(D.w(i1) * _c(8) + D.w(i3) * _c(24))
    return xp.stack([D.n(s0 + s3), D.n(s1 + s2),
                     D.n(s1 - s2), D.n(s0 - s3)], axis=1)


def iadst4(inp, D, cast_in, xp=np):
    x0, x1, x2, x3 = (inp[:, k] for k in range(4))
    s0 = SINPI[1] * D.w(x0)
    s1 = SINPI[2] * D.w(x0)
    s2 = SINPI[3] * D.w(x1)
    s3 = SINPI[4] * D.w(x2)
    s4 = SINPI[1] * D.w(x2)
    s5 = SINPI[2] * D.w(x3)
    s6 = SINPI[4] * D.w(x3)
    s7 = D.n(x0 - x2 + x3)
    s0 = s0 + s3 + s5
    s1 = s1 - s4 - s6
    s3b = s2
    s2b = SINPI[3] * D.w(s7)
    return xp.stack([D.rs(s0 + s3b), D.rs(s1 + s3b),
                     D.rs(s2b), D.rs(s0 + s1 - s3b)], axis=1)


def idct8(inp, D, cast_in, xp=np):
    i = [cast_in(inp[:, k]) for k in range(8)]
    # stage 1
    s1_0, s1_2, s1_1, s1_3 = i[0], i[4], i[2], i[6]
    s1_4 = D.rs(D.w(i[1]) * _c(28) - D.w(i[7]) * _c(4))
    s1_7 = D.rs(D.w(i[1]) * _c(4) + D.w(i[7]) * _c(28))
    s1_5 = D.rs(D.w(i[5]) * _c(12) - D.w(i[3]) * _c(20))
    s1_6 = D.rs(D.w(i[5]) * _c(20) + D.w(i[3]) * _c(12))
    # stage 2
    s2_0 = D.rs((D.w(s1_0) + D.w(s1_2)) * _c(16))
    s2_1 = D.rs((D.w(s1_0) - D.w(s1_2)) * _c(16))
    s2_2 = D.rs(D.w(s1_1) * _c(24) - D.w(s1_3) * _c(8))
    s2_3 = D.rs(D.w(s1_1) * _c(8) + D.w(s1_3) * _c(24))
    s2_4 = D.n(s1_4 + s1_5)
    s2_5 = D.n(s1_4 - s1_5)
    s2_6 = D.n(-s1_6 + s1_7)
    s2_7 = D.n(s1_6 + s1_7)
    # stage 3
    t0 = D.n(s2_0 + s2_3)
    t1 = D.n(s2_1 + s2_2)
    t2 = D.n(s2_1 - s2_2)
    t3 = D.n(s2_0 - s2_3)
    t4 = s2_4
    t5 = D.rs((D.w(s2_6) - D.w(s2_5)) * _c(16))
    t6 = D.rs((D.w(s2_5) + D.w(s2_6)) * _c(16))
    t7 = s2_7
    return xp.stack([D.n(t0 + t7), D.n(t1 + t6), D.n(t2 + t5),
                     D.n(t3 + t4), D.n(t3 - t4), D.n(t2 - t5),
                     D.n(t1 - t6), D.n(t0 - t7)], axis=1)


def iadst8(inp, D, cast_in, xp=np):
    x = [inp[:, 7], inp[:, 0], inp[:, 5], inp[:, 2],
         inp[:, 3], inp[:, 4], inp[:, 1], inp[:, 6]]
    # stage 1
    xw = [D.w(v) for v in x]
    s0 = _c(2) * xw[0] + _c(30) * xw[1]
    s1 = _c(30) * xw[0] - _c(2) * xw[1]
    s2 = _c(10) * xw[2] + _c(22) * xw[3]
    s3 = _c(22) * xw[2] - _c(10) * xw[3]
    s4 = _c(18) * xw[4] + _c(14) * xw[5]
    s5 = _c(14) * xw[4] - _c(18) * xw[5]
    s6 = _c(26) * xw[6] + _c(6) * xw[7]
    s7 = _c(6) * xw[6] - _c(26) * xw[7]
    x0 = D.rs(s0 + s4)
    x1 = D.rs(s1 + s5)
    x2 = D.rs(s2 + s6)
    x3 = D.rs(s3 + s7)
    x4 = D.rs(s0 - s4)
    x5 = D.rs(s1 - s5)
    x6 = D.rs(s2 - s6)
    x7 = D.rs(s3 - s7)
    # stage 2
    s0, s1, s2, s3 = x0, x1, x2, x3
    s4 = _c(8) * D.w(x4) + _c(24) * D.w(x5)
    s5 = _c(24) * D.w(x4) - _c(8) * D.w(x5)
    s6 = -_c(24) * D.w(x6) + _c(8) * D.w(x7)
    s7 = _c(8) * D.w(x6) + _c(24) * D.w(x7)
    x0 = D.n(s0 + s2)
    x1 = D.n(s1 + s3)
    x2 = D.n(s0 - s2)
    x3 = D.n(s1 - s3)
    x4 = D.rs(s4 + s6)
    x5 = D.rs(s5 + s7)
    x6 = D.rs(s4 - s6)
    x7 = D.rs(s5 - s7)
    # stage 3
    s2 = _c(16) * (D.w(x2) + D.w(x3))
    s3 = _c(16) * (D.w(x2) - D.w(x3))
    s6 = _c(16) * (D.w(x6) + D.w(x7))
    s7 = _c(16) * (D.w(x6) - D.w(x7))
    x2 = D.rs(s2)
    x3 = D.rs(s3)
    x6 = D.rs(s6)
    x7 = D.rs(s7)
    return xp.stack([D.n(x0), D.n(-x4), D.n(x6), D.n(-x2),
                     D.n(x3), D.n(-x7), D.n(x5), D.n(-x1)], axis=1)


def idct16(inp, D, cast_in, xp=np):
    order = [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]
    s1 = [cast_in(inp[:, k]) for k in order]
    s2 = [None] * 16
    # stage 2
    s2[:8] = s1[:8]
    s2[8] = D.rs(D.w(s1[8]) * _c(30) - D.w(s1[15]) * _c(2))
    s2[15] = D.rs(D.w(s1[8]) * _c(2) + D.w(s1[15]) * _c(30))
    s2[9] = D.rs(D.w(s1[9]) * _c(14) - D.w(s1[14]) * _c(18))
    s2[14] = D.rs(D.w(s1[9]) * _c(18) + D.w(s1[14]) * _c(14))
    s2[10] = D.rs(D.w(s1[10]) * _c(22) - D.w(s1[13]) * _c(10))
    s2[13] = D.rs(D.w(s1[10]) * _c(10) + D.w(s1[13]) * _c(22))
    s2[11] = D.rs(D.w(s1[11]) * _c(6) - D.w(s1[12]) * _c(26))
    s2[12] = D.rs(D.w(s1[11]) * _c(26) + D.w(s1[12]) * _c(6))
    # stage 3
    t = [None] * 16
    t[:4] = s2[:4]
    t[4] = D.rs(D.w(s2[4]) * _c(28) - D.w(s2[7]) * _c(4))
    t[7] = D.rs(D.w(s2[4]) * _c(4) + D.w(s2[7]) * _c(28))
    t[5] = D.rs(D.w(s2[5]) * _c(12) - D.w(s2[6]) * _c(20))
    t[6] = D.rs(D.w(s2[5]) * _c(20) + D.w(s2[6]) * _c(12))
    t[8] = D.n(s2[8] + s2[9])
    t[9] = D.n(s2[8] - s2[9])
    t[10] = D.n(-s2[10] + s2[11])
    t[11] = D.n(s2[10] + s2[11])
    t[12] = D.n(s2[12] + s2[13])
    t[13] = D.n(s2[12] - s2[13])
    t[14] = D.n(-s2[14] + s2[15])
    t[15] = D.n(s2[14] + s2[15])
    # stage 4
    u = [None] * 16
    u[0] = D.rs((D.w(t[0]) + D.w(t[1])) * _c(16))
    u[1] = D.rs((D.w(t[0]) - D.w(t[1])) * _c(16))
    u[2] = D.rs(D.w(t[2]) * _c(24) - D.w(t[3]) * _c(8))
    u[3] = D.rs(D.w(t[2]) * _c(8) + D.w(t[3]) * _c(24))
    u[4] = D.n(t[4] + t[5])
    u[5] = D.n(t[4] - t[5])
    u[6] = D.n(-t[6] + t[7])
    u[7] = D.n(t[6] + t[7])
    u[8] = t[8]
    u[15] = t[15]
    u[9] = D.rs(-D.w(t[9]) * _c(8) + D.w(t[14]) * _c(24))
    u[14] = D.rs(D.w(t[9]) * _c(24) + D.w(t[14]) * _c(8))
    u[10] = D.rs(-D.w(t[10]) * _c(24) - D.w(t[13]) * _c(8))
    u[13] = D.rs(-D.w(t[10]) * _c(8) + D.w(t[13]) * _c(24))
    u[11] = t[11]
    u[12] = t[12]
    # stage 5
    v = [None] * 16
    v[0] = D.n(u[0] + u[3])
    v[1] = D.n(u[1] + u[2])
    v[2] = D.n(u[1] - u[2])
    v[3] = D.n(u[0] - u[3])
    v[4] = u[4]
    v[5] = D.rs((D.w(u[6]) - D.w(u[5])) * _c(16))
    v[6] = D.rs((D.w(u[5]) + D.w(u[6])) * _c(16))
    v[7] = u[7]
    v[8] = D.n(u[8] + u[11])
    v[9] = D.n(u[9] + u[10])
    v[10] = D.n(u[9] - u[10])
    v[11] = D.n(u[8] - u[11])
    v[12] = D.n(-u[12] + u[15])
    v[13] = D.n(-u[13] + u[14])
    v[14] = D.n(u[13] + u[14])
    v[15] = D.n(u[12] + u[15])
    # stage 6
    w = [None] * 16
    w[0] = D.n(v[0] + v[7])
    w[1] = D.n(v[1] + v[6])
    w[2] = D.n(v[2] + v[5])
    w[3] = D.n(v[3] + v[4])
    w[4] = D.n(v[3] - v[4])
    w[5] = D.n(v[2] - v[5])
    w[6] = D.n(v[1] - v[6])
    w[7] = D.n(v[0] - v[7])
    w[8] = v[8]
    w[9] = v[9]
    w[10] = D.rs((-D.w(v[10]) + D.w(v[13])) * _c(16))
    w[13] = D.rs((D.w(v[10]) + D.w(v[13])) * _c(16))
    w[11] = D.rs((-D.w(v[11]) + D.w(v[12])) * _c(16))
    w[12] = D.rs((D.w(v[11]) + D.w(v[12])) * _c(16))
    w[14] = v[14]
    w[15] = v[15]
    # stage 7
    out = [D.n(w[k] + w[15 - k]) for k in range(8)] + \
          [D.n(w[15 - k] - w[k]) for k in range(8, 16)]
    return xp.stack(out, axis=1)


def iadst16(inp, D, cast_in, xp=np):
    order = [15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14]
    x = [inp[:, k] for k in order]
    # stage 1
    cp = [(1, 31), (5, 27), (9, 23), (13, 19), (17, 15), (21, 11),
          (25, 7), (29, 3)]
    s = [None] * 16
    for k in range(8):
        a, b = cp[k]
        xa, xb = D.w(x[2 * k]), D.w(x[2 * k + 1])
        s[2 * k] = xa * _c(a) + xb * _c(b)
        s[2 * k + 1] = xa * _c(b) - xb * _c(a)
    for k in range(8):
        x[k] = D.rs(s[k] + s[k + 8])
        x[k + 8] = D.rs(s[k] - s[k + 8])
    # stage 2
    s[:8] = x[:8]
    s[8] = D.w(x[8]) * _c(4) + D.w(x[9]) * _c(28)
    s[9] = D.w(x[8]) * _c(28) - D.w(x[9]) * _c(4)
    s[10] = D.w(x[10]) * _c(20) + D.w(x[11]) * _c(12)
    s[11] = D.w(x[10]) * _c(12) - D.w(x[11]) * _c(20)
    s[12] = -D.w(x[12]) * _c(28) + D.w(x[13]) * _c(4)
    s[13] = D.w(x[12]) * _c(4) + D.w(x[13]) * _c(28)
    s[14] = -D.w(x[14]) * _c(12) + D.w(x[15]) * _c(20)
    s[15] = D.w(x[14]) * _c(20) + D.w(x[15]) * _c(12)
    for k in range(4):
        x[k] = D.n(s[k] + s[k + 4])
        x[k + 4] = D.n(s[k] - s[k + 4])
    for k in range(8, 12):
        x[k] = D.rs(s[k] + s[k + 4])
        x[k + 4] = D.rs(s[k] - s[k + 4])
    # stage 3
    s[:4] = x[:4]
    s[4] = D.w(x[4]) * _c(8) + D.w(x[5]) * _c(24)
    s[5] = D.w(x[4]) * _c(24) - D.w(x[5]) * _c(8)
    s[6] = -D.w(x[6]) * _c(24) + D.w(x[7]) * _c(8)
    s[7] = D.w(x[6]) * _c(8) + D.w(x[7]) * _c(24)
    s[8], s[9], s[10], s[11] = x[8], x[9], x[10], x[11]
    s[12] = D.w(x[12]) * _c(8) + D.w(x[13]) * _c(24)
    s[13] = D.w(x[12]) * _c(24) - D.w(x[13]) * _c(8)
    s[14] = -D.w(x[14]) * _c(24) + D.w(x[15]) * _c(8)
    s[15] = D.w(x[14]) * _c(8) + D.w(x[15]) * _c(24)
    x[0] = D.n(s[0] + s[2])
    x[1] = D.n(s[1] + s[3])
    x[2] = D.n(s[0] - s[2])
    x[3] = D.n(s[1] - s[3])
    x[4] = D.rs(s[4] + s[6])
    x[5] = D.rs(s[5] + s[7])
    x[6] = D.rs(s[4] - s[6])
    x[7] = D.rs(s[5] - s[7])
    x[8] = D.n(s[8] + s[10])
    x[9] = D.n(s[9] + s[11])
    x[10] = D.n(s[8] - s[10])
    x[11] = D.n(s[9] - s[11])
    x[12] = D.rs(s[12] + s[14])
    x[13] = D.rs(s[13] + s[15])
    x[14] = D.rs(s[12] - s[14])
    x[15] = D.rs(s[13] - s[15])
    # stage 4
    s[2] = (-_c(16)) * (D.w(x[2]) + D.w(x[3]))
    s[3] = _c(16) * (D.w(x[2]) - D.w(x[3]))
    s[6] = _c(16) * (D.w(x[6]) + D.w(x[7]))
    s[7] = _c(16) * (-D.w(x[6]) + D.w(x[7]))
    s[10] = _c(16) * (D.w(x[10]) + D.w(x[11]))
    s[11] = _c(16) * (-D.w(x[10]) + D.w(x[11]))
    s[14] = (-_c(16)) * (D.w(x[14]) + D.w(x[15]))
    s[15] = _c(16) * (D.w(x[14]) - D.w(x[15]))
    x[2] = D.rs(s[2])
    x[3] = D.rs(s[3])
    x[6] = D.rs(s[6])
    x[7] = D.rs(s[7])
    x[10] = D.rs(s[10])
    x[11] = D.rs(s[11])
    x[14] = D.rs(s[14])
    x[15] = D.rs(s[15])
    out = [x[0], -x[8], x[12], -x[4], x[6], x[14], x[10], x[2],
           x[3], x[11], x[15], x[7], x[5], -x[13], x[9], -x[1]]
    return xp.stack([D.n(o) for o in out], axis=1)


def idct32(inp, D, cast_in, xp=np):
    order = [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30]
    s1 = [None] * 32
    for k in range(16):
        s1[k] = cast_in(inp[:, order[k]])
    pairs = [(1, 31, 31, 1), (17, 15, 15, 17), (9, 23, 23, 9),
             (25, 7, 7, 25), (5, 27, 27, 5), (21, 11, 11, 21),
             (13, 19, 19, 13), (29, 3, 3, 29)]
    for k in range(8):
        ia, ib, ca, cb = pairs[k]
        a = cast_in(inp[:, ia])
        b = cast_in(inp[:, ib])
        s1[16 + k] = D.rs(D.w(a) * _c(ca) - D.w(b) * _c(cb))
        s1[31 - k] = D.rs(D.w(a) * _c(cb) + D.w(b) * _c(ca))
    # stage 2
    s2 = [None] * 32
    s2[:8] = s1[:8]
    s2[8] = D.rs(D.w(s1[8]) * _c(30) - D.w(s1[15]) * _c(2))
    s2[15] = D.rs(D.w(s1[8]) * _c(2) + D.w(s1[15]) * _c(30))
    s2[9] = D.rs(D.w(s1[9]) * _c(14) - D.w(s1[14]) * _c(18))
    s2[14] = D.rs(D.w(s1[9]) * _c(18) + D.w(s1[14]) * _c(14))
    s2[10] = D.rs(D.w(s1[10]) * _c(22) - D.w(s1[13]) * _c(10))
    s2[13] = D.rs(D.w(s1[10]) * _c(10) + D.w(s1[13]) * _c(22))
    s2[11] = D.rs(D.w(s1[11]) * _c(6) - D.w(s1[12]) * _c(26))
    s2[12] = D.rs(D.w(s1[11]) * _c(26) + D.w(s1[12]) * _c(6))
    for k in range(16, 32, 2):
        s2[k] = D.n(s1[k] + s1[k + 1])
        s2[k + 1] = D.n(s1[k] - s1[k + 1])
    s2[18], s2[19] = D.n(-s1[18] + s1[19]), D.n(s1[18] + s1[19])
    s2[22], s2[23] = D.n(-s1[22] + s1[23]), D.n(s1[22] + s1[23])
    s2[26], s2[27] = D.n(-s1[26] + s1[27]), D.n(s1[26] + s1[27])
    s2[30], s2[31] = D.n(-s1[30] + s1[31]), D.n(s1[30] + s1[31])
    # stage 3
    t = [None] * 32
    t[:4] = s2[:4]
    t[4] = D.rs(D.w(s2[4]) * _c(28) - D.w(s2[7]) * _c(4))
    t[7] = D.rs(D.w(s2[4]) * _c(4) + D.w(s2[7]) * _c(28))
    t[5] = D.rs(D.w(s2[5]) * _c(12) - D.w(s2[6]) * _c(20))
    t[6] = D.rs(D.w(s2[5]) * _c(20) + D.w(s2[6]) * _c(12))
    t[8] = D.n(s2[8] + s2[9])
    t[9] = D.n(s2[8] - s2[9])
    t[10] = D.n(-s2[10] + s2[11])
    t[11] = D.n(s2[10] + s2[11])
    t[12] = D.n(s2[12] + s2[13])
    t[13] = D.n(s2[12] - s2[13])
    t[14] = D.n(-s2[14] + s2[15])
    t[15] = D.n(s2[14] + s2[15])
    t[16] = s2[16]
    t[31] = s2[31]
    t[17] = D.rs(-D.w(s2[17]) * _c(4) + D.w(s2[30]) * _c(28))
    t[30] = D.rs(D.w(s2[17]) * _c(28) + D.w(s2[30]) * _c(4))
    t[18] = D.rs(-D.w(s2[18]) * _c(28) - D.w(s2[29]) * _c(4))
    t[29] = D.rs(-D.w(s2[18]) * _c(4) + D.w(s2[29]) * _c(28))
    t[19] = s2[19]
    t[20] = s2[20]
    t[21] = D.rs(-D.w(s2[21]) * _c(20) + D.w(s2[26]) * _c(12))
    t[26] = D.rs(D.w(s2[21]) * _c(12) + D.w(s2[26]) * _c(20))
    t[22] = D.rs(-D.w(s2[22]) * _c(12) - D.w(s2[25]) * _c(20))
    t[25] = D.rs(-D.w(s2[22]) * _c(20) + D.w(s2[25]) * _c(12))
    t[23] = s2[23]
    t[24] = s2[24]
    t[27] = s2[27]
    t[28] = s2[28]
    # stage 4
    u = [None] * 32
    u[0] = D.rs((D.w(t[0]) + D.w(t[1])) * _c(16))
    u[1] = D.rs((D.w(t[0]) - D.w(t[1])) * _c(16))
    u[2] = D.rs(D.w(t[2]) * _c(24) - D.w(t[3]) * _c(8))
    u[3] = D.rs(D.w(t[2]) * _c(8) + D.w(t[3]) * _c(24))
    u[4] = D.n(t[4] + t[5])
    u[5] = D.n(t[4] - t[5])
    u[6] = D.n(-t[6] + t[7])
    u[7] = D.n(t[6] + t[7])
    u[8] = t[8]
    u[15] = t[15]
    u[9] = D.rs(-D.w(t[9]) * _c(8) + D.w(t[14]) * _c(24))
    u[14] = D.rs(D.w(t[9]) * _c(24) + D.w(t[14]) * _c(8))
    u[10] = D.rs(-D.w(t[10]) * _c(24) - D.w(t[13]) * _c(8))
    u[13] = D.rs(-D.w(t[10]) * _c(8) + D.w(t[13]) * _c(24))
    u[11] = t[11]
    u[12] = t[12]
    u[16] = D.n(t[16] + t[19])
    u[17] = D.n(t[17] + t[18])
    u[18] = D.n(t[17] - t[18])
    u[19] = D.n(t[16] - t[19])
    u[20] = D.n(-t[20] + t[23])
    u[21] = D.n(-t[21] + t[22])
    u[22] = D.n(t[21] + t[22])
    u[23] = D.n(t[20] + t[23])
    u[24] = D.n(t[24] + t[27])
    u[25] = D.n(t[25] + t[26])
    u[26] = D.n(t[25] - t[26])
    u[27] = D.n(t[24] - t[27])
    u[28] = D.n(-t[28] + t[31])
    u[29] = D.n(-t[29] + t[30])
    u[30] = D.n(t[29] + t[30])
    u[31] = D.n(t[28] + t[31])
    # stage 5
    v = [None] * 32
    v[0] = D.n(u[0] + u[3])
    v[1] = D.n(u[1] + u[2])
    v[2] = D.n(u[1] - u[2])
    v[3] = D.n(u[0] - u[3])
    v[4] = u[4]
    v[5] = D.rs((D.w(u[6]) - D.w(u[5])) * _c(16))
    v[6] = D.rs((D.w(u[5]) + D.w(u[6])) * _c(16))
    v[7] = u[7]
    v[8] = D.n(u[8] + u[11])
    v[9] = D.n(u[9] + u[10])
    v[10] = D.n(u[9] - u[10])
    v[11] = D.n(u[8] - u[11])
    v[12] = D.n(-u[12] + u[15])
    v[13] = D.n(-u[13] + u[14])
    v[14] = D.n(u[13] + u[14])
    v[15] = D.n(u[12] + u[15])
    v[16] = u[16]
    v[17] = u[17]
    v[18] = D.rs(-D.w(u[18]) * _c(8) + D.w(u[29]) * _c(24))
    v[29] = D.rs(D.w(u[18]) * _c(24) + D.w(u[29]) * _c(8))
    v[19] = D.rs(-D.w(u[19]) * _c(8) + D.w(u[28]) * _c(24))
    v[28] = D.rs(D.w(u[19]) * _c(24) + D.w(u[28]) * _c(8))
    v[20] = D.rs(-D.w(u[20]) * _c(24) - D.w(u[27]) * _c(8))
    v[27] = D.rs(-D.w(u[20]) * _c(8) + D.w(u[27]) * _c(24))
    v[21] = D.rs(-D.w(u[21]) * _c(24) - D.w(u[26]) * _c(8))
    v[26] = D.rs(-D.w(u[21]) * _c(8) + D.w(u[26]) * _c(24))
    v[22] = u[22]
    v[23] = u[23]
    v[24] = u[24]
    v[25] = u[25]
    v[30] = u[30]
    v[31] = u[31]
    # stage 6
    w = [None] * 32
    w[0] = D.n(v[0] + v[7])
    w[1] = D.n(v[1] + v[6])
    w[2] = D.n(v[2] + v[5])
    w[3] = D.n(v[3] + v[4])
    w[4] = D.n(v[3] - v[4])
    w[5] = D.n(v[2] - v[5])
    w[6] = D.n(v[1] - v[6])
    w[7] = D.n(v[0] - v[7])
    w[8] = v[8]
    w[9] = v[9]
    w[10] = D.rs((-D.w(v[10]) + D.w(v[13])) * _c(16))
    w[13] = D.rs((D.w(v[10]) + D.w(v[13])) * _c(16))
    w[11] = D.rs((-D.w(v[11]) + D.w(v[12])) * _c(16))
    w[12] = D.rs((D.w(v[11]) + D.w(v[12])) * _c(16))
    w[14] = v[14]
    w[15] = v[15]
    w[16] = D.n(v[16] + v[23])
    w[17] = D.n(v[17] + v[22])
    w[18] = D.n(v[18] + v[21])
    w[19] = D.n(v[19] + v[20])
    w[20] = D.n(v[19] - v[20])
    w[21] = D.n(v[18] - v[21])
    w[22] = D.n(v[17] - v[22])
    w[23] = D.n(v[16] - v[23])
    w[24] = D.n(-v[24] + v[31])
    w[25] = D.n(-v[25] + v[30])
    w[26] = D.n(-v[26] + v[29])
    w[27] = D.n(-v[27] + v[28])
    w[28] = D.n(v[27] + v[28])
    w[29] = D.n(v[26] + v[29])
    w[30] = D.n(v[25] + v[30])
    w[31] = D.n(v[24] + v[31])
    # stage 7
    p = [None] * 32
    for k in range(8):
        p[k] = D.n(w[k] + w[15 - k])
    for k in range(8, 16):
        p[k] = D.n(w[15 - k] - w[k])
    p[16] = w[16]
    p[17] = w[17]
    p[18] = w[18]
    p[19] = w[19]
    p[20] = D.rs((-D.w(w[20]) + D.w(w[27])) * _c(16))
    p[27] = D.rs((D.w(w[20]) + D.w(w[27])) * _c(16))
    p[21] = D.rs((-D.w(w[21]) + D.w(w[26])) * _c(16))
    p[26] = D.rs((D.w(w[21]) + D.w(w[26])) * _c(16))
    p[22] = D.rs((-D.w(w[22]) + D.w(w[25])) * _c(16))
    p[25] = D.rs((D.w(w[22]) + D.w(w[25])) * _c(16))
    p[23] = D.rs((-D.w(w[23]) + D.w(w[24])) * _c(16))
    p[24] = D.rs((D.w(w[23]) + D.w(w[24])) * _c(16))
    p[28] = w[28]
    p[29] = w[29]
    p[30] = w[30]
    p[31] = w[31]
    # final stage
    out = [D.n(p[k] + p[31 - k]) for k in range(16)] + \
          [D.n(p[31 - k] - p[k]) for k in range(16, 32)]
    return xp.stack(out, axis=1)


_1D = {
    (0, 0): idct4, (0, 1): iadst4,
    (1, 0): idct8, (1, 1): iadst8,
    (2, 0): idct16, (2, 1): iadst16,
    (3, 0): idct32,
}
_SHIFT = [4, 5, 6, 6]


def inv_txfm2d(coeffs: np.ndarray, tx_size: int, tx_type: int,
               bd: int, xp=np, work_dtype=None) -> np.ndarray:
    """Batched 2-D inverse transform.  coeffs [N, n*n] row-major (post-scan).

    Returns residual [N, n, n] (after the final round shift), i.e. the
    value passed to clip_pixel_add in the reference.

    `xp` selects the array backend (numpy for the oracle, jax.numpy for the
    TPU path).  For bd=8 the working dtype may be int32: the int16 WRAPLOW
    points bound every product to < 2^30.
    """
    n = 4 << tx_size
    N = coeffs.shape[0]
    D, cast_in, no_cast, wide, work_dtype = _make_domain(bd, work_dtype)

    # ADST_DCT: column transform ADST, row transform DCT (vp9_idct.c:22-27).
    # 32x32 has no ADST variant: always 2-D DCT (vp9_idct.c vp9_idct32x32_add
    # is used for every tx type at TX_32X32).
    if tx_size == 3:
        tx_type = 0
    col_is_adst = tx_type in (1, 3)
    row_is_adst = tx_type in (2, 3)
    row_fn = _1D[(tx_size, 1 if row_is_adst else 0)]
    col_fn = _1D[(tx_size, 1 if col_is_adst else 0)]

    x = coeffs.astype(work_dtype).reshape(N, n, n)
    # row pass: each of the N*n rows
    rows = x.reshape(N * n, n)
    rows = row_fn(rows, D, no_cast if row_is_adst else cast_in, xp)
    inter = rows.reshape(N, n, n)
    # column pass
    cols = inter.transpose(0, 2, 1).reshape(N * n, n)
    cols = col_fn(cols, D, no_cast if col_is_adst else cast_in, xp)
    out = cols.reshape(N, n, n).transpose(0, 2, 1)
    shift = _SHIFT[tx_size]
    if wide is not None:
        out = out.astype(wide)  # final round shift must not re-wrap
    return (out + (1 << (shift - 1))) >> shift


def inv_txfm2d_select(coeffs, tx_size: int, tt, bd: int, xp=np,
                      work_dtype=None):
    """inv_txfm2d with a per-unit tx_type vector tt [N] (0..3).

    Runs one DCT and one ADST 1-D pass per dimension and selects per unit,
    so a mixed batch costs 4 one-D passes instead of four full 2-D
    transforms.  Bit-exact with inv_txfm2d for each unit.  Not valid for
    tx_size == 3 (no ADST variant; use inv_txfm2d)."""
    assert tx_size < 3
    n = 4 << tx_size
    N = coeffs.shape[0]
    D, cast_in, no_cast, wide, work_dtype = _make_domain(bd, work_dtype)

    dct = _1D[(tx_size, 0)]
    adst = _1D[(tx_size, 1)]
    row_is_adst = ((tt & 2) != 0).reshape(N, 1, 1)
    col_is_adst = ((tt & 1) != 0).reshape(N, 1, 1)

    x = coeffs.astype(work_dtype).reshape(N, n, n)
    rows_in = x.reshape(N * n, n)
    r_d = dct(rows_in, D, cast_in, xp).reshape(N, n, n)
    r_a = adst(rows_in, D, no_cast, xp).reshape(N, n, n)
    inter = xp.where(row_is_adst, r_a, r_d)
    cols_in = inter.transpose(0, 2, 1).reshape(N * n, n)
    c_d = dct(cols_in, D, cast_in, xp).reshape(N, n, n)
    c_a = adst(cols_in, D, no_cast, xp).reshape(N, n, n)
    out = xp.where(col_is_adst, c_a, c_d).transpose(0, 2, 1)
    shift = _SHIFT[tx_size]
    if wide is not None:
        out = out.astype(wide)  # final round shift must not re-wrap
    return (out + (1 << (shift - 1))) >> shift


def inv_wht2d(coeffs: np.ndarray, bd: int, xp=np,
              work_dtype=None) -> np.ndarray:
    """Batched 4x4 inverse Walsh-Hadamard (lossless).  coeffs [N,16]."""
    wrap = make_wrap(bd)
    if work_dtype is None:
        work_dtype = np.int64
    x = coeffs.astype(work_dtype).reshape(-1, 4, 4)

    def wht1d(v):  # v: [..., 4] along last axis
        a1 = v[..., 0]
        c1 = v[..., 1]
        d1 = v[..., 2]
        b1 = v[..., 3]
        a1 = a1 + c1
        d1 = d1 - b1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 = a1 - b1
        d1 = d1 + c1
        return xp.stack([wrap(a1), wrap(b1), wrap(c1), wrap(d1)], axis=-1)

    rows = wht1d(x >> 2)
    cols = wht1d(rows.transpose(0, 2, 1)).transpose(0, 2, 1)
    return cols  # residual, no final shift (vpx_iwht4x4_16_add_c)
