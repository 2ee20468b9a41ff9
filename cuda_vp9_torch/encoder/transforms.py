"""Forward transforms for the VP9 encoder.

The VP9 forward transform is NOT normative — only the inverse is
(vpx_dsp/inv_txfm.c).  Any residual -> coefficient mapping yields a
spec-valid bitstream; quality depends on how closely the forward inverts
the normative inverse.  Instead of re-deriving libvpx's fdct pipelines
(vp9/encoder/vp9_dct.c), we *measure* the inverse's linear map by running
the repo's own bit-exact inverse (`ops/ref/transforms.inv_txfm2d`) on
scaled unit impulses and invert that matrix once per (tx_size, tx_type).
The resulting forward is as faithful to THIS decoder's inverse as float
precision allows, which is what reconstruction quality depends on.
"""

from __future__ import annotations

import numpy as np

from ..ops.ref import transforms as inv

# impulse magnitude: large enough that the inverse's integer rounding is
# relatively negligible, small enough that nothing saturates at bd=8 scale
_PROBE = 1 << 10

_fwd_cache: dict = {}


def _inverse_matrix(tx_size: int, tx_type: int) -> np.ndarray:
    """Columns = inverse transform of unit impulses (the linear map L)."""
    n = 4 << tx_size
    nn = n * n
    eye = np.zeros((nn, nn), np.int32)
    np.fill_diagonal(eye, _PROBE)
    # bd=12 domain gives the widest headroom before clamping/wrapping
    res = inv.inv_txfm2d(eye, tx_size, tx_type, 12).reshape(nn, nn)
    return res.astype(np.float64).T / _PROBE  # [out_pixel, in_coeff]


def forward_matrix(tx_size: int, tx_type: int) -> np.ndarray:
    """[n*n coeff, n*n residual] float map: residual -> coefficients."""
    if tx_size == 3:
        tx_type = 0  # 32x32 is always 2-D DCT (vp9_idct.c)
    key = (tx_size, tx_type)
    m = _fwd_cache.get(key)
    if m is None:
        m = np.linalg.inv(_inverse_matrix(tx_size, tx_type))
        _fwd_cache[key] = m
    return m


def fwd_txfm2d(residual: np.ndarray, tx_size: int, tx_type: int) -> np.ndarray:
    """Batched forward transform: residual [N, n, n] -> float coeffs [N, n*n].

    Output is scaled so that `inv_txfm2d(round(out), ...)` reproduces the
    residual (up to quantization).
    """
    n = 4 << tx_size
    N = residual.shape[0]
    m = forward_matrix(tx_size, tx_type)
    return residual.reshape(N, n * n).astype(np.float64) @ m.T


def _iwht1d_inverse(o: np.ndarray) -> np.ndarray:
    """Exact integer inverse of one inv_wht2d butterfly pass.

    inv pass (ops/ref/transforms.py wht1d):  s=i0+i1, t=i2-i3,
    e=(s-t)>>1, o=(s-(e-i3), e-i3, e-i1, t+(e-i1)).  Solving back:
    s=o0+o1, t=o3-o2, e=(s-t)>>1 (the >>1 loses no information because
    s-t is invariant), then i follows exactly."""
    s = o[..., 0] + o[..., 1]
    t = o[..., 3] - o[..., 2]
    e = (s - t) >> 1
    i3 = e - o[..., 1]
    i1 = e - o[..., 2]
    i0 = s - i1
    i2 = t + i3
    return np.stack([i0, i1, i2, i3], axis=-1)


def fwd_wht2d(residual: np.ndarray) -> np.ndarray:
    """Exact forward 4x4 Walsh-Hadamard for the lossless path.

    Returns integer LEVELS [N, 16] such that the decoder pipeline
    (dequant by 4 at qindex 0, then inv_wht2d's input >>2 and two
    butterfly passes) reproduces `residual` bit-exactly — the vp9_fwht4x4
    counterpart.  inv_wht2d runs rows then columns, so the forward
    inverts columns then rows."""
    x = residual.astype(np.int64).reshape(-1, 4, 4)
    rows = _iwht1d_inverse(x.transpose(0, 2, 1)).transpose(0, 2, 1)
    levels = _iwht1d_inverse(rows)
    return levels.reshape(-1, 16)
