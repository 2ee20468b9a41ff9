"""Inverse DCT/ADST 4..32 and the lossless 4x4 WHT on torch tensors, bd =
8, 10 and 12.

Counterpart of `cuda_vp9_tpu/ops/ref/transforms.inv_txfm2d`,
`inv_txfm2d_select` and `inv_wht2d` as `runtime/fused._residual_pass`
calls them, and the plain twin of the residual kernel (`csrc/residual.cu`
via `ops/cuda/residual.py`), which computes the same domains:

  * bd 8, `work_dtype=jnp.int16`: the WRAPLOW points are native int16
    arithmetic (adds and subtracts wrap in int16), every product is
    widened to int32, dct_const_round_shift truncates back to int16, and
    the final 2-D round shift is done in int32 so it does not wrap again;
  * bd 10 and 12, `work_dtype=jnp.int32`: every value is int32 and each
    WRAPLOW point wraps explicitly to bd + 8 bits (the reference's
    `_EmulatedDomain`); products wrap in int32 as they do in XLA.

The 1-D butterflies are the reference's own (this package's copy,
`ops/ref/transforms` `idct4 .. idct32`, `iadst4 .. iadst16`): they only
touch their inputs through a domain object (`w`, `n`, `rs`) and
`xp.stack`, so a torch domain runs them unchanged on CPU and CUDA
tensors.  The 2-D wrappers below replace the reference's, which call
NumPy's `.astype`.

The WHT (lossless frames) runs in int32 at every bit depth, as the JAX
step calls it (`work_dtype=jnp.int32`), wrapping each 1-D output to 16
bits at bd 8 and to bd + 8 bits above.
"""

from __future__ import annotations

import torch

from .ref import transforms as T


class _Torch16Domain:
    """WRAPLOW as native int16 arithmetic (ref: _Native16Domain)."""

    @staticmethod
    def w(x):
        return x.to(torch.int32)

    @staticmethod
    def n(x):
        return x

    @staticmethod
    def rs(x):
        return ((x + 8192) >> 14).to(torch.int16)


class _TorchWrapDomain:
    """WRAPLOW to bd + 8 bits in int32 arithmetic (ref: _EmulatedDomain
    with make_wrap(bd))."""

    def __init__(self, bd):
        self._m = 1 << (bd + 7)

    def _wrap(self, x):
        return ((x + self._m) & (2 * self._m - 1)) - self._m

    @staticmethod
    def w(x):
        return x

    def n(self, x):
        return self._wrap(x)

    def rs(self, x):
        return self._wrap((x + 8192) >> 14)


class _TorchXp:
    """The one array-namespace call the 1-D butterflies make."""

    @staticmethod
    def stack(xs, axis):
        return torch.stack(xs, dim=axis)


_D16 = _Torch16Domain()
_XP = _TorchXp()
_DOMAINS = {8: _D16, 10: _TorchWrapDomain(10), 12: _TorchWrapDomain(12)}


def _domain_input(coeffs, bd):
    """(domain, coefficients in its working dtype): int16 at bd 8, int32
    above."""
    return _DOMAINS[bd], coeffs.to(torch.int16 if bd == 8 else torch.int32)


def _ident(x):
    return x


def _finish(out, tx_size):
    shift = T._SHIFT[tx_size]
    return (out.to(torch.int32) + (1 << (shift - 1))) >> shift


def inv_txfm2d(coeffs: torch.Tensor, tx_size: int, tx_type: int,
               bd: int = 8) -> torch.Tensor:
    """coeffs [N, n*n] row-major (post-scan) -> residual [N, n, n] int32
    after the final round shift.  32x32 is always DCT_DCT."""
    n = 4 << tx_size
    N = coeffs.shape[0]
    D, coeffs = _domain_input(coeffs, bd)
    if tx_size == 3:
        tx_type = 0
    row_fn = T._1D[(tx_size, 1 if tx_type in (2, 3) else 0)]
    col_fn = T._1D[(tx_size, 1 if tx_type in (1, 3) else 0)]
    rows = row_fn(coeffs.reshape(N * n, n), D, _ident, _XP)
    cols = rows.reshape(N, n, n).transpose(1, 2).reshape(N * n, n)
    out = col_fn(cols, D, _ident, _XP).reshape(N, n, n).transpose(1, 2)
    return _finish(out, tx_size)


def inv_txfm2d_select(coeffs: torch.Tensor, tx_size: int,
                      tt: torch.Tensor, bd: int = 8) -> torch.Tensor:
    """inv_txfm2d with a per-unit tx_type tt [N] (0..3), tx_size < 3: one
    DCT and one ADST 1-D pass per dimension, selected per unit."""
    assert tx_size < 3
    n = 4 << tx_size
    N = coeffs.shape[0]
    D, coeffs = _domain_input(coeffs, bd)
    dct = T._1D[(tx_size, 0)]
    adst = T._1D[(tx_size, 1)]
    row_is_adst = ((tt & 2) != 0).reshape(N, 1, 1)
    col_is_adst = ((tt & 1) != 0).reshape(N, 1, 1)
    rows_in = coeffs.reshape(N * n, n)
    inter = torch.where(row_is_adst,
                        adst(rows_in, D, _ident, _XP).reshape(N, n, n),
                        dct(rows_in, D, _ident, _XP).reshape(N, n, n))
    cols_in = inter.transpose(1, 2).reshape(N * n, n)
    out = torch.where(col_is_adst,
                      adst(cols_in, D, _ident, _XP).reshape(N, n, n),
                      dct(cols_in, D, _ident, _XP).reshape(N, n, n))
    return _finish(out.transpose(1, 2), tx_size)


def _wht1d(v, wrap):
    """One 1-D inverse WHT along the last axis of v [..., 4]
    (vpx_iwht4x4_16_add_c)."""
    a1, c1, d1, b1 = v.unbind(-1)
    a1 = a1 + c1
    d1 = d1 - b1
    e1 = (a1 - d1) >> 1
    b1 = e1 - b1
    c1 = e1 - c1
    a1 = a1 - b1
    d1 = d1 + c1
    return torch.stack([wrap(a1), wrap(b1), wrap(c1), wrap(d1)], -1)


def inv_wht2d(coeffs: torch.Tensor, bd: int = 8) -> torch.Tensor:
    """coeffs [N, 16] row-major -> residual [N, 4, 4] int32: the inputs
    shift right by 2 first, and there is no final shift."""
    wrap = T.make_wrap(bd)
    x = coeffs.to(torch.int32).reshape(-1, 4, 4)
    rows = _wht1d(x >> 2, wrap)
    return _wht1d(rows.transpose(1, 2), wrap).transpose(1, 2)
