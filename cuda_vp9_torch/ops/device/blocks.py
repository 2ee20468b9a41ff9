"""Block gathers and scatters on a frame buffer with a trash element.

A frame buffer (`runtime/fused.frame_buffer`) is int32 [P*ha*wa + 1]: P
planes [P, ha, wa] flattened plus one trash element past their end.
Torch wraps negative indices and a CUDA device asserts on an
out-of-range one, so the plain torch stages send the writes of padded
records to the trash element instead of dropping them as JAX does
(`mode="drop"`).
"""

from __future__ import annotations

import torch


def block_index(buf, plane, y0, x0, valid, h, w, ha, wa):
    """Linear indices [N, h, w] of the blocks buf[plane, y0 + i, x0 + j]
    of a frame buffer; padded records (valid false) point at the trash
    element."""
    dev = buf.device
    ri = torch.arange(h, device=dev)[None, :, None]
    rj = torch.arange(w, device=dev)[None, None, :]
    lin = ((plane.long()[:, None, None] * ha + y0.long()[:, None, None] + ri)
           * wa + x0.long()[:, None, None] + rj)
    return torch.where(valid[:, None, None], lin, buf.numel() - 1)


def put_blocks(buf, plane, y0, x0, valid, vals, ha, wa):
    """buf[plane, y0 + i, x0 + j] = vals[n, i, j] for the valid records;
    the others write the trash element.  Destinations must be distinct."""
    lin = block_index(buf, plane, y0, x0, valid, vals.shape[1],
                      vals.shape[2], ha, wa)
    buf.index_put_((lin.reshape(-1),), vals.reshape(-1))
