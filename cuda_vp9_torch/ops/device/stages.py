"""Intra wavefront stage in plain torch.

Counterpart of `cuda_vp9_tpu/ops/device/stages.py` (`intra_wave`,
`_predictors`): one call predicts a batch of same-size units of one wave
(all 10 VP9 intra modes, closed form), adds the residual, clips, and
writes the units into the frame.  All arithmetic is int32.  It is the
plain twin of the intra kernel (`csrc/intra.cu` via `ops/cuda/intra.py`):
it runs on CPU tensors, and on the card only where a check compares them.

Torch differs from JAX at the edges, so this version:
  * clamps every gather index into the frame (JAX clamps silently;
    torch raises on the CPU and asserts on the GPU);
  * routes the writes of padded units (y0 = -32768), and any write
    outside the frame, to a trash cell at the end of the frame buffer
    instead of relying on a dropped scatter.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _predictors(bs: int, A, tl, L, have_up, have_left, bd: int):
    """All 10 intra predictors for a batch.  A: [N, 2bs] int32 (already
    availability-replicated/filled), tl: [N], L: [N, bs], have_*: bool [N].
    Returns [N, 10, bs, bs]."""
    N = A.shape[0]
    dev = A.device
    ri = torch.arange(bs, dtype=torch.int64, device=dev)
    base = 128 << (bd - 8)
    maxval = (1 << bd) - 1
    outs = []

    # DC (mode 0)
    sum_a = A[:, :bs].sum(1, dtype=I32)
    sum_l = L.sum(1, dtype=I32)
    log2bs = bs.bit_length() - 1
    dc_both = (sum_a + sum_l + bs) >> (log2bs + 1)
    dc_top = (sum_a + (bs >> 1)) >> log2bs
    dc_left = (sum_l + (bs >> 1)) >> log2bs
    dc = torch.where(have_up & have_left, dc_both,
                     torch.where(have_up, dc_top,
                                 torch.where(have_left, dc_left,
                                             torch.full_like(dc_top, base))))
    outs.append(dc[:, None, None].expand(N, bs, bs))

    # V (1), H (2)
    outs.append(A[:, None, :bs].expand(N, bs, bs))
    outs.append(L[:, :, None].expand(N, bs, bs))

    # D45 (3)
    idx = ri[:, None] + ri[None, :]
    Ap = torch.cat([A, A[:, -1:], A[:, -1:]], 1)
    vals = _avg3(Ap[:, idx], Ap[:, idx + 1], Ap[:, idx + 2])
    lim, edge = (6, A[:, 7]) if bs == 4 else (bs - 1, A[:, bs - 1])
    outs.append(torch.where(idx[None] < lim, vals, edge[:, None, None]))

    # D135 (4): sliding AVG3 over [L[bs-1..0], tl, A[0..bs-1]], diagonal read
    S = torch.cat([L.flip(1), tl[:, None], A[:, :bs]], 1)
    border = _avg3(S[:, :-2], S[:, 1:-1], S[:, 2:])   # [N, 2bs-1]
    outs.append(border[:, (bs - 1) - ri[:, None] + ri[None, :]])

    # D117 (5)
    t = torch.minimum(ri[:, None] >> 1, ri[None, :])
    rp = ri[:, None] - 2 * t
    cp = ri[None, :] - t
    Am1 = torch.cat([tl[:, None], A[:, :bs]], 1)       # Am1[k] = A[k-1]
    row0 = _avg2(Am1[:, cp], Am1[:, cp + 1])
    Am2 = torch.cat([tl[:, None], Am1], 1)             # Am2[k] = A[k-2]
    cp1 = cp.clamp(min=1)
    row1 = torch.where(cp == 0,
                       _avg3(L[:, 0, None, None], tl[:, None, None],
                             A[:, 0, None, None]),
                       _avg3(Am2[:, cp1], Am1[:, cp1], A[:, cp1]))
    Lm = torch.cat([tl[:, None], L], 1)                # Lm[k] = L[k-1]
    col0 = torch.where(rp == 2,
                       _avg3(tl[:, None, None], L[:, 0, None, None],
                             L[:, 1, None, None]),
                       _avg3(Lm[:, (rp - 3).clamp(min=-1) + 1],
                             Lm[:, (rp - 2).clamp(min=0) + 1],
                             Lm[:, (rp - 1).clamp(min=0) + 1]))
    outs.append(torch.where(rp == 0, row0, torch.where(rp == 1, row1, col0)))

    # D153 (6)
    t = torch.minimum(ri[:, None], ri[None, :] >> 1)
    rp = ri[:, None] - t
    cp = ri[None, :] - 2 * t
    col0 = torch.where(rp == 0,
                       _avg2(tl[:, None, None], L[:, 0, None, None]),
                       _avg2(L[:, (rp - 1).clamp(min=0)],
                             L[:, rp.clamp(1, bs - 1)]))
    col1 = torch.where(
        rp == 0, _avg3(L[:, 0, None, None], tl[:, None, None],
                       A[:, 0, None, None]),
        torch.where(rp == 1, _avg3(tl[:, None, None], L[:, 0, None, None],
                                   L[:, 1, None, None]),
                    _avg3(L[:, (rp - 2).clamp(min=0)],
                          L[:, (rp - 1).clamp(min=0)],
                          L[:, rp.clamp(2, bs - 1)])))
    row0 = _avg3(Am1[:, (cp - 3).clamp(min=-1) + 1],
                 Am1[:, (cp - 2).clamp(min=-1) + 1],
                 Am1[:, (cp - 1).clamp(min=-1) + 1])
    outs.append(torch.where(cp == 0, col0, torch.where(cp == 1, col1, row0)))

    # D207 (7)
    v = ri[:, None] + (ri[None, :] >> 1)
    Lp = torch.cat([L, L[:, -1:].expand(N, bs + 2)], 1)
    a2 = _avg2(Lp[:, v], Lp[:, v + 1])
    a3 = _avg3(Lp[:, v], Lp[:, v + 1], Lp[:, v + 2])
    even = (ri[None, :] & 1) == 0
    last = L[:, bs - 1, None, None]
    inside = v[None] < bs - 1
    outs.append(torch.where(even[None], torch.where(inside, a2, last),
                            torch.where(inside, a3, last)))

    # D63 (8)
    idx63 = ri[None, :] + (ri[:, None] >> 1)
    Ap2 = torch.cat([A, A[:, -1:].expand(N, 2)], 1)
    a2 = _avg2(Ap2[:, idx63], Ap2[:, idx63 + 1])
    a3 = _avg3(Ap2[:, idx63], Ap2[:, idx63 + 1], Ap2[:, idx63 + 2])
    odd = (ri[:, None] & 1) == 1
    d63 = torch.where(odd[None], a3, a2)
    if bs != 4:
        fill = (ri[:, None] >= 2) & (idx63 > bs - 2)
        d63 = torch.where(fill[None], A[:, bs - 1, None, None], d63)
    outs.append(d63)

    # TM (9)
    outs.append((L[:, :, None] + A[:, None, :bs] - tl[:, None, None])
                .clamp(0, maxval))

    return torch.stack(outs, 1)  # [N, 10, bs, bs]


def intra_wave(Fbuf, R, plane, x0, y0, mode, n_above, n_left, tl_mode,
               have_up, have_left, *, bs: int, bd: int):
    """Predict + add residual + clip for one wave's bs-sized units, in place.

    Fbuf: int32 [P*ha*wa + 1], P planes [P, ha, wa] flattened plus one
    trash cell; R: int32 [P, ha, wa] residual.  P is 3 for one frame, and
    3N for a stack of N frames, where plane 3s + p is plane p of frame s
    (the batched step runs the same wave of every stream in one call).
    Unit fields are int32 [N]
    tensors as in the JAX stage: n_above valid above pixels (0 => base-1
    fill; indices beyond replicate the last valid one), n_left likewise
    with base+1 fill, tl_mode 0 = read frame, 1 = base+1, 2 = base-1.
    Padded units carry y0 = -32768 and write only the trash cell."""
    P, ha, wa = R.shape
    F = Fbuf[:-1].view(P, ha, wa)
    dev = Fbuf.device
    base = 128 << (bd - 8)
    maxval = (1 << bd) - 1
    plane = plane.long().clamp(0, P - 1)
    i2 = torch.arange(2 * bs, device=dev)
    i1 = torch.arange(bs, device=dev)
    ys = y0.long().clamp(min=0)
    xs = x0.long().clamp(min=0)
    row_up = (ys - 1).clamp(0, ha - 1)
    col_left = (xs - 1).clamp(0, wa - 1)
    a_idx = (xs[:, None] + torch.minimum(
        i2[None, :], (n_above.long() - 1).clamp(min=0)[:, None])
    ).clamp(max=wa - 1)
    A = F[plane[:, None], row_up[:, None], a_idx]
    A = torch.where((n_above > 0)[:, None], A, base - 1)
    l_idx = (ys[:, None] + torch.minimum(
        i1[None, :], (n_left.long() - 1).clamp(min=0)[:, None])
    ).clamp(max=ha - 1)
    L = F[plane[:, None], l_idx, col_left[:, None]]
    L = torch.where((n_left > 0)[:, None], L, base + 1)
    tl = torch.where(tl_mode == 0, F[plane, row_up, col_left],
                     torch.where(tl_mode == 1, base + 1, base - 1)
                     .to(I32))

    preds = _predictors(bs, A, tl, L, have_up > 0, have_left > 0, bd)
    sel = preds.gather(1, mode.long().clamp(0, 9)[:, None, None, None]
                       .expand(-1, 1, bs, bs))[:, 0]
    rows = ys[:, None, None] + i1[None, :, None]
    cols = xs[:, None, None] + i1[None, None, :]
    pl3 = plane[:, None, None]
    out = (sel + R[pl3, rows.clamp(max=ha - 1), cols.clamp(max=wa - 1)]
           ).clamp(0, maxval)
    # JAX writes rows y0 + i and drops what leaves the frame
    rows_o = y0.long()[:, None, None] + i1[None, :, None]
    keep = (rows_o >= 0) & (rows_o < ha) & (cols < wa)
    lin = torch.where(keep, (pl3 * ha + rows_o) * wa + cols, Fbuf.numel() - 1)
    Fbuf.index_put_((lin.reshape(-1),), out.reshape(-1))
