"""The inter residual add, the last phase of the MC kernel
(cuda_vp9_torch/ops/cuda/mc.py `mask_add`, and `mc_frame` on the CPU with
a `Mask` and no class), against a NumPy transcription of the JAX step's
mask add (`cuda_vp9_tpu/runtime/fused.py:620-633`): F = clip(F + R, 0,
2^bd - 1) over the non-skip inter mi cells, the mask bit-packed 16 cells
to a sign-extended int16 word, a chroma cell (8 >> ss_y) x (8 >> ss_x)
pixels.

At 4:2:0, 4:4:4, 4:2:2 and 4:4:0, for 1 and 3 streams (the batched step's
stream axis: stream k's planes 3k .. 3k + 2 and its own mask), at bit
depths 8, 10 and 12, with mask words over the whole int16 range (bit 15
set), bits past the last mi column, and residuals that carry F + R past 0
and past 2^bd - 1.  Tolerance 0: integer math.  Imports no JAX."""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.ops.cuda import mc as K

torch.set_num_threads(1)

SS = {"420": (1, 1), "444": (0, 0), "422": (1, 0), "440": (0, 1)}


def numpy_mask_add(F, R, mp, mi_rows, mi_cols, bd, ssx, ssy):
    """fused.py:620-633 for one frame, in NumPy: F, R [3, ha, wa] int64,
    mp [mi_rows, words] int16."""
    _, ha, wa = F.shape
    m = ((mp.astype(np.int32)[:, :, None] >> np.arange(16)[None, None, :])
         & 1).reshape(mi_rows, -1)[:, :mi_cols]
    mask = np.zeros((3, ha, wa), bool)
    y8 = np.repeat(np.repeat(m, 8, axis=0), 8, axis=1) != 0
    mask[0, :mi_rows * 8, :mi_cols * 8] = y8
    chh, chw = 8 >> ssy, 8 >> ssx
    c4 = np.repeat(np.repeat(m, chh, axis=0), chw, axis=1) != 0
    mask[1, :mi_rows * chh, :mi_cols * chw] = c4
    mask[2, :mi_rows * chh, :mi_cols * chw] = c4
    return np.where(mask, np.clip(F + R, 0, (1 << bd) - 1), F)


def inputs(seed, A, bd, mi_rows=6, mi_cols=21):
    """(F, R, flats, off): frames [3A, ha, wa] of pixels and residuals
    that clip at both ends, and the flats [A, nflat] holding each stream's
    mask at `off` (a prefix of random words before it)."""
    rng = np.random.default_rng(seed)
    ha, wa = 64, 192                       # the aligned canvas of the mi grid
    maxv = (1 << bd) - 1
    F = rng.integers(0, maxv + 1, (3 * A, ha, wa))
    # residuals wide enough that F + R leaves [0, maxv] on both sides
    R = rng.integers(-maxv - 200, maxv + 200, (3 * A, ha, wa))
    words = -(-mi_cols // 16)
    off = 37
    flats = rng.integers(-32768, 32768, (A, off + mi_rows * words + 11)
                         ).astype(np.int16)
    flats[0, off] = -1                      # every bit, bit 15 among them
    if A > 1:
        flats[1, off:off + words] = 0       # a row without a cell
    return F.astype(np.int32), R.astype(np.int32), flats, off


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("A", [1, 3])
@pytest.mark.parametrize("chroma", sorted(SS))
def test_mask_add_matches_numpy(chroma, A, bd):
    ssx, ssy = SS[chroma]
    mi_rows, mi_cols = 6, 21
    F, R, flats, off = inputs(100 * bd + 10 * A + ssx + 2 * ssy, A, bd)
    ha, wa = F.shape[1:]
    words = -(-mi_cols // 16)
    mp = flats[:, off:off + mi_rows * words].reshape(A, mi_rows, words)
    assert (mp < 0).any()                   # bit 15 set
    want = np.concatenate([numpy_mask_add(
        F[3 * k:3 * k + 3].astype(np.int64), R[3 * k:3 * k + 3], mp[k],
        mi_rows, mi_cols, bd, ssx, ssy) for k in range(A)])
    # the cases clip at 0 and at 2^bd - 1 inside the mask
    changed = want != F
    assert (want[changed] == 0).any() and (want[changed] == (1 << bd) - 1
                                           ).any()
    # bits past the last mi column are set, and change nothing
    assert not changed[:, :, mi_cols * 8:].any()

    # the twin on [A, 3, ha, wa] views
    Ft = torch.from_numpy(F.copy()).view(A, 3, ha, wa)
    K.mask_add(Ft, torch.from_numpy(R).view(A, 3, ha, wa),
               torch.from_numpy(mp).to(torch.int32), mi_rows, mi_cols, bd,
               (ssx, ssy))
    assert np.array_equal(Ft.reshape(3 * A, ha, wa).numpy(), want)

    # mc_frame on the CPU, the mask alone: the twin over the flats
    Fb = torch.zeros(F.size + 1, dtype=torch.int32)
    Fb[:-1] = torch.from_numpy(F).reshape(-1)
    Rb = torch.zeros_like(Fb)
    Rb[:-1] = torch.from_numpy(R).reshape(-1)
    plain = K.plain_calls
    K.mc_frame(Fb, Rb, torch.zeros((8 * A, 3, 8, 8), dtype=torch.int32),
               torch.zeros((4, 16, 8), dtype=torch.int32),
               torch.from_numpy(flats), [],
               K.Mask(off, mi_rows, mi_cols, ssx, ssy),
               None if A == 1 else torch.arange(A, dtype=torch.int16), bd,
               ha, wa)
    assert K.plain_calls == plain + 1
    assert np.array_equal(Fb[:-1].view(3 * A, ha, wa).numpy(), want)
    assert Fb[-1] == 0
