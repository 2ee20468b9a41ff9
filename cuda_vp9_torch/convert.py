"""Decoder state carried into the port's tensors (in place of weights).

A VP9 decoder's state between frames is its reference pool (8 slots of
reconstructed frames) and its output ring.  These helpers build the
port's device tensors from host RefBuffers or from the JAX backend's
state, so both backends can start a frame step from the same state.
"""

from __future__ import annotations

import numpy as np
import torch


def ref_canvas(rb, pha: int, pwa: int) -> np.ndarray:
    """A host RefBuffer as one pool slot: int32 [3, pha, pwa], each plane
    (uint8, or uint16 above 8 bits; chroma at the plane's own size, so
    full size at 4:4:4) in the top-left corner, zeros elsewhere
    (TpuReconFused._sync_slot)."""
    canvas = np.zeros((3, pha, pwa), np.int32)
    for p in range(3):
        pl = np.asarray(rb.planes[p])
        canvas[p, :pl.shape[0], :pl.shape[1]] = pl
    return canvas


def pool_from_refs(refs, pool_geom, device) -> torch.Tensor:
    """int32 [8, 3, pha, pwa] pool on `device` from 8 RefBuffers or None
    (a decoder's `ref_slots`); empty slots are zero."""
    pha, pwa = pool_geom
    pool = np.zeros((8, 3, pha, pwa), np.int32)
    for i, rb in enumerate(refs):
        if rb is not None:
            pool[i] = ref_canvas(rb, pha, pwa)
    return torch.from_numpy(pool).to(device)


def state_from_tpu(recon, device):
    """(pool, ring) tensors on `device` from a JAX `TpuReconFused` after
    its queued steps ran: pool int32 [8, 3, pha, pwa], ring [RING, nout]
    in the ring's own dtype (uint8 at 8 bits, int16 above)."""
    recon.flush()
    pool = torch.from_numpy(np.array(recon._pool)).to(device)
    ring = torch.from_numpy(np.array(recon._ring)).to(device)
    return pool, ring


def batched_state_from_tpu(dec, device):
    """(pool, ring) tensors on `device` from a JAX `BatchedFusedDecoder`
    after it ran its rounds (the round in flight is run first): pool int32
    [N, 8, 3, ha, wa], ring [N, RING, nout] in the ring's own dtype."""
    dec._dispatch_round()
    pool = torch.from_numpy(np.array(dec._pool)).to(device)
    ring = torch.from_numpy(np.array(dec._ring)).to(device)
    return pool, ring
