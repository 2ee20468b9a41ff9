"""The intra wavefront wrapper (cuda_vp9_torch/ops/cuda/intra.py) and its
kernel (csrc/intra.cu).

  * `intra_pass` on the CPU (the plain twin) against JAX
    `cuda_vp9_tpu.runtime.fused._intra_pass`, on the intra segment of a
    real flat: the port's native packer on frame 0 of kf01_64x64 and of
    kf03_odd_98x66 (several chunks, mixed block sizes), over seeded random
    frames and residuals;
  * `intra_pass_batched` (2 streams, chunk index i of every stream in one
    call, each record with its own stream's block size, streams with
    fewer chunks) against one `intra_pass` per stream;
  * a CUDA tensor never reaches a plain twin: with the kernel's loader,
    its workspace and the C call stubbed, both forms make one host call
    that passes chunk_bs as a device pointer, count the launch the C side
    reports and the chunks it ran, and leave `plain_calls` alone;
  * on the card (marked `cuda`; skips without a device): the persistent
    kernel against the twin, bit for bit, one launch a pass, on the
    inputs of `tools/kernel_cases.py` at bit depths 8, 10 and 12 on a
    64x64 canvas, at 10 bits on the 1920x1088 canvas with 256-unit
    chunks, on a single chunk and on chunks of 4x4 units only, and in
    the batched form.

This file imports JAX only inside the test that needs it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_intra_pass.py`.  Tolerance 0: integer math."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
from cuda_vp9_torch.ops.cuda import _build
from cuda_vp9_torch.ops.cuda import intra as K
from cuda_vp9_torch.ops.ref import recon as ref_recon
from cuda_vp9_torch.runtime import fused as TF
from cuda_vp9_torch.tools import kernel_cases as KC

FIXTURES = Path(__file__).resolve().parent / "fixtures"

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them.
torch.set_num_threads(1)


def keyframe_flat(name):
    """(flat, layout, mi_rows, mi_cols) of frame 0 of a fixture, packed by
    the port's native packer at the full tier."""
    out = {}

    def recon_fn(plan, refs):
        h = plan.hdr
        _, caps, layout = TF.get_frame_step(h.mi_rows, h.mi_cols, "full")
        out.update(flat=plan.native_parser.pack(plan, refs, caps, layout),
                   layout=layout, mi=(h.mi_rows, h.mi_cols))
        return ref_recon.reconstruct_frame(plan, refs)

    dec = NativeVp9Decoder(recon_fn=recon_fn)
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        dec.decode(next(iter(r))[0])
    return out["flat"], out["layout"], *out["mi"]


def frame_buffer(F):
    buf = torch.zeros(F.size + 1, dtype=torch.int32)
    buf[:-1] = torch.from_numpy(F).reshape(-1)
    return buf


@pytest.mark.parametrize("name", ["kf01_64x64", "kf03_odd_98x66"])
def test_intra_pass_matches_jax(name):
    import jax.numpy as jnp
    from cuda_vp9_tpu.runtime import fused as JF

    flat, layout, mi_rows, mi_cols = keyframe_flat(name)
    n = int(layout.view(flat, "misc")[3])
    chunks = layout.view(flat, "intra")
    cbs = layout.view(flat, "chunk_bs")
    assert n > 1 and len(set(cbs[:n].tolist())) > 1
    ha, wa = ((mi_rows + 7) & ~7) * 8, ((mi_cols + 7) & ~7) * 8
    rng = np.random.default_rng(77)
    F = rng.integers(0, 256, (3, ha, wa)).astype(np.int32)
    R = rng.integers(-255, 256, (3, ha, wa)).astype(np.int32)
    want = np.asarray(JF._intra_pass(
        jnp.asarray(F), jnp.asarray(R), jnp.asarray(chunks.astype(np.int32)),
        jnp.asarray(cbs.astype(np.int32)), n, 8))
    Fb = frame_buffer(F)
    plain = K.plain_calls
    K.intra_pass(Fb, torch.from_numpy(R), torch.from_numpy(chunks), cbs, n, 8)
    assert K.plain_calls == plain + 1
    got = Fb[:-1].reshape(3, ha, wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
    assert (want != F).sum() > 1000


def _batched_inputs(seed, bd, dev="cpu", n=4):
    """n streams' frames and residuals (host), and their chunks, chunk_bs
    and counts as views of the streams' flats on `dev`, strided as the
    batched step passes them."""
    rng = np.random.default_rng(seed)
    F, R, flats, (om, oc, orc, cap) = KC.intra_streams(rng, n, 64, 64, bd, 64)
    fl = torch.from_numpy(flats).to(dev)
    A = flats.shape[0]
    chunks = fl[:, orc:orc + cap * 64 * 4].view(A, cap, 64, 4)
    return F, R, chunks, fl[:, oc:oc + cap], fl[:, om + 3]


def test_batched_matches_per_stream():
    F, R, chunks, cbs, cnt = _batched_inputs(5, 10, n=2)
    assert len(set(cnt.tolist())) > 1 and len(set(cbs[:, 0].tolist())) > 1
    Fb = frame_buffer(F)
    Rt = torch.from_numpy(R)
    K.intra_pass_batched(Fb, Rt, chunks, cbs, cnt, int(cnt.max()), 10)
    for k in range(len(cnt)):
        Fk = frame_buffer(F[3 * k:3 * k + 3])
        K.intra_pass(Fk, Rt[3 * k:3 * k + 3].contiguous(), chunks[k],
                     cbs[k].numpy(), int(cnt[k]), 10)
        assert torch.equal(Fb[:-1].view(-1, 3, 64, 64)[k],
                           Fk[:-1].view(3, 64, 64)), f"stream {k}"
    assert (Fb[:-1].numpy() != F.reshape(-1)).sum() > 15000


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees of
    a tensor on the card, for its dispatch."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    calls = []

    def fake_call(fn, device, *args):
        calls.append(args)
        return 1                    # one persistent launch a pass

    monkeypatch.setattr(K, "_lib", lambda: "vp9_intra_pass")
    monkeypatch.setattr(K, "workspace", lambda n, device: torch.empty(
        K.WS_LINE * (n + 1), dtype=torch.int32))
    monkeypatch.setattr(_build, "call", fake_call)
    rng = np.random.default_rng(9)
    F, R, rec, cbs = KC.intra_frame(rng, 64, 64, 8, 64)
    counts = (K.launches, K.chunks, K.host_calls, K.plain_calls)
    dev = [_OnCuda(t) for t in (frame_buffer(F), torch.from_numpy(R),
                                torch.from_numpy(rec), torch.from_numpy(cbs))]
    K.intra_pass(*dev, len(cbs), 8)
    assert (K.launches, K.chunks, K.host_calls, K.plain_calls) == (
        counts[0] + 1, counts[1] + len(cbs), counts[2] + 1, counts[3])
    # one stream, chunk_bs on the device, no counts; the workspace last
    assert calls[-1][8] == 1 and calls[-1][4] == dev[3].data_ptr() \
        and calls[-1][6] is None and calls[-1][10] == len(cbs)
    F, R, chunks, cbs, cnt = _batched_inputs(6, 8)
    n = int(cnt.max())
    K.intra_pass_batched(*(_OnCuda(t) for t in (frame_buffer(F),
                                                 torch.from_numpy(R), chunks,
                                                 cbs, cnt)), n, 8)
    assert (K.launches, K.chunks, K.host_calls, K.plain_calls) == (
        counts[0] + 2, counts[1] + len(rec) + n, counts[2] + 2, counts[3])
    assert calls[-1][8] == 4 and calls[-1][6] == cnt.data_ptr() \
        and calls[-1][5] == cbs.stride(0) and calls[-1][10] == n
    with pytest.raises(ValueError):
        K.intra_pass(_OnCuda(frame_buffer(F)), _OnCuda(torch.from_numpy(R)),
                     _OnCuda(chunks[0].to(torch.int32)), _OnCuda(cbs[0]), 1,
                     8)
    with pytest.raises(ValueError):     # chunk_bs as host ints
        K.intra_pass(_OnCuda(frame_buffer(F[:3])),
                     _OnCuda(torch.from_numpy(R[:3].copy())),
                     _OnCuda(chunks[0]), cbs[0].numpy(), 1, 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _held_on_card(dev, F, R, rec, cbs, bd):
    """One kernel pass against the twin: bit for bit, one launch."""
    Fk = frame_buffer(F).to(dev)
    Fp = Fk.clone()
    Rt, rt = torch.from_numpy(R).to(dev), torch.from_numpy(rec).to(dev)
    counts = (K.launches, K.chunks)
    K.intra_pass(Fk, Rt, rt, torch.from_numpy(cbs).to(dev), len(cbs), bd)
    K.intra_pass_plain(Fp, Rt, rt, cbs, len(cbs), bd)
    assert (K.launches, K.chunks) == (counts[0] + 1, counts[1] + len(cbs))
    assert torch.equal(Fk[:-1], Fp[:-1])
    assert not torch.equal(Fp, frame_buffer(F).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bd,ha,wa,ich,codes", [
    (8, 64, 64, 64, (0, 1, 2)), (8, 64, 64, 64, (3, 2, 1)),
    (10, 64, 64, 64, (0, 1, 2)), (10, 64, 64, 64, (3, 2, 1)),
    (12, 64, 64, 64, (0, 1, 2)), (12, 64, 64, 64, (3, 2, 1)),
    (10, 1088, 1920, 256, (0, 3, 1))])
def test_kernel_matches_plain_on_card(bd, ha, wa, ich, codes):
    dev = _card()
    rng = np.random.default_rng(bd * 100 + ha + sum(codes))
    _held_on_card(dev, *KC.intra_frame(rng, ha, wa, bd, ich, codes), bd)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one chunk", "4x4 only"])
def test_kernel_single_chunk_and_4x4_on_card(case):
    dev = _card()
    rng = np.random.default_rng(len(case))
    if case == "one chunk":
        F, R, rec, cbs = KC.intra_frame(rng, 64, 64, 10, 64, (3, 2, 1))
        rec, cbs = rec[:1], cbs[:1]
    else:
        F, R, rec, cbs = KC.intra_frame(rng, 128, 128, 8, 64, (0, 0, 0))
        assert len(cbs) > 1 and not cbs.any()
    _held_on_card(dev, F, R, rec, cbs, 10 if case == "one chunk" else 8)


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 12])
def test_batched_kernel_matches_plain_on_card(bd):
    dev = _card()
    F, R, chunks, cbs, cnt = _batched_inputs(40 + bd, bd, dev)
    Fk = frame_buffer(F).to(dev)
    Fp = Fk.clone()
    Rt = torch.from_numpy(R).to(dev)
    args = (chunks, cbs, cnt, int(cnt.max()), bd)
    counts = (K.launches, K.chunks)
    K.intra_pass_batched(Fk, Rt, *args)
    assert (K.launches, K.chunks) == (counts[0] + 1,
                                      counts[1] + int(cnt.max()))
    K.intra_pass_batched_plain(Fp, Rt, *args)
    assert torch.equal(Fk[:-1], Fp[:-1])
