"""The MC wrapper (cuda_vp9_torch/ops/cuda/mc.py) and its kernel
(csrc/mc.cu).

  * `mc_frame` on the CPU (the plain twin) against JAX
    `cuda_vp9_tpu.runtime.fused._mc_pass` for mc4, mc8, mc16 and mc32 in
    that order, then `_mcs_pass`, applied to the same frame, pool,
    records, headers and counts: the inputs of `tools/kernel_cases.py`
    (8-bit 4:2:0 on a 64x64 canvas, 12-bit 4:2:2 with a pool canvas
    larger than the frame), with compound chunks, padded records, an
    all-zero chunk and sources past the crop on every side;
  * `mc_frame` on several streams (3 streams with different chunk counts
    and n_ref0, the active streams a subset of the pool's, each with its
    mask) against one `mc_frame` per stream;
  * the kernel's table: its record, header and n_ref0 addresses are the
    data_ptr() of the segment views of the flat, on the keyframe and the
    inter frames of in01 and cp01 (parse and pack only);
  * a CUDA tensor never reaches the plain twin: with the kernel's loader,
    its workspace and the C call stubbed, a frame and a round make one
    host call each, with the phases and the scaled class counted, a
    frame with neither chunks nor mask bits makes none, and
    `plain_calls` stays; with a mask, a frame buffer off a 16-byte
    boundary or rows of a width not a multiple of 4 are refused; the
    table of every case of `kernel_cases.MC_CASES` (every chroma format's
    mask) is built, with the phases it should list;
  * on the card (marked `cuda`; skips without a device): the one launch
    against the twin, bit for bit, on every case of
    `kernel_cases.MC_CASES` (bit depths 8, 10 and 12; 4:2:0, 4:4:4,
    4:2:2 and 4:4:0; the packer's chunk lengths and short ones; 1, 3 and 4
    streams), with its mask, without it, and the mask alone: one host
    call and one launch a call, with the phases its table lists.

This file imports JAX only inside the test that needs it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_mc_kernel.py`.  Tolerance 0: integer math."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_vp9_torch import models as M
from cuda_vp9_torch.ops.cuda import _build
from cuda_vp9_torch.ops.cuda import mc as K
from cuda_vp9_torch.tools import kernel_cases as KC

FIXTURES = Path(__file__).parent / "fixtures"

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores, and an OpenMP pool of torch's in each
# oversubscribes them.
torch.set_num_threads(1)

KERNELS = np.asarray(M.FILTER_KERNELS, np.int32)


def frame_buffer(F):
    buf = torch.zeros(F.size + 1, dtype=torch.int32)
    buf[:-1] = torch.from_numpy(F).reshape(-1)
    return buf


def case(i, seed):
    bd, ss, ha, wa, pad, n, chunks, scaled = KC.MC_CASES[i]
    return KC.mc_case(np.random.default_rng(seed), bd, ss, ha, wa, pad, n,
                      chunks, scaled)


def pool_of(c, k):
    """Stream k's 8 pool slots."""
    s = 8 * int(c.active[k])
    return c.pool[s:s + 8]


@pytest.mark.parametrize("i", [0, 2])
def test_mc_frame_matches_jax(i):
    import jax
    from cuda_vp9_tpu.runtime import fused as JF

    c = case(i, 600 + i)
    # the JAX kernel reads the row band at the header's srow; the port
    # ignores that field, so both get srow 0 here
    for name in ("mc4h", "mc8h", "mc16h", "mc32h", "mcsh"):
        KC.mc_seg(c.flats, c.segs, name, c.segs[name][1][0])[:, :, 2] = 0
    pool = pool_of(c, 0)
    pha = pool.shape[2]
    fl = torch.from_numpy(c.flats[:1])
    classes, _ = KC.mc_args(c, fl, 0)
    scaled = classes[-1]
    assert scaled.w == 0 and c.misc[0, 15] < scaled.n
    assert all(c.misc[0, r] < cl.n for cl, (_, _, r) in zip(classes,
                                                             KC.MC_SLOTS))
    mc = jax.jit(JF._mc_pass, static_argnums=(5, 6, 7, 8, 9, 10))
    mcs = jax.jit(JF._mcs_pass, static_argnums=(5, 6, 7, 8))
    want = c.F[:3]
    for cl in classes[:-1]:
        units, hdrs, r0 = (np.asarray(v[0]) for v in K.class_views(fl, cl))
        want = mc(want, pool, KERNELS, units.astype(np.int32),
                  hdrs.astype(np.int32), cl.n, int(r0), cl.w, cl.w, pha,
                  c.bd)
    units, hdrs, r0 = (np.asarray(v[0]) for v in K.class_views(fl, scaled))
    want = np.asarray(mcs(want, pool, KERNELS, units.astype(np.int32),
                          hdrs.astype(np.int32), scaled.n, int(r0), pha,
                          c.bd))

    Fb = frame_buffer(c.F[:3])
    plain = K.plain_calls
    K.mc_frame(Fb, frame_buffer(c.R[:3]), torch.from_numpy(pool),
               torch.from_numpy(KERNELS), fl, classes, None, None, c.bd,
               c.ha, c.wa)
    assert K.plain_calls == plain + 1
    got = Fb[:-1].reshape(3, c.ha, c.wa).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} pixels differ, first at {bad[0]}"
    assert (want != c.F[:3]).sum() > 1000


def test_batched_matches_per_stream():
    c = case(4, 77)
    A = len(c.flats)
    assert len(set(c.misc[:, 0].tolist())) > 1
    assert len(set(c.misc[:, 23].tolist())) > 1
    fl = torch.from_numpy(c.flats)
    pool = torch.from_numpy(c.pool)
    kern = torch.from_numpy(KERNELS)
    Fb = frame_buffer(c.F)
    classes, mask = KC.mc_args(c, fl)
    K.mc_frame(Fb, frame_buffer(c.R), pool, kern, fl, classes, mask,
               torch.from_numpy(c.active), c.bd, c.ha, c.wa)
    for k in range(A):
        Fk = frame_buffer(c.F[3 * k:3 * k + 3])
        K.mc_frame(Fk, frame_buffer(c.R[3 * k:3 * k + 3]),
                   torch.from_numpy(pool_of(c, k)), kern, fl[k:k + 1],
                   *KC.mc_args(c, fl, k), None, c.bd, c.ha, c.wa)
        assert torch.equal(Fb[:-1].view(A, 3, c.ha, c.wa)[k],
                           Fk[:-1].view(3, c.ha, c.wa)), f"stream {k}"
    assert (Fb[:-1].numpy() != c.F.reshape(-1)).sum() > 3000


def _packed(name, n):
    """(flat, layout, hdr) of the first n frames of a fixture, packed by
    the port's native packer at the tier TorchRecon picks (full for an
    intra-only frame, scaled with scaled references, else tight, then
    wide), with no reconstruction: the recon hands back zero planes, which
    parsing never reads."""
    from cuda_vp9_torch.containers import IvfReader
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.runtime import fused
    from cuda_vp9_torch.runtime.pipeline import TorchRecon
    out = []

    def recon_fn(plan, refs):
        h = plan.hdr
        ha, wa = ((h.mi_rows + 7) & ~7) * 8, ((h.mi_cols + 7) & ~7) * 8
        scaled = TorchRecon._scaled(h, refs)
        pha = max([ha] + [(((rb.height + 7) // 8 + 7) & ~7) * 8
                          for rb in refs.values() if rb is not None
                          and not h.frame_is_intra_only])
        for tier in (("full",) if h.frame_is_intra_only else
                     ("scaled",) if scaled else ("tight", "wide")):
            _, caps, layout = fused.get_frame_step(
                h.mi_rows, h.mi_cols, tier, False, 8,
                pool_ha=pha if scaled else None)
            flat = plan.native_parser.pack(plan, refs, caps, layout,
                                           pool_ha=pha if scaled else None)
            if flat is not None:
                break
        out.append((flat, layout, h))
        return [np.zeros((ha, wa), np.uint8),
                np.zeros((ha >> 1, wa >> 1), np.uint8),
                np.zeros((ha >> 1, wa >> 1), np.uint8)]

    dec = NativeVp9Decoder(recon_fn=recon_fn)
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        for data, _ in r:
            dec.decode(data)
            if len(out) >= n:
                break
    return out[:n]


@pytest.mark.parametrize("name", ["in01_176x144", "cp01_352x288_compound"])
def test_table_addresses_equal_the_segment_views(name):
    """The table's record, header and n_ref0 addresses are the data_ptr()
    of the segment views the step built before the table (views of the
    device flat: seg(name, n) and misc[slot:slot + 1]), on a keyframe and
    on inter frames; parse and pack only."""
    from cuda_vp9_torch.runtime import fused
    frames = _packed(name, 3)
    assert frames[0][2].frame_is_intra_only
    n_inter, n_scaled = 0, 0
    for flat, layout, h in frames:
        misc = layout.view(flat, "misc").astype(np.int64)
        classes, mask = fused.inter_args(layout.segs, [flat], [misc],
                                         h.mi_rows, h.mi_cols)
        ha, wa = ((h.mi_rows + 7) & ~7) * 8, ((h.mi_cols + 7) & ~7) * 8
        flat_d = torch.from_numpy(flat)

        def seg(nm, rows):
            off, shape = layout.segs[nm]
            shape = (rows,) + tuple(shape[1:])
            return flat_d[off:off + int(np.prod(shape))].view(shape)

        moff = layout.segs["misc"][0]
        want = []
        for w, n_slot, r0_slot in fused.MC_CLASSES + ((0, 14, 15),):
            nm = f"mc{w}" if w else "mcs"
            if nm in layout.segs and misc[n_slot]:
                want.append((w, seg(nm, int(misc[n_slot])).data_ptr(),
                             seg(nm + "h", int(misc[n_slot])).data_ptr(),
                             flat_d[moff + r0_slot:].data_ptr()))
        buf = torch.zeros(3 * ha * wa + 1, dtype=torch.int32)
        table, n_phases, scaled = K.mc_table(
            buf, buf, torch.zeros((8, 3, 8, 8), dtype=torch.int32),
            torch.from_numpy(KERNELS), flat_d[None], classes, mask, None,
            ha, wa)
        rows = np.asarray(table, np.int64).reshape(-1, K.DESC_WORDS)
        assert len(rows) == n_phases
        got = sorted({tuple(int(v) for v in row[:4]) for row in rows})
        assert got == sorted(want)
        assert [c.w for c in classes] == [w for w, *_ in want]
        assert scaled == any(w == 0 for w, *_ in want)
        n_scaled += scaled
        assert (mask is None) == (not layout.view(flat, "mi_mask").any())
        if h.frame_is_intra_only:
            assert not classes and mask is None and not n_phases
        else:
            n_inter += 1
            assert classes
    assert n_inter >= 2
    assert (n_scaled > 0) == (name == "cp01_352x288_compound")


@pytest.mark.parametrize("i", range(len(KC.MC_CASES)))
def test_table_takes_every_case(i):
    """The host side of the kernel's call (mc_table) takes every case of
    kernel_cases.MC_CASES, the mask of each chroma format (4:2:0, 4:4:4,
    4:2:2 and 4:4:0) included, with and without the mask: as many phases
    as mc_phases lists, and the scaled class where the case has one."""
    c = case(i, 700 + i)
    if len(c.flats) == 1:
        pool, active = pool_of(c, 0), None
        fl = torch.from_numpy(c.flats[:1])
        classes, mask = KC.mc_args(c, fl, 0)
    else:
        pool, active = c.pool, torch.from_numpy(c.active)
        fl = torch.from_numpy(c.flats)
        classes, mask = KC.mc_args(c, fl)
    assert mask is not None and (mask.ssx, mask.ssy) == c.ss
    F, R = frame_buffer(c.F), frame_buffer(c.R)
    for m in (mask, None):
        _, n_phases, scaled = K.mc_table(
            F, R, torch.from_numpy(pool), torch.from_numpy(KERNELS), fl,
            classes, m, active, c.ha, c.wa)
        # the table lists the MC phases; the mask phase follows them
        assert (n_phases + (m is not None), scaled) == KC.mc_phases(
            classes, m)


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees of
    a tensor on the card, for its dispatch."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _dress(x):
    """Every tensor of a (nested) argument tuple as an _OnCuda."""
    if isinstance(x, torch.Tensor):
        return _OnCuda(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_dress(y) for y in x)
    return x


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    calls = []

    def fake_call(fn, device, *args):
        calls.append((fn, args))
        return 1                    # one launch, as the C side says

    monkeypatch.setattr(K, "_lib", lambda name="vp9_mc_pass": name)
    monkeypatch.setattr(_build, "call", fake_call)
    monkeypatch.setattr(K, "workspace", lambda n, device: torch.zeros(
        K.WS_LINE * (n + 1), dtype=torch.int32))
    counts = (K.launches, K.host_calls, K.phases, K.scaled_calls,
              K.plain_calls)
    c = case(0, 9)
    fl = _OnCuda(torch.from_numpy(c.flats))
    args = (torch.from_numpy(pool_of(c, 0).copy()),
            torch.from_numpy(KERNELS))
    classes, mask = KC.mc_args(c, fl, 0)
    K.mc_frame(_OnCuda(frame_buffer(c.F[:3])), _OnCuda(frame_buffer(c.R[:3])),
               *_dress(args), fl, classes, mask, None, c.bd, c.ha, c.wa)
    want_phases = KC.mc_phases(classes, mask)[0]
    assert (K.launches, K.host_calls, K.phases, K.scaled_calls,
            K.plain_calls) == (counts[0] + 1, counts[1] + 1,
                               counts[2] + want_phases, counts[3] + 1,
                               counts[4])
    fn, a = calls[-1]
    assert fn == "vp9_mc_pass" and a[10] is None and a[11] == 1
    assert a[14] == want_phases - 1 and a[15] is not None   # the mask
    # a frame with neither chunks nor mask bits: no call at all
    K.mc_frame(_OnCuda(frame_buffer(c.F[:3])), _OnCuda(frame_buffer(c.R[:3])),
               *_dress(args), fl, [], None, None, c.bd, c.ha, c.wa)
    assert len(calls) == 1 and K.host_calls == counts[1] + 1
    # the mask alone: one call, one phase
    K.mc_frame(_OnCuda(frame_buffer(c.F[:3])), _OnCuda(frame_buffer(c.R[:3])),
               *_dress(args), fl, [], mask, None, c.bd, c.ha, c.wa)
    assert len(calls) == 2 and calls[-1][1][14] == 0
    assert K.phases == counts[2] + want_phases + 1
    # a batched round: one call for every stream
    c = case(4, 10)
    fl = _OnCuda(torch.from_numpy(c.flats))
    classes, mask = KC.mc_args(c, fl)
    K.mc_frame(_OnCuda(frame_buffer(c.F)), _OnCuda(frame_buffer(c.R)),
               _OnCuda(torch.from_numpy(c.pool)),
               _OnCuda(torch.from_numpy(KERNELS)), fl, classes, mask,
               _OnCuda(torch.from_numpy(c.active)), c.bd, c.ha, c.wa)
    assert K.host_calls == counts[1] + 3 and K.plain_calls == counts[4]
    assert K.scaled_calls == counts[3] + 1
    assert calls[-1][1][11] == 3 and calls[-1][1][10] is not None
    with pytest.raises(ValueError):       # records must be the int16 wire
        K.mc_frame(_OnCuda(frame_buffer(c.F)), _OnCuda(frame_buffer(c.R)),
                   _OnCuda(torch.from_numpy(c.pool)),
                   _OnCuda(torch.from_numpy(KERNELS)),
                   _OnCuda(torch.from_numpy(c.flats).to(torch.int32)),
                   classes, mask, _OnCuda(torch.from_numpy(c.active)), c.bd,
                   c.ha, c.wa)
    with pytest.raises(ValueError):       # a segment past the flats' rows
        K.mc_frame(_OnCuda(frame_buffer(c.F)), _OnCuda(frame_buffer(c.R)),
                   _OnCuda(torch.from_numpy(c.pool)),
                   _OnCuda(torch.from_numpy(KERNELS)), fl,
                   [classes[0]._replace(n=10 ** 6)], mask,
                   _OnCuda(torch.from_numpy(c.active)), c.bd, c.ha, c.wa)
    assert len(calls) == 3 and K.plain_calls == counts[4]


@pytest.mark.parametrize("fault", ["offset", "width"])
def test_mask_needs_aligned_rows(fault):
    """The mask phase moves F and R 16 bytes at a time: with a mask,
    mc_table refuses a frame buffer that starts off a 16-byte boundary
    (a view with a storage offset) or rows of a width not a multiple of
    4, and takes the same buffer without a mask."""
    c = case(0, 11)
    fl = torch.from_numpy(c.flats[:1])
    classes, mask = KC.mc_args(c, fl, 0)
    wa = c.wa + (2 if fault == "width" else 0)
    size = 3 * c.ha * wa + 1
    F = torch.zeros(size + 1, dtype=torch.int32)
    F = F[1:] if fault == "offset" else F[:size]
    R = torch.zeros(size, dtype=torch.int32)
    args = (torch.from_numpy(pool_of(c, 0).copy()),
            torch.from_numpy(KERNELS), fl, classes)
    with pytest.raises(ValueError, match="16-byte"):
        K.mc_table(F, R, *args, mask, None, c.ha, wa)
    assert K.mc_table(F, R, *args, None, None, c.ha, wa)[1] > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(KC.MC_CASES)))
def test_kernel_matches_plain_on_card(i):
    dev = _card()
    c = case(i, 700 + i)
    kern = torch.from_numpy(KERNELS).to(dev)
    if len(c.flats) == 1:
        pool, active = pool_of(c, 0), None
        fl = torch.from_numpy(c.flats[:1]).to(dev)
        classes, mask = KC.mc_args(c, fl, 0)
    else:
        pool, active = c.pool, torch.from_numpy(c.active).to(dev)
        fl = torch.from_numpy(c.flats).to(dev)
        classes, mask = KC.mc_args(c, fl)
    F0 = frame_buffer(c.F).to(dev)
    R = frame_buffer(c.R).to(dev)
    for cl, m in ((classes, mask), (classes, None), ([], mask)):
        args = (R, torch.from_numpy(pool).to(dev), kern, fl, cl, m, active,
                c.bd, c.ha, c.wa)
        Fk, Fp = F0.clone(), F0.clone()
        counts = (K.launches, K.phases, K.scaled_calls, K.host_calls)
        K.mc_frame(Fk, *args)
        phases, scaled = KC.mc_phases(cl, m)
        assert (K.launches - counts[0], K.phases - counts[1],
                K.scaled_calls - counts[2], K.host_calls - counts[3]) == (
                    1, phases, scaled, 1)
        K.mc_frame_plain(Fp, *args)
        assert torch.equal(Fk[:-1], Fp[:-1])
        assert (Fp[:-1] != F0[:-1]).sum() > 1000
