"""The page-compacted upload (cuda_vp9_torch/runtime/upload.py) and the
page expansion (ops/cuda/pages.py, csrc/pages.cu).

  * compact and expand: every flat that TorchRecon("cpu") uploads for the
    frames of kf01, in01, ll02 (the lossless layout), p1_01 (4:4:4, the
    Python packer) and the first 3 of cp01 (the scaled tier) comes back
    byte for byte through `Uploader.stage`, `send` and `expand` (the
    plain twin on the CPU), smaller than the flat; parse and pack only;
  * the same flats against the JAX package: its `native_compact` at the
    page tier of `_tier_ladder`, expanded as `fused.py:516-518` does, in
    NumPy, equals the port's expanded flat;
  * edge cases: an all-zero flat sends only its map; a flat whose pages
    are all nonzero ships dense and rebuilds; a round mixing both, with
    its int16 aux; the two staging buffers take turns, each refilled
    only after its last copy's event;
  * the step: with compaction, the CPU frame step leaves the pool and the
    ring equal to the step fed dense flats (compaction forced off), on
    kf01's frame 0 and in01's first 3 frames, and so does the batched
    step on 2 x in01's first 2 rounds;
  * parse threads: tl03's first 3 flats packed with 1 and with 4 tile
    threads are byte-equal (parse and pack only);
  * reused flats (`native.RecordedFlat`): the 4:2:0 fixtures above, twice
    over, packed as the batched decoder packs them (tight, else wide,
    else full) into one flat per tier, equal frame by frame the same
    frames packed into fresh flats, through tight overflows retried at
    wide, keyframes after inter frames and layouts taking turns; each
    record holds its flat's nonzero pages; compaction by the record
    equals the full scan (map, pages, count, dense fallback, the bytes
    `Uploader.stage` writes), and so it does on the wide copy of every
    tight flat (`BatchedTorchDecoder._remap_wide`), which equals the
    whole-segment copy;
  * `vpxdec -t 2 --summary` prints the golden MD5s and a summary line;
    `profile_decode.stage_clock` reads every host span of a decode;
  * a CUDA tensor never takes the twin: with the loader and the C call
    stubbed, one call for the flats of a call, the counters, and the
    checks on alignment and on the table;
  * the table the kernel takes from the host (stubbed call) equals the
    table at the head of the upload, on a round of dense, compacted and
    empty flats; a round of more flats than a launch takes (MAX_FLATS)
    makes one call per MAX_FLATS flats, each counted, and the twin
    rebuilds it;
  * on the card (marked `cuda`; skips without a device): the kernel
    against `expand_pages_plain` on a round that mixes dense, compacted
    and all-zero flats, one launch; on a 16-flat round whose runs of
    zero and nonzero pages cross the flats' boundaries and the kernel's
    runs of pages; and on a round past MAX_FLATS, two launches.

This file imports JAX only inside the test that needs it, so on the
card's machine it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_pages.py`.  Tolerance 0: integer data."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_vp9_torch import native
from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
from cuda_vp9_torch.ops.cuda import _build
from cuda_vp9_torch.ops.cuda import pages as K
from cuda_vp9_torch.runtime import pack as P
from cuda_vp9_torch.runtime import upload as U
from cuda_vp9_torch.runtime.pipeline import TorchRecon

# One intra-op thread per process: the suite runs several pytest
# workers on the same cores.
torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
PAGE = K.PAGE

# (fixture, frames): every frame, or cp01's first 3 (two of them scaled)
ROUNDTRIP = [("kf01_64x64", None), ("in01_176x144", None),
             ("ll02_96x64_lossless_inter", None),
             ("p1_01_176x144_444", None), ("cp01_352x288_compound", 3)]


def _packets(name, n=None):
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r][:n]


def _kept(flat):
    """A copy of a flat that its packer will pack into again, with a copy
    of its page record where it has one (`native.RecordedFlat`)."""
    kept = flat.copy()
    if getattr(flat, "written", None) is not None:
        kept.written = flat.written.copy()
    return kept


def _uploaded_flats(name, n=None, threads=1):
    """The host flats TorchRecon("cpu") uploads for the first n packets
    of a fixture (its tiers, its packers), with the step replaced by a
    recorder: parse and pack only, the frames read back as zeros.  The
    recon packs into the same flat frame after frame, so the recorder
    keeps copies, records and all."""
    recon, flats = TorchRecon("cpu"), []
    real = recon._step

    def recording_step(*key):
        _, caps, layout = real(*key)
        return (lambda pool, ring, kernels, flat, uploader=None:
                flats.append(_kept(flat))), caps, layout

    recon._step = recording_step
    dec = NativeVp9Decoder(recon_fn=recon, threads=threads)
    for p in _packets(name, n):
        dec.decode(p)
    assert recon.frames_on_host == 0
    return flats


def _through(up, flats, aux=None):
    """(device flats, device aux or None, Staged) of one Uploader
    call."""
    st = up.stage(flats, aux)
    buf = up.send(st)
    return up.expand(st, buf), (None if aux is None else up.aux(st, buf)), st


@pytest.mark.parametrize("name,n", ROUNDTRIP)
def test_compact_expand_roundtrip(name, n):
    flats = _uploaded_flats(name, n)
    assert flats
    up = U.Uploader("cpu")
    for i, flat in enumerate(flats):
        got, _, st = _through(up, [flat])
        assert np.array_equal(got[0].numpy(), flat), (name, i)
        nz = int(flat.reshape(-1, PAGE).any(axis=1).sum())
        assert st.flats[0].n == nz and st.flats[0].map >= 0
    assert up.frames == len(flats) and up.dense_frames == 0
    assert up.sent_bytes < up.flat_bytes == sum(f.nbytes for f in flats)


@pytest.mark.parametrize("name,n", ROUNDTRIP)
def test_expansion_matches_jax(name, n):
    from cuda_vp9_tpu.native import native_compact, native_count_pages
    from cuda_vp9_tpu.runtime.pipeline import _tier_ladder
    up = U.Uploader("cpu")
    for i, flat in enumerate(_uploaded_flats(name, n)):
        Kp = flat.size // PAGE
        nz = native_count_pages(flat, Kp)
        tier = next((t for t in _tier_ladder(Kp) if nz <= t), None)
        if tier is None:        # JAX ships this flat dense
            want = flat
        else:
            comb = native_compact(flat, Kp, tier)
            hr = -(-Kp // PAGE)
            g = comb[:hr].reshape(-1)[:Kp].astype(np.int32)
            want = np.take(comb[hr:], g, axis=0).reshape(-1)
        got = _through(up, [flat])[0][0].numpy()
        assert np.array_equal(got, want), (name, i, tier)


def test_all_zero_flat_sends_only_its_map():
    up = U.Uploader("cpu")
    flat = np.zeros(37 * PAGE, np.int16)
    got, _, st = _through(up, [flat])
    assert not got.any() and st.flats[0].n == 0
    assert st.nbytes == U._align16(K.TABLE_BYTES) + U._align16(4 * 37)
    assert up.dense_frames == 0


def test_dense_flat_ships_dense_and_rebuilds():
    """A flat ships dense exactly when its map and nonzero pages would
    not be smaller: 300 pages have a 1200-byte map, so one zero page does
    not pay for it and two do."""
    rng = np.random.default_rng(9)
    flat = rng.integers(1, 1 << 15, 300 * PAGE, dtype=np.int16)
    up = U.Uploader("cpu")
    for zero_pages, dense in ((0, True), (1, True), (2, False)):
        flat[7 * PAGE:(7 + zero_pages) * PAGE] = 0
        got, _, st = _through(up, [flat])
        assert np.array_equal(got[0].numpy(), flat), zero_pages
        assert (st.flats[0].map < 0) == dense, zero_pages
        assert st.nbytes == K.TABLE_BYTES + flat.nbytes if dense \
            else st.nbytes < K.TABLE_BYTES + flat.nbytes
    assert up.dense_frames == 2


def test_round_mixes_dense_compact_and_empty_flats():
    rng = np.random.default_rng(10)
    n = 24 * PAGE
    dense = rng.integers(-99, 99, n, dtype=np.int16) | 1
    sparse = np.zeros(n, np.int16)
    sparse[5 * PAGE + 7] = -3
    sparse[20 * PAGE:21 * PAGE] = rng.integers(-9, 9, PAGE)
    aux = np.array([2, 0, 1, 17, -5], np.int16)
    up = U.Uploader("cpu")
    flats = [sparse, dense, np.zeros(n, np.int16)]
    got, aux_d, st = _through(up, flats, aux)
    assert np.array_equal(got.numpy(), np.stack(flats))
    assert np.array_equal(aux_d.numpy(), aux)
    assert [f.map < 0 for f in st.flats] == [False, True, False]
    assert [f.n for f in st.flats] == [2, 24, 0]


class _Event:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_staging_buffers_take_turns():
    """Each call fills the other staging buffer, and waits first on the
    event behind that buffer's last copy."""
    up = U.Uploader("cpu")
    ev = up._copied = [_Event(), _Event()]
    flat = np.zeros(4 * PAGE, np.int16)
    turns = [up.stage([flat]).turn for _ in range(3)]
    assert turns == [0, 1, 0] and (ev[0].waits, ev[1].waits) == (2, 1)
    assert up._host[0].data_ptr() != up._host[1].data_ptr()
    big = np.zeros(64 * PAGE, np.int16)
    assert up.stage([big]).turn == 1 and up._host[1].numel() >= big.nbytes


def _decode_states(name, n, dense, monkeypatch):
    """(pool, ring) after each of the first n frames of a fixture through
    TorchRecon("cpu"), with compaction on or forced off."""
    if dense:
        monkeypatch.setattr(U, "compact_pages", lambda *a: -1)
    recon, states = TorchRecon("cpu"), []

    def recon_fn(plan, refs):
        planes = recon(plan, refs)
        states.append((recon._pool.clone(), recon._ring.clone()))
        return planes

    dec = NativeVp9Decoder(recon_fn=recon_fn)
    for p in _packets(name, n):
        dec.decode(p)
    up = recon.uploader
    assert up.frames == n and up.dense_frames == (n if dense else 0)
    monkeypatch.undo()
    return states


@pytest.mark.parametrize("name,n", [("kf01_64x64", 1), ("in01_176x144", 3)])
def test_frame_step_compacted_equals_dense(name, n, monkeypatch):
    comp = _decode_states(name, n, False, monkeypatch)
    dense = _decode_states(name, n, True, monkeypatch)
    assert len(comp) == len(dense) == n
    for i, ((p0, r0), (p1, r1)) in enumerate(zip(comp, dense)):
        assert torch.equal(p0, p1) and torch.equal(r0, r1), (name, i)


def test_batched_round_compacted_equals_dense(monkeypatch):
    from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
    states = []
    for dense in (False, True):
        if dense:
            monkeypatch.setattr(U, "compact_pages", lambda *a: -1)
        bd = BatchedTorchDecoder(2, "cpu")
        pk = _packets("in01_176x144", 2)
        for i in range(2):
            bd.decode_round([pk[i], pk[i]])
            states.append((bd._pool.clone(), bd._ring.clone()))
        assert bd.rounds == 2 and bd.uploader.frames == 4
        assert bd.uploader.dense_frames == (4 if dense else 0)
        monkeypatch.undo()
    for (p0, r0), (p1, r1) in zip(states[:2], states[2:]):
        assert torch.equal(p0, p1) and torch.equal(r0, r1)


def test_parse_threads_pack_the_same_flats():
    one = _uploaded_flats("tl03_640x360_t4", 3)
    four = _uploaded_flats("tl03_640x360_t4", 3, threads=4)
    assert len(one) == len(four) == 3
    for a, b in zip(one, four):
        assert np.array_equal(a, b)


# the 4:2:0 fixtures of ROUNDTRIP (the C++ packer's), each decoded twice
# over, so that a keyframe follows inter frames
RECORDED = [(name, n) for name, n in ROUNDTRIP if "_444" not in name]
TIERS = ("tight", "wide", "full")


class _Packs:
    """recon_fn of a NativeVp9Decoder that packs each frame as
    BatchedTorchDecoder does, tight, else wide, else full (intra-only), into
    one `native.RecordedFlat` per tier, and into a fresh flat beside it; it
    holds each reused flat against the fresh one and calls check(flat) on
    it.  `log` gets (intra-only, the tiers that overflowed, the tier
    packed or None); the planes are zeros."""

    def __init__(self, check):
        self.check, self.log, self._tiers, self.flats = check, [], {}, {}

    def __call__(self, plan, refs):
        h = plan.hdr
        lossless, overflowed, used = bool(h.lossless), [], None
        for tier in TIERS[:3 if h.frame_is_intra_only else 2]:
            key = (tier, h.mi_rows, h.mi_cols, lossless)
            if key not in self._tiers:
                caps = P.compute_caps(h.mi_rows, h.mi_cols, tier, lossless)
                if tier != "full":      # fused.get_batched_step's tiers
                    caps["intra_chunk"] = P.CHUNK_INTRA
                layout = P.build_layout(caps, h.mi_rows, h.mi_cols, lossless,
                                        h.bit_depth)
                self._tiers[key] = (caps, layout)
                self.flats[key] = native.RecordedFlat.zeros(layout.size)
            caps, layout = self._tiers[key]
            parser = plan.native_parser
            fresh = parser.pack(plan, refs, caps, layout)
            got = parser.pack(plan, refs, caps, layout, out=self.flats[key])
            assert (got is None) == (fresh is None), key
            if got is None:
                overflowed.append(tier)
                continue
            assert got is self.flats[key] and np.array_equal(got, fresh)
            self.check(got)
            used = tier
            break
        self.log.append((h.frame_is_intra_only, overflowed, used))
        ha, wa = ((h.mi_rows + 7) & ~7) * 8, ((h.mi_cols + 7) & ~7) * 8
        return [np.zeros((ha, wa), np.uint16)] + [
            np.zeros((ha >> 1, wa >> 1), np.uint16)] * 2


def _pack_twice_over(name, n, check):
    """The log of _Packs over a fixture's first n packets, twice."""
    packs = _Packs(check)
    dec = NativeVp9Decoder(recon_fn=packs)
    for p in _packets(name, n) * 2:
        dec.decode(p)
    return packs


def _covers(flat):
    """Every nonzero page of a recorded flat is in its record."""
    nz = flat.reshape(-1, PAGE).any(axis=1)
    assert not (nz & (flat.written == 0)).any()


@pytest.mark.parametrize("name,n", RECORDED)
def test_reused_flats_pack_as_fresh_ones(name, n):
    """Frame after frame, the flat packed into a reused buffer equals the
    frame packed into a fresh one, and its record holds its nonzero pages:
    across a tight overflow retried at wide (its partial writes zeroed at
    the next tight pack), a keyframe packed into the buffer of inter
    frames, and the tight and wide layouts taking turns on one parser."""
    packs = _pack_twice_over(name, n, _covers)
    log = packs.log
    assert len(log) >= 2 * len(_packets(name, n))
    retried = [i for i, (_, over, used) in enumerate(log)
               if "tight" in over and used == "wide"]
    if name == "in01_176x144":
        # its keyframes overflow tight; its inter frames fit it
        assert retried and any(used == "tight" for _, _, used in
                               log[retried[0] + 1:])
        assert any(intra and log[i - 1][2] == "tight" and not log[i - 1][0]
                   for i, (intra, _, _) in enumerate(log) if i)
        assert {used for _, _, used in log} >= {"tight", "wide"}


def _compacted(flat, max_pages, written):
    """(count, map, the count's pages) of compact_pages into buffers that
    start as garbage."""
    k = flat.size // PAGE
    g = np.full(k, -7, np.int32)
    pages = np.full((k, PAGE), -7, np.int16)
    n = native.compact_pages(flat, max_pages, g.ctypes.data,
                             pages.ctypes.data, written)
    return n, g, pages[:max(n, 0)]


def _compaction_by_record_equals_full_scan(flat):
    nz = int(flat.reshape(-1, PAGE).any(axis=1).sum())
    k = flat.size // PAGE
    for max_pages in (k, nz, max(nz - 1, 0)):
        n, g, pages = _compacted(flat, max_pages, flat.written)
        n0, g0, pages0 = _compacted(flat, max_pages, None)
        assert n == n0 == (nz if nz <= max_pages else -1)
        if n >= 0:
            assert np.array_equal(g, g0) and np.array_equal(pages, pages0)
    kept = _kept(flat)
    kept.written = None
    assert _staged(flat) == _staged(kept)


def _staged(flat):
    """(bytes used, table, the bytes of the table, aux, map and pages: the
    gaps that align them are left as they were) of `Uploader.stage` on
    the flat with an aux."""
    up = U.Uploader("cpu")
    st = up.stage([flat], np.arange(3, dtype=np.int16))
    b, k = up._host[st.turn].numpy(), flat.size // PAGE
    f, = st.flats
    parts = [b[:K.TABLE_BYTES + 6]]
    if f.map < 0:
        parts.append(b[f.pages:f.pages + k * K.PAGE_BYTES])
    else:
        parts += [b[f.map:f.map + 4 * k],
                  b[f.pages:f.pages + f.n * K.PAGE_BYTES]]
    return st.nbytes, list(st.flats), [x.tobytes() for x in parts]


@pytest.mark.parametrize("name,n", RECORDED)
def test_compaction_by_record_equals_full_scan(name, n):
    """On every reused flat of the frames above, compact_pages with the
    record gives the full scan's count, map and pages, and its dense
    fallback at the same max_pages; `Uploader.stage` writes the same bytes
    for the flat and for a copy without a record."""
    _pack_twice_over(name, n, _compaction_by_record_equals_full_scan)


def test_wide_copy_of_a_tight_flat_keeps_its_record():
    """`BatchedTorchDecoder._remap_wide` on every tight flat of in01 (twice
    over): the wide flat equals the whole tight segments copied into a
    zero wide flat, its record holds its nonzero pages, and compaction by
    the record equals the full scan."""
    from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
    kept = []
    packs = _pack_twice_over("in01_176x144", None,
                             lambda f: kept.append(_kept(f)))
    geom = next(k[1:] for k in packs._tiers if k[0] == "tight")
    tight, wide = (packs._tiers[(t,) + geom][1] for t in ("tight", "wide"))
    bd = BatchedTorchDecoder(1, "cpu")
    bd._tiers = [(None, None, tight), (None, None, wide), None]
    flats = [f for f in kept if f.size == -(-tight.size // PAGE) * PAGE]
    assert len(flats) >= 10
    for flat in flats:
        got = bd._remap_wide(flat)
        want = np.zeros_like(got.view(np.ndarray))
        for name in tight.segs:
            src = tight.view(flat, name)
            wide.view(want, name)[:src.shape[0]] = src
        assert np.array_equal(got, want)
        _covers(got)
        _compaction_by_record_equals_full_scan(got)


def test_vpxdec_threads_and_summary(capsys):
    from cuda_vp9_torch.tools import vpxdec
    name = "kf01_64x64"
    assert vpxdec.main([str(FIXTURES / f"{name}.ivf"), "-t", "2",
                        "--summary", "--md5", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == (FIXTURES / f"{name}.md5").read_text(
    ).splitlines()
    assert err.startswith("3 frames in ") and err.rstrip().endswith("fps)")


def test_stage_clock_reads_the_host_spans():
    from cuda_vp9_torch.tools import profile_decode
    n, wall, spent = profile_decode.stage_clock(
        str(FIXTURES / "kf01_64x64.ivf"), "cpu", 0)
    assert n == 3 and {"vp9.parse", "vp9.pack", "vp9.compact",
                       "vp9.upload", "vp9.expand", "vp9.readback",
                       "vp9.residual"} <= set(spent)
    assert sum(spent.values()) <= wall


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees of
    a tensor on the card, for its dispatch."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _stub_call(monkeypatch):
    """The C call stubbed: returns the list of its argument tuples."""
    calls = []

    def fake_call(fn, device, *args):
        calls.append(args)
        return 1

    monkeypatch.setattr(K, "_lib", lambda: "vp9_expand_pages")
    monkeypatch.setattr(_build, "call", fake_call)
    return calls


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    calls = _stub_call(monkeypatch)
    st = U.Uploader("cpu").stage([np.zeros(8 * PAGE, np.int16)] * 2)
    buf = torch.zeros(st.nbytes, dtype=torch.uint8)
    out = torch.zeros(2 * 8 * PAGE, dtype=torch.int16)
    counts = (K.launches, K.pages, K.plain_calls)
    K.expand_pages(_OnCuda(out), _OnCuda(buf), st.flats, 8)
    assert calls == [(buf.data_ptr(), st.flats.addr, 2, 8, out.data_ptr())]
    assert (K.launches, K.pages, K.plain_calls) == (
        counts[0] + 1, counts[1] + 16, counts[2])
    with pytest.raises(ValueError):     # out off a 16-byte boundary
        K.expand_pages(_OnCuda(torch.zeros(2 * 8 * PAGE + 1,
                                           dtype=torch.int16)[1:]),
                       _OnCuda(buf), st.flats, 8)
    with pytest.raises(ValueError):     # a map past the buffer's end
        K.expand_pages(_OnCuda(out), _OnCuda(buf[:-4]), st.flats, 8)
    with pytest.raises(ValueError):     # a dense flat of the wrong size
        K.expand_pages(_OnCuda(out), _OnCuda(buf),
                       [st.flats[0], K.Flat(-1, st.flats[1].map, 7)], 8)
    assert len(calls) == 1


def _mixed_round(rng, n_flats, n_pages):
    """n_flats flats of n_pages pages: in turn compacted, dense and all
    zero, the compacted ones with runs of nonzero pages that start and end
    anywhere, across the kernel's runs of pages."""
    flats = []
    for k in range(n_flats):
        f = np.zeros(n_pages * PAGE, np.int16)
        if k % 3 == 1:
            f[:] = rng.integers(1, 99, f.size)
        elif k % 3 == 0:
            p = f.reshape(n_pages, PAGE)
            for a in rng.integers(0, n_pages, 3):
                p[a:a + int(rng.integers(1, 20))] = rng.integers(
                    -9, 9, PAGE) | 1
        flats.append(f)
    return flats


def test_kernel_table_equals_upload_head(monkeypatch):
    calls = _stub_call(monkeypatch)
    flats = _mixed_round(np.random.default_rng(11), 5, 300)
    up = U.Uploader("cpu")
    st = up.stage(flats, np.arange(3, dtype=np.int16))
    assert [f.map < 0 for f in st.flats] == [False, True, False, False, True]
    assert st.flats[2].n == 0 < st.flats[0].n
    buf = up.send(st)
    out = torch.empty(5 * 300 * PAGE, dtype=torch.int16)
    K.expand_pages(_OnCuda(out), _OnCuda(buf), st.flats, 300)
    (b, addr, a, n_pages, o), = calls
    host = np.ctypeslib.as_array((ctypes.c_int64 * (2 * a)).from_address(
        addr))
    assert (b, a, n_pages, o) == (buf.data_ptr(), 5, 300, out.data_ptr())
    assert np.array_equal(host, buf[:K.TABLE_BYTES * 5].view(
        torch.int64).numpy())
    assert host.tolist() == [v for f in st.flats for v in (f.map, f.pages)]


def test_round_past_max_flats_splits_launches(monkeypatch):
    n, n_pages = K.MAX_FLATS + 6, 37
    flats = _mixed_round(np.random.default_rng(12), n, n_pages)
    up = U.Uploader("cpu")
    st = up.stage(flats)
    buf = up.send(st)
    got = up.expand(st, buf)
    assert np.array_equal(got.numpy(), np.stack(flats))
    calls = _stub_call(monkeypatch)
    out = torch.empty(n * n_pages * PAGE, dtype=torch.int16)
    counts = (K.launches, K.pages, K.plain_calls)
    K.expand_pages(_OnCuda(out), _OnCuda(buf), st.flats, n_pages)
    m, o, step = K.MAX_FLATS, out.data_ptr(), n_pages * K.PAGE_BYTES
    assert calls == [(buf.data_ptr(), st.flats.addr, m, n_pages, o),
                     (buf.data_ptr(), st.flats.addr + K.TABLE_BYTES * m, 6,
                      n_pages, o + m * step)]
    assert (K.launches, K.pages, K.plain_calls) == (
        counts[0] + 2, counts[1] + n * n_pages, counts[2])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2027)
    n = 300 * PAGE
    flats = []
    for density in (0.05, 1.0, 0.0, 0.5):
        f = rng.integers(-2000, 2000, n, dtype=np.int16)
        f.reshape(-1, PAGE)[rng.random(300) >= density] = 0
        flats.append(f)
    aux = rng.integers(-5, 5, 7, dtype=np.int16)
    up = U.Uploader(dev)
    st = up.stage(flats, aux)
    assert [f.map < 0 for f in st.flats] == [False, True, False, False]
    buf = up.send(st)
    launches = K.launches
    got = up.expand(st, buf)
    assert K.launches == launches + 1
    plain = K.expand_pages_plain(torch.empty_like(got), buf, st.flats, 300)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(), np.stack(flats))
    assert np.array_equal(up.aux(st, buf).cpu().numpy(), aux)


@pytest.mark.cuda
@pytest.mark.parametrize("n_flats,n_pages", [(16, 2406), (16, 37),
                                             (K.MAX_FLATS + 6, 37)])
def test_kernel_runs_across_flats_on_card(n_flats, n_pages):
    """Runs of zero and nonzero pages that cross the flats' boundaries
    and the kernel's runs, in a 16-flat round (nc03's page count, and one
    that is no multiple of a run) and past MAX_FLATS (two launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    flats = _mixed_round(np.random.default_rng(n_flats + n_pages), n_flats,
                         n_pages)
    up = U.Uploader(dev)
    st = up.stage(flats)
    buf = up.send(st)
    launches = K.launches
    got = up.expand(st, buf)
    assert K.launches == launches + -(-n_flats // K.MAX_FLATS)
    plain = K.expand_pages_plain(torch.empty_like(got), buf, st.flats,
                                 n_pages)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(), np.stack(flats))
