"""The port's VP8 decoder (cuda_vp9_torch/vp8, on the host) through the
port's codec API with `vp8_dx()`:

  * every VP8 fixture, whole, MD5-exact against its golden file (the
    five of 176x144 or smaller here; v8kf02, v8in02, v8in04 and v8in05
    are marked slow, v8in04 alone taking about 17 s on one core);
  * byte for byte against the JAX package's VP8 decoder (its modules
    import no JAX) on the same packets: error concealment on v8in01
    (frame 2 cut to half, to 85 % and to 10 bytes, the mode partition's
    loss: planes, the corrupt flag and the header's refresh flags),
    postproc on v8in01's first 4 frames (the default DEBLOCK|DEMACROBLOCK
    at level 4, which leaves these frames as they are; through
    VP8_SET_POSTPROC, ADDNOISE with a seeded NoiseState, and
    DEBLOCK|DEMACROBLOCK|MFQE at level 8, which change them), MFQE's blend
    itself on a frame where its gate opens (it needs more than 10 frames
    and a drop in quality, which the first frames of a fixture do not
    give), and VP8_SET_REFERENCE / VP8_COPY_REFERENCE;
  * the init flags: the VP9 iface refuses USE_POSTPROC and
    USE_ERROR_CONCEALMENT, the VP8 iface takes each; a corrupt VP8
    packet without EC returns VPX_CODEC_CORRUPT_FRAME;
  * the last frame's q index, refresh flags and references used, through
    their controls, against the JAX package's decoder state.
"""

import functools

import numpy as np
import pytest

import cuda_vp9_tpu.codec as J
import cuda_vp9_torch.codec as P
from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.utils.md5 import frame_md5

from conftest import FIXTURES

SMALL = ("v8kf01_176x144", "v8kf03_odd_98x66", "v8in01_176x144",
         "v8br01_176x144_vbr", "v8in03_176x144_lowq")
LARGE = ("v8kf02_320x240", "v8in02_320x240", "v8in04_640x480",
         "v8in05_352x288_static")
IN01 = "v8in01_176x144"


def _packets(name, n=None):
    with IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        return [d for d, _ in r][:n]


def _open(api, flags=0, iface=None):
    ctx = api.CodecCtx()
    assert api.vpx_codec_dec_init(ctx, iface or api.vp8_dx(), api.DecCfg(),
                                  flags) == api.VPX_CODEC_OK
    return ctx


def _drain(api, ctx):
    out = []
    it = api.FrameIter()
    while (img := api.vpx_codec_get_frame(ctx, it)) is not None:
        out.append([np.asarray(p).copy() for p in img.planes])
    return out


def test_vp8_iface_is_on_the_host():
    iface = P.vp8_dx()
    assert "host" in iface.name and not hasattr(iface, "device")
    ctx = _open(P)
    assert ctx._recon is None and ctx.name == iface.name


@pytest.mark.parametrize("name", list(SMALL) + [
    pytest.param(n, marks=pytest.mark.slow) for n in LARGE])
def test_vp8_stream_matches_golden(name):
    want = [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]
    ctx = _open(P)
    got = []
    for data in _packets(name):
        assert P.vpx_codec_decode(ctx, data) == P.VPX_CODEC_OK
        got += [frame_md5(p) for p in _drain(P, ctx)]
    assert got == want


def _run(api, pkts, flags=0, setup=None):
    """Decode `pkts` through `api`'s codec API; per packet: (rc, frames,
    corrupt flag, (refresh_last, refresh_golden, refresh_alt))."""
    ctx = _open(api, flags)
    if setup is not None:
        setup(api, ctx)
    out = []
    for data in pkts:
        rc = api.vpx_codec_decode(ctx, data)
        h = ctx._dec._dec.hdr
        out.append((rc, _drain(api, ctx),
                    api.vpx_codec_control(ctx, api.VP8D_GET_FRAME_CORRUPTED),
                    (h.refresh_last, h.refresh_golden, h.refresh_alt)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (rc, fa, ca, ra), (rc_b, fb, cb, rb) in zip(a, b):
        assert (rc, ca, ra) == (rc_b, cb, rb)
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            for x, y in zip(pa, pb):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("cut", [0.5, 0.85, 10])
def test_error_concealment_matches_jax(cut):
    pkts = _packets(IN01, 4)
    k = 2
    n = cut if isinstance(cut, int) else int(len(pkts[k]) * cut)
    pkts[k] = pkts[k][:n]
    got = _run(P, pkts, P.VPX_CODEC_USE_ERROR_CONCEALMENT)
    want = _run(J, pkts, J.VPX_CODEC_USE_ERROR_CONCEALMENT)
    _same(got, want)
    # frame 3 predicts from the concealed frame, so it is flagged too
    assert [c for _, _, c, _ in got] == [0, 0, 1, 1]
    assert all(rc == P.VPX_CODEC_OK and len(f) == 1 for rc, f, _, _ in got)
    if cut == 10:
        # a corrupt frame refreshes neither golden nor altref
        assert got[k][3][1:] == (0, 0)


@functools.cache
def _plain_in01():
    return _run(P, _packets(IN01, 4))


def _postproc(flags, level, noise_level, seed):
    def setup(api, ctx):
        assert api.vpx_codec_control(
            ctx, api.VP8_SET_POSTPROC,
            api.PostProcCfg(flags, level, noise_level)) == api.VPX_CODEC_OK
        if seed is not None:
            import importlib
            pp = importlib.import_module(
                api.__name__.split(".")[0] + ".vp8.postproc")
            ctx._dec._noise = pp.NoiseState(seed)
    return setup


@pytest.mark.parametrize("cfg", [
    None, (P.VP8D_ADDNOISE, 4, 4, 2024),
    (P.VP8D_DEBLOCK | P.VP8D_DEMACROBLOCK | P.VP8D_MFQE, 8, 0, None)],
    ids=["default", "addnoise", "mfqe_level8"])
def test_postproc_matches_jax(cfg):
    pkts = _packets(IN01, 4)
    setup = None if cfg is None else _postproc(*cfg)
    got = _run(P, pkts, P.VPX_CODEC_USE_POSTPROC, setup)
    _same(got, _run(J, pkts, J.VPX_CODEC_USE_POSTPROC, setup))
    changed = [any(not np.array_equal(x, y)
                   for x, y in zip(a[1][0], b[1][0]))
               for a, b in zip(got, _plain_in01())]
    assert changed == [cfg is not None] * 4


def test_mfqe_blend_matches_jax():
    """The MFQE gate opens (more than 10 frames, a good q trail, a jump
    of 20 or more) on the same state in both packages: the blended,
    deblocked frames are equal byte for byte and differ from the frame
    without MFQE."""
    from cuda_vp9_tpu import vp8 as jvp8
    from cuda_vp9_torch import vp8 as pvp8
    from cuda_vp9_torch.vp8 import postproc as pp

    rng = np.random.default_rng(13)
    H, W = 32, 48
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    nxt = [np.clip(p.astype(int) + rng.integers(-2, 3, p.shape), 0,
                   255).astype(np.uint8) for p in planes]

    class Dec:
        pp_skip = np.ones((H // 16, W // 16), bool)
        pp_filter_level = 20
        pp_mode = np.zeros((H // 16, W // 16), np.int64)
        pp_mvs = np.zeros((H // 16, W // 16, 2), np.int64)
        pp_bmvs = np.zeros((H // 16, W // 16, 16, 2), np.int64)
        pp_frame_type = 1

    class Hdr:
        width, height = W, H

    def run(mod, flags):
        sd = mod.Vp8StreamDecoder(use_postproc=True)
        sd.postproc_cfg = (flags, 4, 0)
        sd._pp_frames = 20
        sd._dec = Dec()
        outs = []
        for cur, q, last_q in ((planes, 80, 40), (nxt, 80, 30)):
            sd._dec.pp_planes = tuple(cur)
            sd._dec.pp_base_qindex = q
            sd._pp_last_q = last_q
            outs.append([p.copy() for p in sd._postproc(Hdr, None)])
        return outs

    flags = pp.VP8D_MFQE | pp.VP8D_DEBLOCK
    got, want = run(pvp8, flags), run(jvp8, flags)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    without = run(pvp8, pp.VP8D_DEBLOCK)
    assert not np.array_equal(got[1][0], without[1][0])


def test_set_and_copy_reference_match_jax():
    pkts = _packets(IN01, 3)
    w, h = 176, 144
    newref = [np.full((h, w), 99, np.uint8),
              np.full((h // 2, w // 2), 50, np.uint8),
              np.full((h // 2, w // 2), 200, np.uint8)]
    res = {}
    for api in (P, J):
        ctx = _open(api)
        shown = []
        for p in pkts[:2]:
            assert api.vpx_codec_decode(ctx, p) == api.VPX_CODEC_OK
            shown += _drain(api, ctx)
        copies = []
        for ft in (api.VP8_LAST_FRAME, api.VP8_GOLD_FRAME,
                   api.VP8_ALTR_FRAME):
            rf = api.RefFrame(ft)
            assert api.vpx_codec_control(ctx, api.VP8_COPY_REFERENCE,
                                         rf) == api.VPX_CODEC_OK
            copies.append(rf.planes)
        for p in range(3):
            assert np.array_equal(copies[0][p], shown[-1][p])
        assert api.vpx_codec_control(
            ctx, api.VP8_SET_REFERENCE,
            api.RefFrame(api.VP8_LAST_FRAME, newref)) == api.VPX_CODEC_OK
        rf = api.RefFrame(api.VP8_LAST_FRAME)
        assert api.vpx_codec_control(ctx, api.VP8_COPY_REFERENCE,
                                     rf) == api.VPX_CODEC_OK
        for p in range(3):
            assert np.array_equal(rf.planes[p], newref[p])
        # wrong dimensions are refused
        assert api.vpx_codec_control(
            ctx, api.VP8_SET_REFERENCE,
            api.RefFrame(api.VP8_GOLD_FRAME,
                         [x[:-2] for x in newref])) == api.VPX_CODEC_ERROR
        # the next frame predicts from the set reference
        assert api.vpx_codec_decode(ctx, pkts[2]) == api.VPX_CODEC_OK
        res[api] = (copies, _drain(api, ctx))
    (pc, pf), (jc, jf) = res[P], res[J]
    for a, b in zip(pc + pf, jc + jf):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("flag", ["USE_POSTPROC", "USE_ERROR_CONCEALMENT"])
def test_init_flags(flag):
    f = getattr(P, f"VPX_CODEC_{flag}")
    ctx = P.CodecCtx()
    assert P.vpx_codec_dec_init(ctx, P.vp9_dx_torch("cpu"), P.DecCfg(),
                                f) == P.VPX_CODEC_INCAPABLE
    ctx = P.CodecCtx()
    assert P.vpx_codec_dec_init(ctx, P.vp8_dx(), P.DecCfg(),
                                f) == P.VPX_CODEC_OK
    assert ctx._dec.use_postproc == (flag == "USE_POSTPROC")
    assert ctx._dec._dec.ec_enabled == (flag == "USE_ERROR_CONCEALMENT")


def test_set_postproc_is_vp8_only():
    ctx = P.CodecCtx()
    assert P.vpx_codec_dec_init(ctx, P.vp9_dx_torch("cpu"),
                                P.DecCfg()) == P.VPX_CODEC_OK
    cfg = P.PostProcCfg(P.VP8D_DEBLOCK)
    assert P.vpx_codec_control(ctx, P.VP8_SET_POSTPROC,
                               cfg) == P.VPX_CODEC_INCAPABLE
    ctx = _open(P, P.VPX_CODEC_USE_POSTPROC)
    assert P.vpx_codec_control(ctx, P.VP8_SET_POSTPROC,
                               cfg) == P.VPX_CODEC_OK
    assert ctx._dec.postproc_cfg == (P.VP8D_DEBLOCK, 4, 0)


def test_last_frame_controls():
    """VPXD_GET_LAST_QUANTIZER, VP8D_GET_LAST_REF_UPDATES and
    VP8D_GET_LAST_REF_USED after each of v8in01's first 8 frames equal
    what the JAX package's VP8 decoder holds for that frame (its header's
    q index and refresh flags, and the references its macroblocks predict
    from), as vp8_dx_iface.c reports them."""
    from cuda_vp9_tpu.vp8.decoder import Vp8Decoder
    jdec = Vp8Decoder()
    ctx = _open(P)
    got, want = [], []
    for data in _packets(IN01, 8):
        assert P.vpx_codec_decode(ctx, data) == P.VPX_CODEC_OK
        got.append(tuple(P.vpx_codec_control(ctx, c) for c in (
            P.VPXD_GET_LAST_QUANTIZER, P.VP8D_GET_LAST_REF_UPDATES,
            P.VP8D_GET_LAST_REF_USED)))
        h, _ = jdec.decode(data)
        refs = jdec._lf_refs
        want.append((
            h.base_qindex,
            h.refresh_last * P.VP8_LAST_FRAME
            + h.refresh_golden * P.VP8_GOLD_FRAME
            + h.refresh_alt * P.VP8_ALTR_FRAME,
            sum(flag for ref, flag in ((1, P.VP8_LAST_FRAME),
                                       (2, P.VP8_GOLD_FRAME),
                                       (3, P.VP8_ALTR_FRAME))
                if (refs == ref).any())))
    assert got == want
    # the key frame refreshes every reference and predicts from none;
    # the stream refreshes golden once, and predicts from it at times
    assert got[0][1:] == (7, 0) and all(q > 0 for q, _, _ in got)
    assert {u for _, u, _ in got[1:]} == {1, 3}
    assert {r for _, _, r in got[1:]} == {1, 3}


def test_corrupt_packet_without_ec_is_reported():
    pkts = _packets(IN01, 3)
    ctx = _open(P)
    for p in pkts[:2]:
        assert P.vpx_codec_decode(ctx, p) == P.VPX_CODEC_OK
    assert P.vpx_codec_decode(ctx, pkts[2][:10]) == P.VPX_CODEC_CORRUPT_FRAME
    assert P.vpx_codec_control(ctx, P.VP8D_GET_FRAME_CORRUPTED) == 1
    assert P.vpx_codec_error(ctx) == "Corrupt frame detected"
