"""The port's encode side against the JAX package's, on the CPU.

The same seeded numpy frames go through both packages' encoders:

  * `Vp9Encoder` packets are equal byte for byte: keyframes at block
    sizes 8 and 64, an odd size, gop > 1 with NEWMV on panning content,
    lossless, 10-bit, 1-pass rate control, segmentation (a ROI map and
    vpxenc's variance AQ), 2-pass, and a `Vp9SvcEncoder` superframe pair
    (the top layer predicts from the scaled base layer);
  * `Vp8Encoder` packets, `IvfWriter` bytes, the `Y4mReader` variants,
    and the files `vpxenc main()` writes (VP9 .ivf, VP9 .webm, VP8 .ivf)
    are equal byte for byte;
  * every VP9 stream, decoded by the port (`TorchRecon("cpu")`), gives
    per frame the MD5 of the encoder's own reconstruction, and, where the
    normative oracle (libavcodec, `tools/oracle`) builds, the oracle's
    MD5s too;
  * the port's `BoolEncoder` / `BoolDecoder` pair round-trips.

The cases are small (64x64 to 176x144, 2 or 3 frames).  Tier-1 holds
those at 64x64 to 98x80 and the CLIs (about 15 s serial); `slow` holds
the three whose two encodes take 4 to 6 s each (210x122 with an inter
frame, the 176x144 pan with NEWMV, rate control over 3 noisy frames) and
vpxenc's AQ + 2-pass run.
"""

import importlib
import io
import random
import subprocess

import numpy as np
import pytest
import torch

from cuda_vp9_torch.containers import IvfReader
from cuda_vp9_torch.decoder import constants as C
from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
from cuda_vp9_torch.runtime.pipeline import TorchRecon
from cuda_vp9_torch.utils.md5 import frame_md5

from conftest import ORACLE_BIN

torch.set_num_threads(1)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _make_frames(w, h, n, bd=8, seed=5, noise=8):
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    mid = 1 << (bd - 1)
    amp = mx // 4
    dt = np.uint16 if bd > 8 else np.uint8
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    yy, xx = np.mgrid[0:h, 0:w]
    cyy, cxx = np.mgrid[0:ch, 0:cw]
    out = []
    for t in range(n):
        y = ((mid + amp * np.sin(xx / 17.0 + t) * np.cos(yy / 11.0))
             + rng.integers(-noise, noise + 1, (h, w))).clip(0, mx)
        u = (mid + amp * np.sin(cxx / 23.0 + t)).clip(0, mx)
        v = (mid + amp * np.cos(cyy / 19.0 - t)).clip(0, mx)
        out.append([y.astype(dt), u.astype(dt), v.astype(dt)])
    return out


def _panning_frames(w, h, n, seed=9, dx=3, dy=2):
    rng = np.random.default_rng(seed)
    pad = 8 * n
    base = rng.integers(0, 256, (h + pad, w + pad), np.uint8)
    base = ((base.astype(np.int32) + np.roll(base, 1, 0)
             + np.roll(base, 1, 1) + np.roll(base, -1, 0)) // 4
            ).astype(np.uint8)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return [[base[t * dy:t * dy + h, t * dx:t * dx + w].copy(),
             np.full((ch, cw), 120, np.uint8),
             np.full((ch, cw), 130, np.uint8)] for t in range(n)]


def _recon_md5(enc):
    """MD5 of the encoder's in-loop reconstruction, cropped to its frame."""
    w, h = enc.width, enc.height
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    dt = np.uint8 if enc.bit_depth == 8 else np.uint16
    y, u, v = enc._last_recon
    return frame_md5([np.asarray(y)[:h, :w].astype(dt),
                      np.asarray(u)[:ch, :cw].astype(dt),
                      np.asarray(v)[:ch, :cw].astype(dt)])


def _encode(pkg, frames, seg=None, **kw):
    """(packets, per-frame recon MD5s) of one package's Vp9Encoder;
    `seg` maps a frame index to set_segmentation's arguments."""
    enc = _mod(pkg, "encoder").Vp9Encoder(frames[0][0].shape[1],
                                          frames[0][0].shape[0], **kw)
    pkts, md5s = [], []
    for i, fr in enumerate(frames):
        if seg and i in seg:
            enc.set_segmentation(*seg[i](enc))
        pkts.append(enc.encode_frame(fr))
        md5s.append(_recon_md5(enc))
    return pkts, md5s


def _port_md5s(pkts):
    """Per shown frame MD5 of the port's decode on the CPU."""
    dec = NativeVp9Decoder(recon_fn=TorchRecon("cpu"))
    out = []
    for p in pkts:
        dec.decode(p)
        out.extend(frame_md5(fr.visible_planes()) for fr in dec.frames())
    return out


def _oracle_md5s(tmp_path, pkts, w, h):
    """The normative oracle's per-frame MD5s, or None where it does not
    build (no libavcodec)."""
    import make_fixtures        # tools/, on the path through conftest
    try:
        make_fixtures.build_oracle()
    except Exception:
        return None
    ivf = tmp_path / "oracle_in.ivf"
    with open(ivf, "wb") as f:
        wr = _mod("cuda_vp9_torch", "containers").IvfWriter(f, b"VP90", w, h)
        for i, p in enumerate(pkts):
            wr.write_frame(p, i)
        wr.close()
    md5 = tmp_path / "oracle.md5"
    r = subprocess.run([ORACLE_BIN, "decode", str(ivf), str(md5)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return [ln.split()[0] for ln in md5.read_text().splitlines()]


def _check_vp9(tmp_path, frames, seg=None, **kw):
    """Both encoders byte for byte; the port's decode (and the oracle's)
    equal to the encoder's reconstruction, frame by frame."""
    pkts, md5s = _encode("cuda_vp9_torch", frames, seg, **kw)
    want, want_md5s = _encode("cuda_vp9_tpu", frames, seg, **kw)
    assert len(pkts) == len(want) == len(frames)
    for i, (p, q) in enumerate(zip(pkts, want)):
        assert p == q, f"packet {i} differs"
    assert md5s == want_md5s
    assert _port_md5s(pkts) == md5s
    h, w = frames[0][0].shape
    oracle = _oracle_md5s(tmp_path, pkts, w, h)
    if oracle is not None:
        assert oracle == md5s
    return pkts


def _seg_roi(enc):
    seg = np.zeros((enc.mi_rows, enc.mi_cols), np.int32)
    seg[2:6, 3:9] = 1
    seg[:2, :] = 2
    return seg, [0, -70, 40]


_SLOW = pytest.mark.slow


@pytest.mark.parametrize("case", [
    "key_64x64_bs8", "key_64x64_bs64", "odd_98x66_bs64", "lossless",
    "10bit", "segmentation",
    pytest.param("odd_210x122_gop2", marks=_SLOW),
    pytest.param("newmv_pan", marks=_SLOW),
    pytest.param("rate_control", marks=_SLOW)])
def test_vp9_encoder_matches_jax(tmp_path, case):
    if case == "key_64x64_bs8":
        _check_vp9(tmp_path, _make_frames(64, 64, 2), base_qindex=60,
                   block_size=C.BLOCK_8X8)
    elif case == "key_64x64_bs64":
        _check_vp9(tmp_path, _make_frames(64, 64, 2), base_qindex=60,
                   block_size=C.BLOCK_64X64)
    elif case == "odd_98x66_bs64":
        _check_vp9(tmp_path, _make_frames(98, 66, 2), base_qindex=80,
                   block_size=C.BLOCK_64X64)
    elif case == "odd_210x122_gop2":
        _check_vp9(tmp_path, _make_frames(210, 122, 2), base_qindex=90,
                   gop=2)
    elif case == "newmv_pan":
        _check_vp9(tmp_path, _panning_frames(176, 144, 3), base_qindex=60,
                   gop=3)
        enc = _mod("cuda_vp9_torch", "encoder").Vp9Encoder(
            176, 144, base_qindex=60, gop=3)
        for fr in _panning_frames(176, 144, 3):
            enc.encode_frame(fr)
        assert enc.mode_counts[C.NEWMV] > 0, enc.mode_counts
    elif case == "lossless":
        rng = np.random.default_rng(9)
        fr = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((64, 64), (32, 32), (32, 32))]
        _check_vp9(tmp_path, [fr, fr], lossless=True,
                   block_size=C.BLOCK_8X8, mode_search=False)
    elif case == "10bit":
        _check_vp9(tmp_path, _make_frames(96, 80, 2, bd=10),
                   base_qindex=60, bit_depth=10, gop=2)
    elif case == "rate_control":
        _check_vp9(tmp_path, _make_frames(96, 80, 3, noise=24),
                   base_qindex=40, gop=3, target_bitrate_kbps=120, fps=30.0)
    elif case == "segmentation":
        _check_vp9(tmp_path, _make_frames(96, 80, 3, noise=10),
                   seg={0: _seg_roi,
                        2: lambda enc: (None, None)},
                   base_qindex=110, gop=9999)
    else:
        raise AssertionError(case)


def test_svc_superframes_match_jax(tmp_path):
    """Two spatial layers: the top layer predicts from the base layer's
    reconstruction, scaled 2x (a scaled reference)."""
    frames = _make_frames(128, 96, 2)
    out = {}
    for pkg in ("cuda_vp9_torch", "cuda_vp9_tpu"):
        enc = _mod(pkg, "encoder.svc").Vp9SvcEncoder(128, 96, n_layers=2,
                                                     base_qindex=100, gop=2)
        pkts, md5s = [], []
        for fr in frames:
            pkts.append(enc.encode_frame(fr))
            md5s.append(_recon_md5(enc.layers[-1]))
        out[pkg] = (pkts, md5s)
    pkts, md5s = out["cuda_vp9_torch"]
    assert pkts == out["cuda_vp9_tpu"][0]
    assert md5s == out["cuda_vp9_tpu"][1]
    assert _port_md5s(pkts) == md5s
    oracle = _oracle_md5s(tmp_path, pkts, 128, 96)
    if oracle is not None:
        assert oracle == md5s


def test_vp8_encoder_packets_match_jax():
    frames = _make_frames(96, 64, 3)
    out = {}
    for pkg in ("cuda_vp9_torch", "cuda_vp9_tpu"):
        enc = _mod(pkg, "vp8").Vp8Encoder(96, 64, qindex=40, filter_level=20,
                                          kf_interval=3)
        out[pkg] = [enc.encode_frame(fr) for fr in frames]
    assert out["cuda_vp9_torch"] == out["cuda_vp9_tpu"]


def test_ivf_writer_bytes_match_jax():
    rng = np.random.default_rng(3)
    pkts = [rng.integers(0, 256, n, np.uint8).tobytes() for n in (5, 0, 77)]
    out = {}
    for pkg in ("cuda_vp9_torch", "cuda_vp9_tpu"):
        buf = io.BytesIO()
        wr = _mod(pkg, "containers").IvfWriter(buf, b"VP90", 352, 288, 25, 1)
        for i, p in enumerate(pkts):
            wr.write_frame(p, 3 * i)
        wr.close()
        out[pkg] = buf.getvalue()
    assert out["cuda_vp9_torch"] == out["cuda_vp9_tpu"]
    with IvfReader(io.BytesIO(out["cuda_vp9_torch"])) as r:
        assert [(d, pts) for d, pts in r] == [(p, 3 * i)
                                             for i, p in enumerate(pkts)]


@pytest.mark.parametrize("tag", ["C420mpeg2", "C420jpeg", "C420p10"])
def test_y4m_reader_variants_match_jax(tmp_path, tag):
    w, h = 32, 24
    bd = 10 if tag.endswith("p10") else 8
    frames = _make_frames(w, h, 2, bd=bd)
    p = tmp_path / "v.y4m"
    with open(p, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 {tag}\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            for pl in fr:
                f.write(pl.astype("<u2" if bd > 8 else np.uint8).tobytes())
    raw = tmp_path / "v.yuv"
    raw.write_bytes(b"".join(pl.tobytes() for pl in frames[0]))
    got = {}
    for pkg in ("cuda_vp9_torch", "cuda_vp9_tpu"):
        y4m = _mod(pkg, "containers.y4m")
        r = y4m.Y4mReader(str(p))
        meta = (r.width, r.height, r.fps, getattr(r, "bit_depth", 8))
        fr = [r.read_frame() for _ in range(3)]
        assert fr[2] is None
        rr = y4m.open_raw_video(str(raw), w, h)
        got[pkg] = (meta, [[np.asarray(x) for x in f] for f in fr[:2]],
                    [np.asarray(x) for x in rr.read_frame()])
    (meta, fr, raw0), (wmeta, wfr, wraw0) = (got["cuda_vp9_torch"],
                                             got["cuda_vp9_tpu"])
    assert meta == wmeta and meta[:3] == (w, h, (25, 1))
    for a, b in zip(sum(fr, []) + raw0, sum(wfr, []) + wraw0):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(fr[1], frames[1]):
        assert np.array_equal(a, b)


def _write_yuv(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(np.asarray(p).tobytes())


def _recording(cls, top=lambda enc: enc):
    """A subclass of an encoder class that records, after each frame,
    the MD5 of the reconstruction of `top(self)` in `.recon_md5s`."""
    class Recording(cls):
        def encode_frame(self, *args, **kw):
            out = super().encode_frame(*args, **kw)
            self.__dict__.setdefault("recon_md5s", []).append(
                _recon_md5(top(self)))
            Recording.last = self
            return out
    return Recording


def _cli_pair(tmp_path, monkeypatch, tool, frames, out_name, *args,
              enc_name="Vp9Encoder", top=lambda enc: enc):
    """Run both packages' `tool` main() on one .yuv.  Returns the two
    files' bytes, the port's output path and, for a VP9 encode, the MD5s
    of the port's encoder's reconstruction, frame by frame."""
    h, w = frames[0][0].shape
    yuv = tmp_path / "src.yuv"
    _write_yuv(yuv, frames)
    res = {}
    for pkg in ("cuda_vp9_torch", "cuda_vp9_tpu"):
        mod = _mod(pkg, f"tools.{tool}")
        if pkg == "cuda_vp9_torch":
            rec = _recording(getattr(mod, enc_name), top)
            monkeypatch.setattr(mod, enc_name, rec)
        out = tmp_path / f"{pkg}_{out_name}"
        rc = mod.main([str(yuv), "-o", str(out), "--width", str(w),
                       "--height", str(h), *args])
        assert rc == 0
        res[pkg] = out
    md5s = getattr(getattr(rec, "last", None), "recon_md5s", None)
    return (res["cuda_vp9_torch"].read_bytes(),
            res["cuda_vp9_tpu"].read_bytes(), res["cuda_vp9_torch"], md5s)


def _ivf_packets(path):
    with IvfReader(str(path)) as r:
        return [d for d, _ in r]


def _webm_packets(path):
    from cuda_vp9_torch.containers import WebmReader
    with WebmReader(str(path)) as r:
        return [d for d, _ in r]


@pytest.mark.parametrize("case", [
    "vp9_ivf", "vp9_webm", "vp8_ivf",
    pytest.param("vp9_aq_2pass", marks=_SLOW)])
def test_vpxenc_matches_jax(tmp_path, monkeypatch, case):
    """vpxenc main() byte for byte; each VP9 file decoded by the port to
    the reconstruction of the encoder that vpxenc ran."""
    args = {"vp9_ivf": ("o.ivf", "--qindex", "70", "--kf-max-dist", "2"),
            "vp9_webm": ("o.webm", "--kf-max-dist", "3", "--block-size",
                         "32"),
            "vp8_ivf": ("o.ivf", "--codec", "vp8", "--kf-max-dist", "3"),
            "vp9_aq_2pass": ("o.ivf", "--aq-mode", "1", "--passes", "2",
                             "--target-bitrate", "150", "--kf-max-dist",
                             "4")}[case]
    frames = (_make_frames(96, 80, 4, noise=14) if case == "vp9_aq_2pass"
              else _make_frames(64, 48, 2) if case == "vp9_ivf"
              else _make_frames(96, 64, 3))
    got, want, path, md5s = _cli_pair(tmp_path, monkeypatch, "vpxenc",
                                      frames, *args)
    assert got == want
    if case == "vp8_ivf":
        from cuda_vp9_torch.vp8 import Vp8StreamDecoder
        dec = Vp8StreamDecoder()
        n = 0
        for p in _ivf_packets(path):
            dec.decode(p)
            n += len(list(dec.frames()))
        assert n == 3 and md5s is None
        return
    pkts = (_webm_packets if case == "vp9_webm" else _ivf_packets)(path)
    assert len(md5s) == len(frames)
    assert _port_md5s(pkts) == md5s
    if case == "vp9_aq_2pass":
        h, w = frames[0][0].shape
        oracle = _oracle_md5s(tmp_path, pkts, w, h)
        if oracle is not None:
            assert oracle == md5s


def test_svc_cli_matches_jax(tmp_path, monkeypatch):
    """vp9_spatial_svc_encoder main(): two layers, byte for byte; the
    shown (top) layer decoded by the port to its reconstruction."""
    got, want, path, md5s = _cli_pair(
        tmp_path, monkeypatch, "vp9_spatial_svc_encoder",
        _make_frames(64, 48, 2), "o.ivf", enc_name="Vp9SvcEncoder",
        top=lambda enc: enc.layers[-1])
    assert got == want
    assert len(md5s) == 2 and _port_md5s(_ivf_packets(path)) == md5s


def test_bool_coder_roundtrip():
    from cuda_vp9_torch.decoder.bitreader import BitReader, BoolDecoder
    from cuda_vp9_torch.encoder.bitwriter import BitWriter, BoolEncoder
    rng = random.Random(7)
    for _ in range(30):
        seq = [(rng.randrange(2), rng.randrange(1, 256))
               for _ in range(rng.randrange(1, 300))]
        enc = BoolEncoder()
        for bit, p in seq:
            enc.write(bit, p)
        dec = BoolDecoder(enc.stop())
        assert not dec.marker_bad
        assert [dec.read(p) for _, p in seq] == [b for b, _ in seq]
    w = BitWriter()
    w.f(0x2, 2)
    w.f(12345, 16)
    w.sf(-13, 6)
    r = BitReader(w.data())
    assert (r.f(2), r.f(16), r.sf(6)) == (0x2, 12345, -13)
