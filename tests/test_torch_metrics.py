"""The port's quality metrics (torch) against the JAX package's (numpy),
on the CPU (`device="cpu"`).

Seeded frames at bit depths 8, 10 and 12 and odd sizes (66x50 among
them) go through `cuda_vp9_torch.tools.metrics` / `tiny_ssim` and
`cuda_vp9_tpu.tools.metrics` / `tiny_ssim`:

  * the SSE, the sample counts and the PSNR are equal exactly (int64
    sums on both sides, the same float formula on the host);
  * SSIM, FastSSIM and PSNR-HVS agree within TOL = 1e-10 absolute (the
    float64 reductions sum in another order; FastSSIM's dB conversion
    amplifies that most, about 1e-12 at these sizes);
  * the FastSSIM structure kernel (a float64 correlation) equals the
    sliding-column recurrence `_fs_structure_scalar`, boundaries
    included, the integer DCT and the closed-form luminance term equal
    the JAX package's exactly;
  * both CLIs with `--device cpu` print what the JAX package's print, on
    a .yuv pair and on an .ivf against its decoded .yuv; with
    `--device cuda` and no card they fail.
"""

import numpy as np
import pytest
import torch

from cuda_vp9_torch.tools import metrics as P
from cuda_vp9_torch.tools import tiny_ssim as PT
from cuda_vp9_tpu.tools import metrics as J
from cuda_vp9_tpu.tools import tiny_ssim as JT

from conftest import FIXTURES

torch.set_num_threads(1)
TOL = 1e-10
CPU = "cpu"


def _planes(rng, w, h, bd):
    mx = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return [rng.integers(0, mx + 1, s).astype(dt)
            for s in ((h, w), (ch, cw), (ch, cw))]


def _perturb(planes, rng, mag, bd):
    return [np.clip(p.astype(np.int64) + rng.integers(-mag, mag + 1, p.shape),
                    0, (1 << bd) - 1).astype(p.dtype) for p in planes]


_CASES = [(bd, w, h) for bd in (8, 10, 12)
          for w, h in ((66, 50), (17, 9), (130, 98))]


def _pair(bd, w, h):
    rng = np.random.default_rng(bd * 1000 + w)
    a = _planes(rng, w, h, bd)
    return a, _perturb(a, rng, 5 << (bd - 8), bd)


@pytest.mark.parametrize("bd,w,h", _CASES)
def test_metrics_match_jax(bd, w, h):
    a, b = _pair(bd, w, h)
    for in_bd in sorted({8, bd}):
        assert P.calc_psnr(a, b, bd, in_bd, device=CPU) == \
            J.calc_psnr(a, b, bd, in_bd)
        got = P.calc_ssim(a, b, bd, in_bd, device=CPU)
        want = J.calc_ssim(a, b, bd, in_bd)
        assert got[1] == want[1] and abs(got[0] - want[0]) <= TOL
        for f in ("calc_fastssim", "psnrhvs"):
            got = getattr(P, f)(a, b, bd, in_bd, device=CPU)
            want = getattr(J, f)(a, b, bd, in_bd)
            assert np.abs(np.subtract(got, want)).max() <= TOL, (f, got, want)
    assert P.plane_sse(a[0], b[0], device=CPU) == J.plane_sse(a[0], b[0])
    assert abs(P.ssim2(a[1], b[1], bd, device=CPU)
               - J.ssim2(a[1], b[1], bd)) <= TOL


@pytest.mark.parametrize("bd,w,h", _CASES)
def test_tiny_ssim_matches_jax(bd, w, h):
    a, b = _pair(bd, w, h)
    got = PT.frame_metrics(a, b, bd, device=CPU)
    want = JT.frame_metrics(a, b, bd)
    assert got[0] == want[0] and got[4:] == want[4:]
    assert max(abs(got[i] - want[i]) for i in (1, 2, 3)) <= TOL
    assert abs(PT.ssim2(a[0], b[0], bd, device=CPU)
               - JT.ssim2(a[0], b[0], bd)) <= TOL


def test_identical_frames_give_the_caps():
    a, _ = _pair(8, 66, 50)
    assert P.calc_psnr(a, a, device=CPU)["psnr"] == [P.MAX_PSNR] * 4
    assert P.calc_fastssim(a, a, device=CPU)[0] == P.MAX_SSIM_DB
    assert P.psnrhvs(a, a, device=CPU)[0] == P.MAX_PSNR


@pytest.mark.parametrize("shape", [(16, 16), (21, 17), (40, 56)])
def test_fs_structure_kernel_matches_recurrence(shape):
    """The correlation equals the recurrence everywhere, warm-up and
    boundary columns included (tests/test_metrics.py's check, on the
    port's torch kernel)."""
    rng = np.random.default_rng(4)
    h, w = shape
    gx = rng.integers(0, 1000, (h, w)).astype(np.int64)
    gy = rng.integers(0, 1000, (h, w)).astype(np.int64)
    gx[-1] = gx[:, -1] = 0  # gradient maps have zero last row/col
    gy[-1] = gy[:, -1] = 0
    c2 = 58246.8
    want = P._fs_structure_scalar(gx, gy, c2)
    assert np.array_equal(want, J._fs_structure_scalar(gx, gy, c2))
    got = P._fs_structure(torch.from_numpy(gx), torch.from_numpy(gy),
                          c2).numpy()
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12), \
        np.argwhere(~np.isclose(got, want))[:5]


@pytest.mark.parametrize("shape", [(3, 5), (9, 17), (23, 12)])
def test_fs_luminance_matches_jax(shape):
    """The closed-form box sums give the recurrence's doubles exactly,
    its muy slip included."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 20, shape).astype(np.int64)
    b = rng.integers(0, 1 << 20, shape).astype(np.int64)
    got = P._fs_luminance(torch.from_numpy(a), torch.from_numpy(b), 3,
                          P._SSIM_C1[12]).numpy()
    want = J._fs_luminance(a, b, 3, J._SSIM_C1[12])
    assert np.array_equal(got, want)


def test_fdct8x8_matches_jax():
    rng = np.random.default_rng(7)
    blocks = rng.integers(-4095, 4096, (40, 8, 8)).astype(np.int64)
    got = P._fdct8x8(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, J._fdct8x8(blocks))


def _write_yuv(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(p.tobytes())


@pytest.mark.parametrize("mod", ["metrics", "tiny_ssim"])
def test_cli_yuv_pair_matches_jax(tmp_path, capsys, mod):
    rng = np.random.default_rng(10)
    w, h = 34, 26
    fa, fb = tmp_path / "a.yuv", tmp_path / "b.yuv"
    pa = [_planes(rng, w, h, 8) for _ in range(2)]
    _write_yuv(fa, pa)
    _write_yuv(fb, [_perturb(p, rng, 4, 8) for p in pa])
    port, jax_pkg = (P, J) if mod == "metrics" else (PT, JT)
    assert port.main([str(fa), str(fb), f"{w}x{h}", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_pkg.main([str(fa), str(fb), f"{w}x{h}"]) == 0
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 3


@pytest.mark.parametrize("mod", ["metrics", "tiny_ssim"])
def test_cli_ivf_matches_jax(tmp_path, capsys, mod):
    """An .ivf (decoded by the port with TorchRecon("cpu"), by the JAX
    package with its host oracle) against a perturbed copy of its
    frames as a .yuv."""
    from cuda_vp9_torch.containers import IvfReader
    from cuda_vp9_torch.decoder.frame import NativeVp9Decoder
    from cuda_vp9_torch.runtime.pipeline import TorchRecon
    ivf = FIXTURES / "kf01_64x64.ivf"
    dec = NativeVp9Decoder(recon_fn=TorchRecon("cpu"))
    frames = []
    with IvfReader(str(ivf)) as r:
        for data, _ in r:
            dec.decode(data)
            frames.extend(fr.visible_planes() for fr in dec.frames())
    rng = np.random.default_rng(12)
    yuv = tmp_path / "ref.yuv"
    _write_yuv(yuv, [_perturb(fr, rng, 3, 8) for fr in frames[:2]])
    port, jax_pkg = (P, J) if mod == "metrics" else (PT, JT)
    assert port.main([str(ivf), str(yuv), "64x64", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_pkg.main([str(ivf), str(yuv), "64x64"]) == 0
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("mod", ["metrics", "tiny_ssim"])
def test_cli_cuda_without_a_card_fails(tmp_path, capsys, mod):
    f = tmp_path / "a.yuv"
    f.write_bytes(bytes(16 * 16 * 3 // 2))
    port = P if mod == "metrics" else PT
    assert port.main([str(f), str(f), "16x16", "--device", "cuda"]) == 1
    assert "cuda" in capsys.readouterr().err
    with pytest.raises(RuntimeError):
        P.calc_psnr([np.zeros((8, 8), np.uint8)] * 3,
                    [np.zeros((8, 8), np.uint8)] * 3)
