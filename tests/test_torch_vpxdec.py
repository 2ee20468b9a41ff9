"""The port's vpxdec writer (`cuda_vp9_torch/tools/vpxdec.py -o`) and its
fourcc probe, on the CPU (`--device cpu`):

  * kf01 to a raw .yuv and to a .y4m: each frame's bytes hash to the
    golden MD5s;
  * the .y4m of kf01 and the `--limit 2` .y4m of p2_01 (10-bit) equal,
    byte for byte, what `python -m cuda_vp9_tpu.tools.vpxdec --host-recon
    -o` writes (a subprocess, so that the JAX package's CLI runs as a
    user runs it);
  * the `--limit 1` .y4m of p1_01 (4:4:4) carries the tag C444 (the JAX
    package's writer says C420 for every chroma format) and hashes to the
    golden MD5;
  * v8kf03 goes through the fourcc probe to vp8_dx(), whose --summary
    says it was decoded on the host, and its .y4m hashes to the goldens;
  * a decode error leaves the file closed and returns 1.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuda_vp9_torch.containers import is_vp8
from cuda_vp9_torch.tools import vpxdec

from conftest import FIXTURES

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


def _golden(name):
    return [ln.split()[0] for ln in
            (FIXTURES / f"{name}.md5").read_text().splitlines()]


def _frames(data, y4m, w, h, ss=(1, 1), bd=8):
    """(header, frames' bytes) of a file of frames of this geometry."""
    size = (w * h + 2 * ((w + ss[0]) >> ss[0]) * ((h + ss[1]) >> ss[1])) \
        * (1 if bd == 8 else 2)
    header, pos, out = None, 0, []
    if y4m:
        pos = data.index(b"\n") + 1
        header = data[:pos]
    while pos < len(data):
        if y4m:
            assert data[pos:pos + 6] == b"FRAME\n"
            pos += 6
        out.append(data[pos:pos + size])
        assert len(out[-1]) == size
        pos += size
    return header, out


def _run(name, out, *extra):
    assert vpxdec.main([str(FIXTURES / f"{name}.ivf"), "--device", "cpu",
                        "-o", str(out), *extra]) == 0
    return out.read_bytes()


def _jax_vpxdec(name, out, *extra):
    """The JAX package's CLI in a subprocess.  While the JAX package's
    test_asan_bitflip_pack_sweep runs, an AddressSanitizer build stands
    in place of cuda_vp9_tpu/native/libvp9host.so, and a process that
    loads it then aborts because the ASan runtime does not come first
    (ROADMAP F6).  Only on that abort is the CLI run again, with the
    runtime preloaded; any other failure fails the test."""
    cmd = [sys.executable, "-m", "cuda_vp9_tpu.tools.vpxdec",
           str(FIXTURES / f"{name}.ivf"), "--host-recon", "-o", str(out),
           *extra]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}

    def run(env):
        return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300, env=env)

    r = run(env)
    if r.returncode != 0 and "ASan runtime does not come first" in r.stderr:
        libasan = subprocess.check_output(
            ["g++", "-print-file-name=libasan.so"], text=True).strip()
        r = run({**env, "LD_PRELOAD": libasan,
                 "ASAN_OPTIONS": "detect_leaks=0"})
    assert r.returncode == 0, r.stderr[-3000:]
    return out.read_bytes()


@pytest.mark.parametrize("suffix", [".yuv", ".y4m"])
def test_kf01_frames_hash_to_golden(tmp_path, suffix):
    data = _run("kf01_64x64", tmp_path / f"kf01{suffix}")
    header, frames = _frames(data, suffix == ".y4m", 64, 64)
    assert [hashlib.md5(f).hexdigest() for f in frames] == _golden(
        "kf01_64x64")
    if header is not None:
        assert header == b"YUV4MPEG2 W64 H64 F30:1 Ip A1:1 C420\n"
        jax = _jax_vpxdec("kf01_64x64", tmp_path / "jax.y4m")
        assert data == jax


@pytest.mark.slow
def test_10bit_y4m_equals_the_jax_writer(tmp_path):
    """Slow: the JAX package's CLI decodes p2_01 on its host oracle."""
    data = _run("p2_01_176x144_10b", tmp_path / "p2.y4m", "--limit", "2")
    header, frames = _frames(data, True, 176, 144, bd=10)
    assert header == b"YUV4MPEG2 W176 H144 F30:1 Ip A1:1 C420p10\n"
    assert [hashlib.md5(f).hexdigest() for f in frames] == _golden(
        "p2_01_176x144_10b")[:2]
    assert data == _jax_vpxdec("p2_01_176x144_10b", tmp_path / "jax.y4m",
                               "--limit", "2")


def test_444_y4m_carries_its_own_tag(tmp_path):
    data = _run("p1_01_176x144_444", tmp_path / "p1.y4m", "--limit", "1")
    header, frames = _frames(data, True, 176, 144, ss=(0, 0))
    assert header == b"YUV4MPEG2 W176 H144 F30:1 Ip A1:1 C444\n"
    assert [hashlib.md5(f).hexdigest() for f in frames] == _golden(
        "p1_01_176x144_444")[:1]


def test_vp8_through_the_fourcc_probe(tmp_path, capsys):
    name = "v8kf03_odd_98x66"
    assert is_vp8(FIXTURES / f"{name}.ivf")
    assert not is_vp8(FIXTURES / "kf01_64x64.ivf")
    data = _run(name, tmp_path / "v8.y4m", "--summary", "--md5")
    header, frames = _frames(data, True, 98, 66)
    assert header == b"YUV4MPEG2 W98 H66 F30:1 Ip A1:1 C420\n"
    want = _golden(name)
    assert [hashlib.md5(f).hexdigest() for f in frames] == want
    out, err = capsys.readouterr()
    assert [ln.split()[0] for ln in out.splitlines()] == want
    assert err.startswith("3 frames in ") and \
        "(VP8, decoded on the host; " in err


def test_decode_error_closes_the_file(tmp_path, capsys, monkeypatch):
    """A decode error returns 1 with the output file closed."""
    opened = []
    real_open = open

    def spy(*a, **k):
        f = real_open(*a, **k)
        opened.append(f)
        return f

    bad = tmp_path / "bad.ivf"
    data = bytearray((FIXTURES / "v8kf03_odd_98x66.ivf").read_bytes())
    data[32 + 12 + 3] ^= 0xFF          # the first frame's start code
    bad.write_bytes(bytes(data))
    monkeypatch.setattr(vpxdec, "open", spy, raising=False)
    assert vpxdec.main([str(bad), "--device", "cpu", "-o",
                        str(tmp_path / "bad.y4m")]) == 1
    assert "decode error" in capsys.readouterr().err
    assert len(opened) == 1 and opened[0].closed
