"""The port's fixture sweep (cuda_vp9_torch/tools/fixture_sweep.py) on the
CPU, at its smallest: which streams it takes (VP9 by the IVF fourcc, and
the six of `LARGE`: hb01, the 4:4:0 streams and the scaled 4:4:4 and
4:2:2 streams of tests/fixtures/large; then the VP8 ones, VP80, on the
host), a stream that passes, and a VP9 and a VP8 stream whose golden
file was changed, which must fail and name the frame.  The sweep of
every stream takes minutes here and runs on the card in chip_smoke.py,
not in these tests."""

import shutil

import torch

from cuda_vp9_torch.tools import fixture_sweep as FS

from conftest import FIXTURES

torch.set_num_threads(1)


def test_streams_are_every_vp9_fixture_by_fourcc():
    names = FS.vp9_streams()
    vp8 = sorted(p.stem for p in FIXTURES.glob("*.ivf")
                 if p.stem.startswith("v8"))
    assert len(vp8) == 9 and not set(vp8) & set(names)
    assert names[-6:] == list(FS.LARGE)
    assert names[-1] == "large/sc03_176x144_422_scaled"
    assert len(names) == len(list(FIXTURES.glob("*.ivf"))) - len(vp8) + 6
    assert len(names) == 65
    assert FS.vp8_streams() == vp8
    assert FS.streams() == names + vp8
    assert FS._pick(names, ["mv01", "kf01_64x64"]) == [
        "kf01_64x64", "mv01_176x144_extmv"]
    assert FS._pick(FS.streams(), ["v8in01", "p1_05"]) == [
        "large/p1_05_176x144_440", "v8in01_176x144"]


def test_sweep_passes_a_stream_and_fails_a_changed_golden(tmp_path):
    name = "mn01_16x16"
    shutil.copy(FIXTURES / f"{name}.ivf", tmp_path)
    lines = (FIXTURES / f"{name}.md5").read_text().splitlines()
    (tmp_path / f"{name}.md5").write_text("\n".join(lines) + "\n")
    out = []
    rec, = FS.sweep([name], "cpu", tmp_path, out.append)
    assert rec["ok"] and rec["frames"] == rec["expected"] == len(lines)
    assert rec["frames_on_host"] == 0 and rec["frames_on_device"] == 6
    assert rec["plain_calls"]["pages"] == 6 and len(out) == 2
    assert out[-1].startswith("fixture sweep on cpu: 1 streams, 6 frames, "
                              "0 mismatches, 0 streams failed")
    lines[3] = "0" * 32 + lines[3][32:]
    (tmp_path / f"{name}.md5").write_text("\n".join(lines) + "\n")
    rec = FS.sweep_stream(tmp_path, name, "cpu")
    assert not rec["ok"] and rec["first_mismatch"] == 3
    assert "first mismatch frame 3 (1 frames)" in FS.line(rec)
    assert FS.main(["--device", "cpu", "--fixtures", str(tmp_path)]) == 1


def test_sweep_fails_a_vp8_stream_with_a_changed_golden(tmp_path):
    name = "v8kf03_odd_98x66"
    shutil.copy(FIXTURES / f"{name}.ivf", tmp_path)
    lines = (FIXTURES / f"{name}.md5").read_text().splitlines()
    (tmp_path / f"{name}.md5").write_text("\n".join(lines) + "\n")
    out = []
    rec, = FS.sweep([name], "cpu", tmp_path, out.append)
    assert rec["ok"] and rec["vp8"] and rec["frames"] == len(lines) == 3
    assert "decoded on the host (VP8)" in out[0] and len(out) == 3
    assert out[1].startswith("VP8 streams, decoded on the host (VP8): "
                             "1 streams, 3 frames, 0 mismatches")
    lines[1] = "f" * 32 + lines[1][32:]
    (tmp_path / f"{name}.md5").write_text("\n".join(lines) + "\n")
    rec = FS.sweep_vp8(tmp_path, name)
    assert not rec["ok"] and rec["first_mismatch"] == 1
    assert "first mismatch frame 1 (1 frames)" in FS.line(rec)
    assert FS.line(rec).endswith("FAILED")
    assert FS.main(["--device", "cpu", "--fixtures", str(tmp_path)]) == 1
