"""The port keeps its own copy of the host side.

  * No module of `cuda_vp9_torch/` (the `vp8/`, `parallel/` and
    `encoder/` modules, the Python parse helpers the encoder writes
    against, and the encode and metrics tools among them), and not
    `chip_smoke.py`, imports `jax` or `cuda_vp9_tpu` (an AST scan of
    every import statement).
  * The port's packer gives the JAX package's flat, byte for byte, for
    frame 0 of kf02 (8-bit 4:2:0), p2_01 (10-bit 4:2:0) and p1_01 (8-bit
    4:4:4): the C++ packer for 4:2:0 frames and `runtime/pack.pack_frame`
    for the others, as both pipelines choose, each package with its own
    parser, layout and packer.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

from conftest import FIXTURES

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "cuda_vp9_tpu")


def _absolute_imports(path: Path):
    """Top-level names of a file's absolute imports, wherever they stand
    (a relative import stays inside the file's own package)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "cuda_vp9_torch").rglob("*.py"))
    assert len(files) > 30, "the port's modules were not found"
    vp8 = {f.name for f in files if f.parent.name == "vp8"}
    assert vp8 == {"__init__.py", "concealment.py", "decoder.py",
                   "encoder.py", "postproc.py", "pptables.py", "recon.py",
                   "tables_gen.py"}, vp8
    parallel = {f.name for f in files if f.parent.name == "parallel"}
    assert parallel == {"__init__.py", "dryrun.py", "worker.py"}, parallel
    encoder = {f.name for f in files if f.parent.name == "encoder"}
    assert encoder == {"__init__.py", "bitwriter.py", "encoder.py",
                       "interframe.py", "motion.py", "svc.py",
                       "tokenize.py", "transforms.py"}, encoder
    rel = {str(f.relative_to(ROOT / "cuda_vp9_torch")) for f in files}
    assert {"containers/y4m.py", "decoder/tiles.py", "decoder/decodemv.py",
            "decoder/mvref.py", "decoder/compressed_header.py",
            "decoder/detokenize.py", "tools/vpxenc.py",
            "tools/vp9_spatial_svc_encoder.py", "tools/metrics.py",
            "tools/tiny_ssim.py"} <= rel
    bad = [f"{f.relative_to(ROOT)}: {m}"
           for f in files + [ROOT / "chip_smoke.py"]
           for m in _absolute_imports(f) if m in FORBIDDEN]
    assert not bad, bad


def _frame0_flat(pkg, name):
    """(flat, layout segs) of frame 0 of a fixture, packed by one package
    (`cuda_vp9_tpu` or `cuda_vp9_torch`) with its own modules."""
    import importlib
    frame = importlib.import_module(f"{pkg}.decoder.frame")
    pack = importlib.import_module(f"{pkg}.runtime.pack")
    ivf = importlib.import_module(f"{pkg}.containers")
    out = {}

    def recon_fn(plan, refs):
        h = plan.hdr
        ss = (h.subsampling_x, h.subsampling_y)
        caps = pack.compute_caps(h.mi_rows, h.mi_cols, "full", False, ss=ss)
        layout = pack.build_layout(caps, h.mi_rows, h.mi_cols, False,
                                   h.bit_depth, ss=ss)
        if ss == (1, 1):
            flat = plan.native_parser.pack(plan, refs, caps, layout)
        else:
            flat = pack.pack_frame(plan, refs, caps, layout)
        out.update(flat=flat, segs=layout.segs)
        raise StopIteration

    dec = frame.NativeVp9Decoder(recon_fn=recon_fn)
    with ivf.IvfReader(str(FIXTURES / f"{name}.ivf")) as r:
        data, _ = next(iter(r))
        with pytest.raises(StopIteration):
            dec.decode(data)
    return out["flat"], out["segs"]


@pytest.mark.parametrize("name", ["kf02_176x144", "p2_01_176x144_10b",
                                  "p1_01_176x144_444"])
def test_packer_flat_matches_jax(name):
    flat, segs = _frame0_flat("cuda_vp9_torch", name)
    want, want_segs = _frame0_flat("cuda_vp9_tpu", name)
    assert segs == want_segs
    assert flat.dtype == want.dtype == np.int16
    assert flat.tobytes() == want.tobytes()
    assert np.asarray(flat).any()
