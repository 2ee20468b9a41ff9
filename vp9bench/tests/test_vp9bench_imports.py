"""No module of the benchmark imports JAX or the JAX package, and a dry run
of the harness loads neither; the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_vp9_tpu"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_module_imports_no_jax(path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN, f"{path}: imports {names & FORBIDDEN}"


def test_whole_name_comparison():
    # the port's name begins with the JAX package's: compared whole
    assert "cuda_vp9_torch" not in FORBIDDEN
    assert "cuda_vp9_torch.codec".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "ivf.py", "traffic.py",
                                  "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    names = set(_top_level_imports(BENCH / name))
    assert "cuda_vp9_torch" not in names


DRY_RUN = r"""
import json, sys
from vp9bench.run import cache_env, manifest, forbidden_modules
from vp9bench import corpus
from vp9bench.drivers import DRIVERS
cache_env()
for cell in ("sd.batch16", "uhd.stream1"):
    wl, cfg, traffic, e2e, layer, units = manifest(cell)
    streams = corpus.load(cfg)
    drv = DRIVERS[traffic["driver"]](cfg, traffic, streams, 7, "cpu")
    drv.counters()
print(json.dumps({"loaded": forbidden_modules(),
                  "all": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_dry_run_loads_no_jax():
    """The harness up to its first device call (the corpus, the manifest,
    both drivers built on the CPU) in a fresh process."""
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert "cuda_vp9_torch" in res["all"]
    assert not set(res["all"]) & FORBIDDEN
