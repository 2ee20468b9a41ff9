"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/cuda_vp9_torch/lib<name>.so` at the checkout root, at first
use; it is rebuilt when any source in `csrc/` is newer than the library
(as `cuda_vp9_tpu/native` does for libvp9host.so).  The build targets
Hopper only: `-gencode arch=compute_90a,code=sm_90a`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
OUT = _PKG.parent / "build" / "cuda_vp9_torch"

build_seconds = {}      # name -> seconds the last build of this process took
build_log = {}          # name -> nvcc's output of that build (ptxas -v)
_libs = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into lib<name>.so if missing or stale."""
    src = CSRC / f"{name}.cu"
    so = OUT / f"lib{name}.so"
    deps = [p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")]
    if so.exists() and all(so.stat().st_mtime > p.stat().st_mtime
                           for p in deps):
        return so
    OUT.mkdir(parents=True, exist_ok=True)
    # private temp name + atomic rename: a concurrent process never
    # loads a half-written library
    tmp = so.with_name(f"{so.name}.build.{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", str(tmp), str(src)], capture_output=True, text=True)
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{build_log[name]}")
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib


def call(fn, device, *args) -> int:
    """fn(*args, stream, &launched) on `device`'s current stream, for the
    C entry points that report their launches; returns the launch count,
    and raises on a CUDA error."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream,
                 ctypes.byref(n))
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return n.value
