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

build_seconds = {}      # tag -> seconds the last build of this process took
build_log = {}          # tag -> nvcc's output of that build (ptxas -v)
_libs = {}              # tag -> loaded library


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _tag(name: str, defines: tuple) -> str:
    return "-".join((name,) + tuple(d.replace("=", "") for d in defines))


def build(name: str, defines: tuple = ()) -> Path:
    """Compile csrc/<name>.cu into lib<name>.so if missing or stale; with
    defines (("MACRO=value", ...), passed to nvcc as -D), into a library
    of its own, lib<name>-<MACROvalue>...so, logged under that tag."""
    src = CSRC / f"{name}.cu"
    tag = _tag(name, defines)
    so = OUT / f"lib{tag}.so"
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
         *(f"-D{d}" for d in defines), "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    build_log[tag] = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{build_log[tag]}")
    os.replace(tmp, so)
    build_seconds[tag] = time.perf_counter() - t0
    return so


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with `defines`),
    built first if needed."""
    tag = _tag(name, defines)
    lib = _libs.get(tag)
    if lib is None:
        lib = _libs[tag] = ctypes.CDLL(str(build(name, defines)))
    return lib


def call(fn, device, *args) -> int:
    """fn(*args, stream, &launched) on `device`'s current stream, for the
    C entry points that report their launches; returns the launch count,
    and raises on a CUDA error.  On the current device it reads the raw
    stream handle and switches nothing (the host's own time per call
    counts: a frame makes a few such calls)."""
    n = ctypes.c_int(0)
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx),
                 ctypes.byref(n))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx),
                     ctypes.byref(n))
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return n.value
