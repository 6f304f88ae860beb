"""Build and load the hand-written CUDA kernels of the port.

Each kernel source under this directory exposes a plain C interface and is
compiled by ``nvcc`` into a shared library on first use, then loaded with
``ctypes``. Libraries are keyed by the hash of their source and of the
shared headers (``*.cuh``), so an edited kernel is rebuilt and a stale one is
never loaded. The build directory is ``build/kernels`` at the repository root
(listed in ``.gitignore``). ``build_all`` starts one ``nvcc`` per source at
once, so a cold start costs the slowest build rather than their sum.

Nothing here runs at import time: the CPU-only test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build", "kernels")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(source: str) -> str:
    """Compile csrc/<source> unless an up-to-date library exists; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_CSRC, source), *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(sources) -> list:
    """Build several sources concurrently (one nvcc each); return their paths."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build, sources))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source> once per process."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source))
        _loaded[source] = lib
    return lib
