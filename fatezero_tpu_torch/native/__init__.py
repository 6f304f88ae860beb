"""ctypes binding for the C++ frame loader (libjpeg/libpng + a thread pool).

Counterpart of fatezero_tpu/native: `image_loader.cpp` is a verbatim copy of
the JAX package's source. It is compiled with g++ at first use into
``build/native/`` at the repository root (listed in ``.gitignore``), keyed by
the hash of the source and the flags and written atomically (a temporary
name, then ``os.replace``), so processes that build at once never load a
half-written library. Nothing is built at import time.

Where the library cannot be built or loaded (no libjpeg/libpng headers, no
g++), `get_lib` raises `NativeLoaderUnavailable` with the build's own error;
data/dataset.py then takes the PIL path in its auto mode and raises when
`native_loader=True` asked for this loader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "image_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
# the JAX package's flags (fatezero_tpu/native/build.sh), so both libraries
# round alike on one host
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")


class NativeLoaderUnavailable(RuntimeError):
    """The native loader could not be built or loaded on this host."""


_state: dict = {}


def build() -> str:
    """Compile image_loader.cpp unless an up-to-date library exists; return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libimage_loader_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SOURCE, "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeLoaderUnavailable(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise NativeLoaderUnavailable(f"g++ failed for image_loader.cpp:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process; a failure is
    remembered and raised again, without another build."""
    if "lib" in _state:
        return _state["lib"]
    if "error" in _state:
        raise NativeLoaderUnavailable(_state["error"])
    try:
        lib = ctypes.CDLL(build())
    except (NativeLoaderUnavailable, OSError) as e:
        _state["error"] = str(e)
        raise NativeLoaderUnavailable(_state["error"]) from e
    lib.il_load_batch.restype = ctypes.c_int
    lib.il_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _state["lib"] = lib
    return lib


def load_batch(
    paths: List[str],
    image_size: int,
    crop_xy: Optional[tuple] = None,
    num_threads: int = 0,
) -> Optional[np.ndarray]:
    """Decode+short-side-resize+crop `paths` -> [n, S, S, 3] float32 in [-1,1].
    Returns None when any image fails (callers fall back to the Python
    path); raises NativeLoaderUnavailable when the library cannot be built."""
    if image_size <= 0:
        raise ValueError(f"image_size must be positive, got {image_size}")
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    cx, cy = crop_xy if crop_xy is not None else (-1, -1)
    threads = num_threads or min(os.cpu_count() or 1, 16)
    ok = lib.il_load_batch(arr, n, image_size, cx, cy, threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if ok != n:
        return None
    return out
