"""The benchmark's own build of its copy of the C++ host runtime
(``glia_native.cc``, the watershed of glia_tpu_torch/native/src at commit
28cc36d), bound through ctypes as glia_tpu_torch/native/__init__.py binds
it.

The library is built with g++ at first use into ``.build/benchmark/`` at
the root of the checkout, a fixed directory, under a name that carries a
hash of the source and the command, so only a checkout's first run
compiles.  A process compiles to a private temporary name and renames it
into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, ".build", "benchmark")
_SRC = os.path.join(_HERE, "glia_native.cc")
_CMD = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha1(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"glia_native_ref_{h.hexdigest()[:12]}.so")


def _build() -> str:
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        out = subprocess.run([*_CMD, "-o", tmp, _SRC], capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"build of {path} failed:\n{out.stdout}"
                               f"{out.stderr}")
        os.replace(tmp, path)
    return path


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.glia_watershed.restype = i64
        lib.glia_watershed.argtypes = [p_f32, p_i64, ctypes.c_int,
                                       ctypes.c_double, p_i32]
        _lib = lib
        return _lib


def watershed_native(image, level=0.0):
    """Priority-flood watershed with h-minima ``level``; labels from 1."""
    lib = get_lib()
    img = np.ascontiguousarray(np.asarray(image), dtype=np.float32)
    dims = np.asarray(img.shape, dtype=np.int64)
    out = np.zeros(img.size, dtype=np.int32)
    lib.glia_watershed(img.ravel(), dims, img.ndim, float(level), out)
    return out.reshape(img.shape)
