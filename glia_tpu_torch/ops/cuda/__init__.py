"""Hand-written CUDA kernels for Hopper: build, bind and launch.

Each ``.cu`` file here has a plain C entry point.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``.build/glia_tpu_torch/`` the first time it is needed, and called through
ctypes on PyTorch's current stream.  Nothing is compiled or loaded when the
module is imported, so the package imports on machines without CUDA.

Every wrapper takes CUDA tensors only and raises on anything else; a
failed build or launch raises too.  ``launches`` counts each kernel's
launches (and only those), so a run can show which kernels its main path
went through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Dict

import torch

from ..._build import SharedLibBuild
from ...models.forest import ForestTables, check_features

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"forest_votes": os.path.join(_HERE, "forest_votes.cu")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_CLASSES = 8

launches: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) -- the CUDA kernels cannot be built")
    return path


def kernel_build(name: str) -> SharedLibBuild:
    return SharedLibBuild(name, [SOURCES[name]], [_nvcc(), *NVCC_FLAGS])


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(kernel_build(name).wait())
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.glia_forest_votes
            fn.restype = i
            fn.argtypes = [p, i, i, p, p, p, p, p, i, i, i, i, p, p]
            _libs[name] = lib
        return _libs[name]


def _check(t: torch.Tensor, what: str, dtype, device, numel=None):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what} has {t.numel()} elements, expected {numel}")


def forest_votes_cuda(X: torch.Tensor, tables: ForestTables) -> torch.Tensor:
    """Forest vote fractions [B, C] float32 by the CUDA kernel
    ``forest_votes.cu``.  X: float32 [B, D] contiguous on a CUDA device;
    ``tables``: the forest's node tables on the same device."""
    if X.device.type != "cuda":
        raise ValueError(f"forest_votes_cuda takes CUDA tensors, got X on "
                         f"{X.device}")
    if X.ndim != 2:
        raise ValueError(f"X must be [B, D], got shape {tuple(X.shape)}")
    _check(X, "X", torch.float32, X.device)
    B, D = X.shape
    T, N, C = tables.n_trees, tables.n_nodes, tables.n_classes
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"forest_votes_cuda supports 1..{MAX_CLASSES} "
                         f"classes, got {C}")
    check_features(tables, D)
    for name, dtype in (("feature", torch.int32),
                        ("threshold", torch.float32),
                        ("left", torch.int32), ("right", torch.int32),
                        ("leaf_class", torch.int32)):
        _check(getattr(tables, name), f"tables.{name}", dtype, X.device,
               T * N)
    out = torch.empty((B, C), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    lib = _lib("forest_votes")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.glia_forest_votes(
            X.data_ptr(), B, D, tables.feature.data_ptr(),
            tables.threshold.data_ptr(), tables.left.data_ptr(),
            tables.right.data_ptr(), tables.leaf_class.data_ptr(), T, N, C,
            tables.max_depth + 1, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"forest_votes kernel launch failed: CUDA error "
                           f"{rc}")
    launches["forest_votes"] += 1
    return out
