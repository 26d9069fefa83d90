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
SOURCES = {"forest_votes": os.path.join(_HERE, "forest_votes.cu"),
           "segment_sum": os.path.join(_HERE, "segment_sum.cu")}
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


def _bind(name: str, lib: ctypes.CDLL):
    """Declare the C entry points of library ``name``: every one returns
    the CUDA error of its launch (0: none)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "forest_votes":
        entries = {"glia_forest_votes":
                   [p, i, i, p, p, p, p, p, i, i, i, i, p, p]}
    else:
        args = [p, p, ll, i, ll, i, p, p]
        entries = {"glia_segment_sum": args, "glia_segment_sum_sorted": args}
    for fn_name, argtypes in entries.items():
        fn = getattr(lib, fn_name)
        fn.restype = i
        fn.argtypes = argtypes


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(kernel_build(name).wait())
            _bind(name, lib)
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


def segment_sum_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                     n_segments: int, sorted: bool = False) -> torch.Tensor:
    """Segment sum by the CUDA kernel ``segment_sum.cu``: values [B, F] or
    [B] (float32 or float64), seg_ids int64 [B], both contiguous on one
    CUDA device -> [S, F] or [S].  Rows whose id is negative or
    >= n_segments are dropped.  ``sorted=True`` states that the ids are
    non-decreasing and selects the entry point without atomics (same bits
    on every launch); it is not verified on the card."""
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_cuda takes CUDA tensors, got values "
                         f"on {values.device}")
    if values.ndim not in (1, 2):
        raise ValueError(f"values must be [B] or [B, F], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"values has dtype {values.dtype}, expected "
                         f"float32 or float64")
    _check(values, "values", values.dtype, values.device)
    B = values.shape[0]
    F = values.shape[1] if values.ndim == 2 else 1
    S = int(n_segments)
    if S < 0:
        raise ValueError(f"n_segments must be >= 0, got {S}")
    if seg_ids.ndim != 1:
        raise ValueError(f"seg_ids must be [B], got shape "
                         f"{tuple(seg_ids.shape)}")
    _check(seg_ids, "seg_ids", torch.int64, values.device, B)
    out = torch.zeros((S,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if B == 0 or S == 0 or F == 0:
        return out
    lib = _lib("segment_sum")
    fn = lib.glia_segment_sum_sorted if sorted else lib.glia_segment_sum
    stream = torch.cuda.current_stream(values.device).cuda_stream
    with torch.cuda.device(values.device):
        rc = fn(values.data_ptr(), seg_ids.data_ptr(), B, F, S,
                int(values.dtype == torch.float64), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    launches["segment_sum"] += 1
    return out
