"""ctypes bindings for the C++ host runtime: watershed, the serial
greedy merge and pre-merge loops, connected components and the
exact-saliency replays.

``src/glia_native.cc`` is this package's own copy of glia_tpu's C++
runtime.  It is compiled with g++ at first use into ``.build/glia_tpu_torch/``
(see ``_build``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import SharedLibBuild

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "glia_native.cc")
_CMD = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def native_build() -> SharedLibBuild:
    return SharedLibBuild("glia_native", [_SRC], _CMD)


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native_build().wait())
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.glia_greedy_merge.restype = i64
        lib.glia_greedy_merge.argtypes = [
            i64, p_i64, p_i64, p_i64, p_f64, ctypes.c_int,
            i64, p_i64, p_i64, p_i64, p_f64, i64,
        ]
        lib.glia_greedy_merge_premerge.restype = i64
        lib.glia_greedy_merge_premerge.argtypes = [
            i64, p_i64, p_i64, p_i64, p_f64,
            i64, p_i64, p_i64, p_f64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            p_i64, p_f64, i64,
        ]
        lib.glia_watershed.restype = i64
        lib.glia_watershed.argtypes = [p_f32, p_i64, ctypes.c_int,
                                       ctypes.c_double, p_i32]
        lib.glia_connected_components.restype = i64
        lib.glia_connected_components.argtypes = [
            p_i32, ctypes.c_void_p, p_i64, ctypes.c_int, p_i32,
        ]
        lib.glia_replay_saliency.restype = None
        lib.glia_replay_saliency.argtypes = [
            i64, p_i32, p_i32, p_f64, p_f64, i64, i64, p_i32, p_f64,
        ]
        lib.glia_replay_saliency_median.restype = None
        lib.glia_replay_saliency_median.argtypes = [
            i64, p_i32, p_i32, p_i64, p_f64, i64, i64, p_i32,
            ctypes.c_void_p, p_f64,
        ]
        _lib = lib
        return _lib


_POLICY_IDS = {"median": 0, "mean": 1, "median_minsize": 2}


def greedy_merge_native(rag, pb_image, policy="median"):
    """Exact serial greedy merge by the C++ engine (the reference's
    merge_order_pb loop) for the policies median, mean and median_minsize.
    Returns (order [n, 3] int64 label keys, saliencies [n] float64: each
    merge's boundary statistic when it was popped)."""
    if policy not in _POLICY_IDS:
        raise ValueError(f"policy {policy!r} (median|mean|median_minsize)")
    lib = get_lib()
    pb = np.ascontiguousarray(np.asarray(pb_image).ravel(), dtype=np.float64)
    edge_vals = pb[rag.edge_pixels]
    u = np.ascontiguousarray(rag.edges[:, 0], dtype=np.int64)
    v = np.ascontiguousarray(rag.edges[:, 1], dtype=np.int64)
    ptr = np.ascontiguousarray(rag.edge_ptr, dtype=np.int64)
    keys = np.ascontiguousarray(rag.keys, dtype=np.int64)
    sizes = np.ascontiguousarray(
        rag.sizes if rag.sizes is not None else np.zeros_like(keys),
        dtype=np.int64,
    )
    max_merges = max(rag.n_regions - 1, 0)
    order = np.zeros(max(max_merges * 3, 1), dtype=np.int64)
    sals = np.zeros(max(max_merges, 1), dtype=np.float64)
    n = lib.glia_greedy_merge(
        rag.n_edges, u, v, ptr, np.ascontiguousarray(edge_vals),
        _POLICY_IDS[policy], len(keys), keys, sizes, order, sals, max_merges,
    )
    return order[: n * 3].reshape(-1, 3).copy(), sals[:n].copy()


def pre_merge_native(rag, pb_image, size_thresholds=(50,),
                     rpb_threshold=0.5):
    """Serial pre-merge via the C++ engine (gadget/main_pre_merge.cxx
    semantics): pooled-mean greedy merges admitted only while the smaller
    region is tiny (< thresholds[0]) or either region is medium
    (< thresholds[1]) with mean pb above rpb_threshold.  Returns
    (order [n, 3] int64 label keys, saliencies [n])."""
    lib = get_lib()
    pb = np.ascontiguousarray(np.asarray(pb_image).ravel(), dtype=np.float64)
    edge_vals = pb[rag.edge_pixels]
    u = np.ascontiguousarray(rag.edges[:, 0], dtype=np.int64)
    v = np.ascontiguousarray(rag.edges[:, 1], dtype=np.int64)
    ptr = np.ascontiguousarray(rag.edge_ptr, dtype=np.int64)
    keys = np.ascontiguousarray(rag.keys, dtype=np.int64)
    if (rag.sizes is None or len(rag.sizes) == 0
            or rag.region_ptr is None or rag.region_pixels is None):
        raise ValueError("RAG has no region sizes/pixels (contour-only "
                         "build); pre_merge needs build_rag(contour_only="
                         "False)")
    sizes = np.ascontiguousarray(rag.sizes, dtype=np.int64)
    # per-region summed pb for the mean-pb condition
    rl = np.diff(rag.region_ptr)
    rid = np.repeat(np.arange(rag.n_regions), rl)
    pb_sums = np.ascontiguousarray(
        np.bincount(rid, weights=pb[rag.region_pixels],
                    minlength=rag.n_regions))
    t0 = float(size_thresholds[0])
    t1 = float(size_thresholds[1]) if len(size_thresholds) > 1 else -1.0
    max_merges = max(rag.n_regions - 1, 0)
    order = np.zeros(max(max_merges * 3, 1), dtype=np.int64)
    sals = np.zeros(max(max_merges, 1), dtype=np.float64)
    n = lib.glia_greedy_merge_premerge(
        rag.n_edges, u, v, ptr, np.ascontiguousarray(edge_vals),
        len(keys), keys, sizes, pb_sums, t0, t1, float(rpb_threshold),
        order, sals, max_merges,
    )
    return order[: n * 3].reshape(-1, 3).copy(), sals[:n].copy()


def replay_saliency_native(u, v, s, c, order, n_ids):
    """Serial replay of a fixed merge order recomputing each merge's exact
    pooled-mean boundary statistic (the C++ engine of
    graph.merge_device.replay_exact_saliency)."""
    lib = get_lib()
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    s = np.ascontiguousarray(s, dtype=np.float64)
    c = np.ascontiguousarray(c, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int32).reshape(-1, 3)
    n = len(order)
    out = np.empty(max(n, 1), dtype=np.float64)
    lib.glia_replay_saliency(len(u), u, v, s, c, int(n_ids), n,
                             np.ascontiguousarray(order.ravel()), out)
    return out[:n]


def replay_saliency_median_native(u, v, edge_ptr, edge_vals, order,
                                  n_ids, region_sizes=None):
    """Serial replay of a fixed merge order recomputing each merge's
    exact upper-median boundary statistic at merge time (the reference's
    policy-0 quantity, util/stats.hxx:83-91, under splice-as-concat of
    boundary_table.hxx:122-167).  (u, v): dense endpoint indices per
    base edge; (edge_ptr, edge_vals): CSR pixel values per base edge;
    order: [M, 3] dense-index triples.  NaN where the pair has no
    boundary at its turn.  region_sizes (optional, leaf sizes indexed by
    dense region id): statistic becomes median * min(size) -- the
    median_minsize policy (struct_merge.hxx:141-185)."""
    lib = get_lib()
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    edge_ptr = np.ascontiguousarray(edge_ptr, dtype=np.int64)
    edge_vals = np.ascontiguousarray(edge_vals, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int32).reshape(-1, 3)
    n = len(order)
    out = np.empty(max(n, 1), dtype=np.float64)
    sz_ptr = None
    if region_sizes is not None:
        sz = np.zeros(int(n_ids), dtype=np.int64)
        region_sizes = np.asarray(region_sizes, dtype=np.int64)
        sz[: len(region_sizes)] = region_sizes
        sz_ptr = sz.ctypes.data_as(ctypes.c_void_p)
    lib.glia_replay_saliency_median(
        len(u), u, v, edge_ptr, edge_vals, int(n_ids), n,
        np.ascontiguousarray(order.ravel()), sz_ptr, out)
    return out[:n]


def watershed_native(image, level=0.0):
    """Priority-flood watershed with h-minima `level`; labels from 1."""
    lib = get_lib()
    img = np.ascontiguousarray(np.asarray(image), dtype=np.float32)
    dims = np.asarray(img.shape, dtype=np.int64)
    out = np.zeros(img.size, dtype=np.int32)
    lib.glia_watershed(img.ravel(), dims, img.ndim, float(level), out)
    return out.reshape(img.shape)


def connected_components_native(labels, mask=None):
    """Connected components of equal-valued pixels (4/6-connectivity)."""
    lib = get_lib()
    lab = np.ascontiguousarray(np.asarray(labels), dtype=np.int32)
    dims = np.asarray(lab.shape, dtype=np.int64)
    out = np.zeros(lab.size, dtype=np.int32)
    mask_ptr = None
    if mask is not None:
        mask_arr = np.ascontiguousarray(np.asarray(mask), dtype=np.int32)
        mask_ptr = mask_arr.ctypes.data_as(ctypes.c_void_p)
    lib.glia_connected_components(lab.ravel(), mask_ptr, dims, lab.ndim, out)
    return out.reshape(lab.shape)
