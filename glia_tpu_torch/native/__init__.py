"""ctypes bindings for the C++ host runtime: watershed, the serial
greedy merge and pre-merge loops, connected components, the
exact-saliency replays, the serial classifier-in-the-loop merge and the
forest trainer.

``src/glia_native.cc`` and ``src/glia_bc.cc`` are this package's own copies
of glia_tpu's C++ runtime, built together as glia_tpu builds them;
``src/glia_forest.cc`` (CART training, the port's own) is built apart,
without fused multiply-adds.  Each library is compiled with g++ at first
use into ``.build/glia_tpu_torch/`` (see ``_build``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import SharedLibBuild

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SRC = [os.path.join(_SRC_DIR, "glia_native.cc"),
        os.path.join(_SRC_DIR, "glia_bc.cc")]
_CMD = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_FOREST_SRC = [os.path.join(_SRC_DIR, "glia_forest.cc")]
# the trainer reproduces scikit-learn's float arithmetic: no contraction
# of a * b + c into one rounding
_FOREST_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               "-ffp-contract=off"]
_lock = threading.Lock()
_lib = None
_forest_lib = None


def native_build() -> SharedLibBuild:
    return SharedLibBuild("glia_native", _SRC, _CMD)


def forest_build() -> SharedLibBuild:
    return SharedLibBuild("glia_forest", _FOREST_SRC, _FOREST_CMD)


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
        lib.glia_bc_greedy_merge.restype = i64
        lib.glia_bc_greedy_merge.argtypes = [
            i64, p_i64, p_i64, p_i64, p_i64,          # regions
            i64, p_i64, p_i64, p_i64, p_i64,          # directed pairs
            i64, p_i64, i64, p_f64, i64,              # ndim/shape/images
            i64, ctypes.c_double, ctypes.c_double,    # bins/range
            p_f64, i64, p_f64,                        # pb/thresholds
            i64, i64, p_i32, p_f32, p_i32, p_i32, p_i32,
            ctypes.c_int,                             # forest
            p_i64, p_f64, i64, p_i64,                 # outputs
        ]
        lib.glia_replay_saliency_median.restype = None
        lib.glia_replay_saliency_median.argtypes = [
            i64, p_i32, p_i32, p_i64, p_f64, i64, i64, p_i32,
            ctypes.c_void_p, p_f64,
        ]
        _lib = lib
        return _lib


def get_forest_lib():
    global _forest_lib
    with _lock:
        if _forest_lib is not None:
            return _forest_lib
        lib = ctypes.CDLL(forest_build().wait())
        i64, i32 = ctypes.c_int64, ctypes.c_int
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.glia_forest_train.restype = i32
        lib.glia_forest_train.argtypes = [
            i64, i64, p_f32, p_i32, i32, i64, p_i32, p_u32, i64, i64, i32,
            p_i64, p_i32, p_f32, p_i32, p_i32, p_i32, p_i64, p_i64,
        ]
        _forest_lib = lib
        return _forest_lib


def forest_train_native(X, y, n_classes, counts, seeds, mtry, max_depth=None,
                        n_threads=1):
    """Grow one CART tree per row of ``counts`` (glia_forest.cc).

    X: float32 [n, D]; y: class index [n] in [0, n_classes); counts: int32
    [T, n], each tree's bootstrap counts (its sample weights); seeds: uint32
    [T], each tree's feature stream; ``max_depth`` None grows to purity.
    Returns a list of T (feature, threshold, left, right, leaf_class) node
    arrays, nodes in preorder with the left child first (leaves: feature
    and threshold -2, children 0), and the depths [T]."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint32)
    n, D = X.shape
    T = counts.shape[0]
    if counts.shape != (T, n) or seeds.shape != (T,) or y.shape != (n,):
        raise ValueError("counts must be [T, n], seeds [T] and y [n]")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: the trainer indexes rows in int32")
    if y.size and (y.min() < 0 or y.max() >= n_classes):
        raise ValueError(f"class index outside [0, {n_classes})")
    if (counts < 0).any():
        raise ValueError("negative bootstrap count")
    # a tree of k rows has at most 2k - 1 nodes
    room = np.maximum(2 * (counts != 0).sum(axis=1) - 1, 1)
    offset = np.concatenate([[0], np.cumsum(room)]).astype(np.int64)
    total = int(offset[-1])
    out = [np.zeros(total, dt) for dt in
           (np.int32, np.float32, np.int32, np.int32, np.int32)]
    node_count = np.zeros(T, np.int64)
    depth = np.zeros(T, np.int64)
    rc = get_forest_lib().glia_forest_train(
        n, D, X, y, int(n_classes), T, counts, seeds, int(mtry),
        -1 if max_depth is None else int(max_depth), int(n_threads), offset,
        *out, node_count, depth)
    if rc != 0:
        raise RuntimeError("forest training wrote past a tree's room")
    trees = [tuple(a[offset[t]:offset[t] + node_count[t]] for a in out)
             for t in range(T)]
    return trees, depth


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


def greedy_merge_bc_native(rag, cfg, model, label=-1, max_merges=None):
    """Serial classifier-in-the-loop greedy merge via the C++ engine
    (glia_bc.cc): the same algorithm as graph.merge_bc.greedy_merge_bc,
    bit for bit (canonical sorted-neighbor accumulation, numpy pairwise
    sums, heapq tie rule), and the serial oracle of the device engine
    (util/struct_merge_bc.hxx:10-58 semantics).  ``model`` is a
    ForestModel; merge probabilities are its vote fractions for ``label``.

    Supports the FeatureConfig.standard subset: r_images == b_images,
    no rl_images, shared hist bins/range, normalizing 1.0, no log-shape
    and no histogram/median extra feats.  Returns (order [n, 3] int64
    label-key triples, probs [n])."""
    if (cfg.rl_images or cfg.use_log_shape or cfg.histogram_as_feats
            or cfg.median_as_feats or cfg.normalizing_area != 1.0
            or cfg.normalizing_length != 1.0):
        raise ValueError("native BC engine supports the standard "
                         "feature-config subset only")
    if len(cfg.r_images) != len(cfg.b_images) or any(
            ri.image is not bi.image or ri.hist_bins != bi.hist_bins
            or ri.hist_range != bi.hist_range
            for ri, bi in zip(cfg.r_images, cfg.b_images)):
        raise ValueError("native BC engine needs r_images == b_images "
                         "(FeatureConfig.standard)")
    bins = {i.hist_bins for i in cfg.r_images}
    ranges = {i.hist_range for i in cfg.r_images}
    if len(bins) != 1 or len(ranges) != 1:
        raise ValueError("native BC engine needs one shared hist config")
    n_bins = bins.pop()
    lo, hi = ranges.pop()
    if rag.region_ptr is None or rag.dir_pairs is None:
        raise ValueError("build RAG with contour_only=False")
    # the engine's candidate vectors have no saliency columns; a forest
    # that splits past them would read beyond each vector
    width = (cfg.boundary_feat_dim(with_saliency=False)
             + 3 * cfg.region_feat_dim(len(rag.shape), with_saliency=False))
    if int(model.feature.max(initial=-1)) >= width:
        raise ValueError(f"forest splits on feature "
                         f"{int(model.feature.max())} but the BC features "
                         f"have {width}")
    lib = get_lib()
    shape = np.asarray(rag.shape, dtype=np.int64)
    n_pixels = int(np.prod(shape))
    images = np.ascontiguousarray(np.stack(
        [np.asarray(im.image, dtype=np.float64).ravel()
         for im in cfg.r_images]))
    pb = np.ascontiguousarray(np.asarray(cfg.pb_image,
                                         dtype=np.float64).ravel())
    thresholds = np.ascontiguousarray(cfg.boundary_thresholds,
                                      dtype=np.float64)
    border_counts = np.ascontiguousarray(np.diff(rag.border_ptr),
                                         dtype=np.int64)
    li = int(np.nonzero(model.classes == label)[0][0])
    if max_merges is None:
        max_merges = max(rag.n_regions - 1, 0)
    order = np.zeros(max(max_merges * 3, 1), dtype=np.int64)
    probs = np.zeros(max(max_merges, 1), dtype=np.float64)
    feat_dim = np.zeros(1, dtype=np.int64)
    n = lib.glia_bc_greedy_merge(
        rag.n_regions,
        np.ascontiguousarray(rag.keys, dtype=np.int64),
        np.ascontiguousarray(rag.region_ptr, dtype=np.int64),
        np.ascontiguousarray(rag.region_pixels, dtype=np.int64),
        border_counts,
        len(rag.dir_pairs),
        np.ascontiguousarray(rag.dir_pairs[:, 0], dtype=np.int64),
        np.ascontiguousarray(rag.dir_pairs[:, 1], dtype=np.int64),
        np.ascontiguousarray(rag.dir_ptr, dtype=np.int64),
        np.ascontiguousarray(rag.dir_pixels, dtype=np.int64),
        len(shape), shape, len(cfg.r_images), images, n_pixels,
        int(n_bins), float(lo), float(hi),
        pb, len(thresholds), thresholds,
        model.n_trees, model.feature.shape[1],
        np.ascontiguousarray(model.feature, dtype=np.int32),
        np.ascontiguousarray(model.threshold, dtype=np.float32),
        np.ascontiguousarray(model.left, dtype=np.int32),
        np.ascontiguousarray(model.right, dtype=np.int32),
        np.ascontiguousarray(model.leaf_class, dtype=np.int32),
        li, order, probs, max_merges, feat_dim)
    return order[: n * 3].reshape(-1, 3).copy(), probs[:n].copy()


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
