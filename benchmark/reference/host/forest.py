"""The benchmark's forests: its frozen copy of the port's CART trainer
(``glia_forest.cc``, glia_tpu_torch/native/src at commit 95324b0) with the
bootstrap draws of glia_tpu_torch/models/forest.py (``bootstrap_draws``,
``train_forest``) at that commit, bound through ctypes.

The library is built with g++ at first use into ``.build/benchmark/``, as
``native.py`` builds the watershed: a name that carries a hash of the
source and the command, a private temporary name renamed into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

from .native import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "glia_forest.cc")
# the trainer reproduces scikit-learn's float arithmetic: no contraction of
# a * b + c into one rounding
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-ffp-contract=off"]
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha1(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"glia_forest_ref_{h.hexdigest()[:12]}.so")


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            out = subprocess.run([*_CMD, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"build of {path} failed:\n{out.stdout}"
                                   f"{out.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
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
        _lib = lib
        return _lib


@dataclass
class Forest:
    """Node arrays [T, N], trees padded to the largest (leaves: feature
    < 0, their class index in ``leaf_class``); ``classes`` maps a class
    index to its label."""

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_class: np.ndarray
    classes: np.ndarray
    max_depth: int
    n_features: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def bootstrap_draws(y, n_trees, sample_ratio=0.7, balance_classes=True,
                    seed=0):
    """Each tree's bootstrap counts and feature-stream seed, as sklearn's
    RandomForestClassifier(bootstrap=True, max_samples=sample_ratio,
    class_weight="balanced" or None, random_state=seed) draws them."""
    y = np.asarray(y).astype(np.int64)
    n = len(y)
    classes, y_idx = np.unique(y, return_inverse=True)
    if balance_classes:
        class_counts = np.bincount(y_idx, weights=np.ones(n))
        recip = np.sum(class_counts) / (len(classes) * class_counts)
        w = recip[y_idx]
        p = w / np.sum(w)
        n_bs = max(int(sample_ratio * w.sum()), 1)
    else:
        n_bs = max(int(sample_ratio * n), 1)
    top = np.iinfo(np.int32).max
    rs = np.random.RandomState(seed)
    tree_seeds = [rs.randint(top) for _ in range(n_trees)]
    counts = np.empty((n_trees, n), np.int32)
    seeds = np.empty(n_trees, np.uint32)
    for t, s in enumerate(tree_seeds):
        draw = np.random.RandomState(s)
        idx = (draw.choice(n, n_bs, replace=True, p=p) if balance_classes
               else draw.randint(0, n, n_bs))
        counts[t] = np.bincount(idx, minlength=n)
        seeds[t] = np.random.RandomState(s).randint(0, top)
    return classes, y_idx, counts, seeds


def train_forest(X, y, n_trees=255, mtry=None, sample_ratio=0.7,
                 balance_classes=True, seed=0, n_threads=None) -> Forest:
    """A forest grown to purity with the reference's defaults
    (main_train_rf.cxx:18-70: 255 trees, mtry = int(sqrt(D)), sample
    ratio 0.7, class-balancing weights)."""
    X32 = np.ascontiguousarray(X, dtype=np.float32)
    if X32.ndim != 2 or len(X32) != len(y) or not np.isfinite(X32).all():
        raise ValueError("X must be finite [n, D] with n = len(y)")
    n, D = X32.shape
    mtry = max(1, int(np.sqrt(D))) if mtry is None else int(mtry)
    n_threads = n_threads or os.cpu_count() or 1
    classes, y_idx, counts, seeds = bootstrap_draws(
        y, n_trees, sample_ratio, balance_classes, seed)
    # a tree of k rows has at most 2k - 1 nodes
    room = np.maximum(2 * (counts != 0).sum(axis=1) - 1, 1)
    offset = np.concatenate([[0], np.cumsum(room)]).astype(np.int64)
    total = int(offset[-1])
    out = [np.zeros(total, dt) for dt in
           (np.int32, np.float32, np.int32, np.int32, np.int32)]
    node_count = np.zeros(n_trees, np.int64)
    depth = np.zeros(n_trees, np.int64)
    rc = get_lib().glia_forest_train(
        n, D, X32, np.ascontiguousarray(y_idx, np.int32), len(classes),
        n_trees, counts, seeds, mtry, -1, int(n_threads), offset, *out,
        node_count, depth)
    if rc != 0:
        raise RuntimeError("forest training wrote past a tree's room")
    N = int(node_count.max())
    feature = np.full((n_trees, N), -1, np.int32)
    threshold = np.zeros((n_trees, N), np.float32)
    left, right, leaf_class = (np.zeros((n_trees, N), np.int32)
                               for _ in range(3))
    for t in range(n_trees):
        a, m = offset[t], node_count[t]
        for dst, src in zip((feature, threshold, left, right, leaf_class),
                            out):
            dst[t, :m] = src[a:a + m]
    return Forest(feature, threshold, left, right, leaf_class, classes,
                  int(depth.max()), D)
