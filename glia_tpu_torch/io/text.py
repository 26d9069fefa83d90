"""Whitespace text IO for merge orders, saliencies, and feature matrices
(a copy of glia_tpu.io.text).

The reference's entire inter-stage "file bus" is whitespace-delimited text
(code/util/text_io.hxx) plus the merge-order record format: one
``r0 r1 r2`` triple per line (code/type/tuple.hxx:9-31 stream operators,
written by code/hmt/main_merge_order_pb.cxx:37-38).  These functions keep the
formats byte-compatible so artifacts interchange with the reference binaries.
"""

from __future__ import annotations

import numpy as np


def read_merge_order(path):
    """Read an ``r0 r1 r2`` merge order file -> int64 array [n_merges, 3]."""
    arr = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if arr.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    if arr.shape[1] != 3:
        raise ValueError(f"merge order must have 3 columns, got {arr.shape}")
    return arr


def write_merge_order(path, order):
    """Write merge order triples, one per line (tuple.hxx:24-29 format)."""
    order = np.asarray(order, dtype=np.int64)
    with open(path, "w") as f:
        for r0, r1, r2 in order:
            f.write(f"{r0} {r1} {r2}\n")


def read_vector(path, dtype=np.float64):
    """Read one value per line (saliency files etc.)."""
    return np.loadtxt(path, dtype=dtype, ndmin=1)


def write_vector(path, vec, fmt="%.17g"):
    with open(path, "w") as f:
        for v in np.asarray(vec).ravel():
            f.write((fmt % v) + "\n")


def read_matrix(path, dtype=np.float64):
    """Read a whitespace matrix (one row per line), like text_io.hxx readData."""
    return np.loadtxt(path, dtype=dtype, ndmin=2)


def write_matrix(path, mat, fmt="%.17g"):
    mat = np.asarray(mat)
    with open(path, "w") as f:
        for row in mat:
            f.write(" ".join(fmt % v for v in row) + "\n")
