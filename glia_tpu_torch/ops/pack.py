"""Vectorized packing of ragged CSR pixel lists into dense [E, K] blocks
(a copy of glia_tpu.ops.pack).

Used by the edge-scoring paths (boundary pixels per edge, truncated or
padded to K) in place of per-edge Python loops.
"""

from __future__ import annotations

import numpy as np


def pack_csr_values(values_flat, ptr, k):
    """values_flat [B], ptr [E+1] -> (vals [E, K], mask [E, K]).

    Takes the first k entries of each segment (truncating longer ones).
    """
    ptr = np.asarray(ptr, dtype=np.int64)
    lens = np.minimum(np.diff(ptr), k)
    col = np.arange(k)[None, :]
    mask = col < lens[:, None]
    idx = ptr[:-1, None] + np.minimum(col, np.maximum(lens[:, None] - 1, 0))
    values_flat = np.asarray(values_flat)
    idx = np.clip(idx, 0, max(len(values_flat) - 1, 0))
    vals = values_flat[idx]
    vals = np.where(mask, vals, 0)
    return vals.astype(np.float32), mask.astype(np.float32)


def pack_edge_pixels(rag, image, k=32):
    """Per-edge boundary pixel values packed to [E, k] (+mask) and dense
    endpoint indices."""
    pbf = np.asarray(image, dtype=np.float32).ravel()
    vals, mask = pack_csr_values(pbf[rag.edge_pixels], rag.edge_ptr, k)
    u = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    v = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    return u, v, vals, mask
