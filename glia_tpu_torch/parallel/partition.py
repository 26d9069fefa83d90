"""RAG partitioning for edge-parallel processing (a copy of
glia_tpu.parallel.partition).

Regions partition across shards by a space-filling (Morton z-order)
traversal of their centroids: spatially compact blocks keep most edges
internal; the cut edges' endpoint regions form each shard's *halo*, the
only data that must travel between ranks during aggregation.  Host-side
planning lives here; the collectives live in rag_shard.py / halo.py /
train.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..features.adv_shape import region_centroids
from ..graph.rag import Rag


def _morton2(x: np.ndarray, y: np.ndarray, bits=16) -> np.ndarray:
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    return spread(x) | (spread(y) << np.uint64(1))


@dataclass
class Partition:
    n_shards: int
    region_shard: np.ndarray   # [R] shard of each region (rag.keys order)
    edge_shard: np.ndarray     # [E] shard owning each edge
    cut_mask: np.ndarray       # [E] True for cross-shard edges
    halo_regions: List[np.ndarray]  # per shard: region indices it must
                                    # receive from elsewhere

    @property
    def cut_fraction(self) -> float:
        return float(self.cut_mask.mean()) if len(self.cut_mask) else 0.0

    def balance(self) -> float:
        """max/mean edges per shard (1.0 = perfect)."""
        counts = np.bincount(self.edge_shard, minlength=self.n_shards)
        return float(counts.max() / max(counts.mean(), 1e-9))


def partition_rag(rag: Rag, n_shards: int) -> Partition:
    """Z-order region partition with equal-count splits; edges owned by
    their lower-shard endpoint."""
    if rag.region_ptr is None:
        raise ValueError("need full RAG (contour_only=False)")
    cents = region_centroids(None, rag.keys, rag.region_ptr,
                             rag.region_pixels, rag.shape)
    # the first two coords (x, y); a volume interleaves x, y only
    x = np.clip(cents[:, 0], 0, None).astype(np.int64)
    y = np.clip(cents[:, 1], 0, None).astype(np.int64)
    code = _morton2(x, y)
    order = np.argsort(code, kind="stable")
    R = rag.n_regions
    region_shard = np.zeros(R, dtype=np.int32)
    bounds = np.linspace(0, R, n_shards + 1).astype(np.int64)
    for s in range(n_shards):
        region_shard[order[bounds[s]:bounds[s + 1]]] = s

    ui = rag.key_index(rag.edges[:, 0]).astype(np.int64)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int64)
    su = region_shard[ui]
    sv = region_shard[vi]
    edge_shard = np.minimum(su, sv)
    cut = su != sv

    halo = []
    for s in range(n_shards):
        own_edges = edge_shard == s
        needed = np.unique(np.concatenate([ui[own_edges], vi[own_edges]]))
        halo.append(needed[region_shard[needed] != s])
    return Partition(n_shards=n_shards, region_shard=region_shard,
                     edge_shard=edge_shard, cut_mask=cut,
                     halo_regions=halo)
