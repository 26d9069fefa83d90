"""Boundary-confidence maps from merge-tree node potentials.

Reference: genBoundaryConfidenceMap / genBoundaryConfidenceImage
(code/hmt/tree_segment.hxx:71-200): every tree node contributes its value
to all base boundary pairs still present in its region's boundary map; a
pair keeps the MAX value over contributing nodes; the image assigns that
value to the pair's boundary pixels.

A base directed pair (a,b) is alive in node n's boundary map iff
leaf(a) is under n and the pair's cancellation point (the LCA of a and b,
for mutual pairs) is NOT under-or-equal... precisely: alive on the path
leaf(a)..lca(a,b) exclusive of the lca (mutual pairs), or the whole
leaf(a)..root path (non-mutual pairs).  So the pair's value is the max
node value along that path -- computed here with one upward walk per pair
over precomputed per-node values.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..graph.rag import Rag
from ..graph.tree import MergeTree


def boundary_confidence(rag: Rag, tree: MergeTree, node_values,
                        picks=None, shape=None):
    """Confidence image [shape] with per-boundary-pixel max node value.

    picks: restrict contributing nodes to this set (tree_segment.hxx:94-99);
    None/empty -> all nodes.
    """
    node_values = np.asarray(node_values, dtype=np.float64)
    shape = shape or rag.shape
    use = np.ones(tree.n_nodes, dtype=bool)
    if picks:
        use = np.zeros(tree.n_nodes, dtype=bool)
        use[np.asarray(list(picks), dtype=np.int64)] = True

    key2node = {int(k): i for i, k in enumerate(tree.keys)}
    depth = tree.depth_vector()
    parent = tree.parent

    def lca(i, j):
        while i != j:
            if depth[i] >= depth[j]:
                i = int(parent[i])
            else:
                j = int(parent[j])
            if i < 0 or j < 0:
                return -1
        return i

    # mutual classification of directed pairs
    dir_code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
    rev_code = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
    sc = np.sort(dir_code)
    pos = np.searchsorted(sc, rev_code)
    mutual = (pos < len(sc)) & (sc[np.minimum(pos, len(sc) - 1)] == rev_code)

    out = np.zeros(int(np.prod(shape)), dtype=np.float32)
    Ed = len(rag.dir_pairs)
    pair_val: Dict[int, float] = {}
    for e in range(Ed):
        a, b = int(rag.dir_pairs[e, 0]), int(rag.dir_pairs[e, 1])
        na = key2node.get(a, -1)
        if na < 0:
            continue
        nb = key2node.get(b, -1)
        stop = lca(na, nb) if (mutual[e] and nb >= 0) else -1
        best = -np.inf
        i = na
        while i >= 0 and i != stop:
            if use[i]:
                best = max(best, node_values[i])
            i = int(parent[i])
        if not np.isfinite(best):
            continue
        # max over both directions of the same undirected pair
        code = (min(a, b) << 32) | max(a, b)
        if code not in pair_val or pair_val[code] < best:
            pair_val[code] = best
    for e in range(Ed):
        a, b = int(rag.dir_pairs[e, 0]), int(rag.dir_pairs[e, 1])
        code = (min(a, b) << 32) | max(a, b)
        val = pair_val.get(code)
        if val is None:
            continue
        s, t = int(rag.dir_ptr[e]), int(rag.dir_ptr[e + 1])
        out[rag.dir_pixels[s:t]] = val
    return out.reshape(shape)
