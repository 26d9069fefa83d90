"""Merge-tree aggregation on the device (bottom-up "tree SpMM"), PyTorch.

Counterpart of glia_tpu.ops.tree_scan.  The hierarchical feature pass
needs, for every one of the 2N-1 tree nodes, reductions over its leaf set.
With the leaves laid out in DFS order (``graph.tree.dfs_intervals``)
every node's leaf set is one contiguous interval [lo, hi), so

  - additive stats for ALL nodes = two gathers into an exclusive prefix
    sum (O(N) work, no sequential tree walk);
  - min/max stats for ALL nodes = range-min/max queries answered with a
    log2(N)-level sparse table (pairwise mins), again gathers.

The device form of the reference's per-region pixel re-traversals
(code/hmt/main_bc_feat.cxx:59-69).  ``features.hierarchical.TreeFeatures``
stays on the host, as glia_tpu's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.tree import MergeTree, dfs_intervals


def interval_sums(leaf_values: torch.Tensor, lo, hi) -> torch.Tensor:
    """Additive stats for all nodes: leaf_values [L, F] in DFS order ->
    [M, F] interval sums via exclusive prefix sum + two gathers."""
    dev = leaf_values.device
    P = torch.cat([leaf_values.new_zeros((1,) + leaf_values.shape[1:]),
                   torch.cumsum(leaf_values, dim=0)])
    return (P[torch.as_tensor(hi, device=dev)]
            - P[torch.as_tensor(lo, device=dev)])


def _sparse_table(values, combine):
    """log2 sparse table rows for range queries; values [L, F]: row k
    holds the combine of each window of 2^k leaves."""
    L = values.shape[0]
    tables = [values]
    k = 1
    while (1 << k) <= L:
        prev = tables[-1]
        half = 1 << (k - 1)
        tables.append(combine(prev[: L - (1 << k) + 1],
                              prev[half: L - half + 1]))
        k += 1
    return tables


def interval_reduce(leaf_values: torch.Tensor, lo, hi,
                    kind="min") -> torch.Tensor:
    """Range min/max for all nodes via sparse table (O(L log L) build,
    O(1) per query).  Empty intervals -> +inf/-inf."""
    combine = torch.minimum if kind == "min" else torch.maximum
    dev = leaf_values.device
    tables = _sparse_table(leaf_values, combine)
    lo = torch.as_tensor(lo, device=dev)
    hi = torch.as_tensor(hi, device=dev)
    length = torch.clamp(hi - lo, min=1)
    # floor(log2(length)), made exact with two integer corrections
    k = torch.floor(torch.log2(length.to(torch.float32))).long()
    k = torch.where(torch.bitwise_left_shift(torch.ones_like(k), k + 1)
                    <= length, k + 1, k)
    k = torch.where(torch.bitwise_left_shift(torch.ones_like(k), k)
                    > length, k - 1, k)
    fill = float("inf") if kind == "min" else float("-inf")
    out = leaf_values.new_full((lo.shape[0],) + leaf_values.shape[1:], fill)
    for ki, tab in enumerate(tables):
        sel = k == ki
        a = torch.clamp(lo, 0, tab.shape[0] - 1)
        b = torch.clamp(hi - (1 << ki), 0, tab.shape[0] - 1)
        cand = combine(tab[a], tab[b])
        out = torch.where(sel[:, None] if cand.ndim > 1 else sel, cand, out)
    empty = hi <= lo
    return torch.where(empty[:, None] if out.ndim > 1 else empty, fill, out)


def node_region_stats_device(tree: MergeTree, leaf_stats,
                             device: DeviceLike = None):
    """All-node region stats from per-leaf stats, on ``device`` (the CUDA
    card by default).

    leaf_stats: dict with additive ("sum"-like, [n_leaves, F]) and
    reduce ("min"/"max", [n_leaves, F]) entries keyed by
    ("add", name) / ("min", name) / ("max", name), leaf rows indexed by
    tree LEAF NODE index order (tree.keys order restricted to leaves).

    Returns dict name -> [M, F] tensors over all nodes."""
    dev = resolve_device(device)
    _, lo, hi, leaf_order = dfs_intervals(tree)
    # leaf_stats rows are in the order of np.nonzero(is_leaf): reorder
    # them to DFS slots
    row_of = np.full(tree.n_nodes, -1, dtype=np.int64)
    leaf_nodes = np.nonzero(tree.is_leaf)[0]
    row_of[leaf_nodes] = np.arange(len(leaf_nodes))
    perm = row_of[leaf_order]
    lo_d = torch.as_tensor(lo, device=dev)
    hi_d = torch.as_tensor(hi, device=dev)
    out = {}
    for (kind, name), vals in leaf_stats.items():
        v = torch.as_tensor(np.asarray(vals)[perm], device=dev)
        if kind == "add":
            out[name] = interval_sums(v, lo_d, hi_d)
        else:
            out[name] = interval_reduce(v, lo_d, hi_d, kind)
    return out
