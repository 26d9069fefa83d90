"""Greedy consistent-node tree resolution.

Reference: code/hmt/tree_greedy.hxx.  Repeatedly pick the valid node with
maximum potential (ties -> lowest node index, then lowest tree index, from
the strict-< comparator scan in pickTreeNode, tree_greedy.hxx:83-99);
invalidate it plus all its ancestors and descendants; for multi-tree
consensus, also invalidate in *other* trees every leaf sharing a picked
leaf label and those leaves' ancestors (tree_greedy.hxx:104-152).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..graph.tree import MergeTree, collect_sub_keys


def resolve_tree_greedy(tree: MergeTree, potentials) -> List[int]:
    """Single-tree resolution (tree_greedy.hxx:51-71). Returns picked nodes."""
    return [p[1] for p in resolve_trees_greedy([tree], [potentials])]


def resolve_trees_greedy(
    trees: Sequence[MergeTree], potentials: Sequence[np.ndarray]
) -> List[Tuple[int, int]]:
    """Multi-tree consensus resolution (tree_greedy.hxx:104-152).

    Returns picks as (tree_index, node_index) in pick order.
    """
    n_tree = len(trees)
    validity = [np.ones(t.n_nodes, dtype=bool) for t in trees]
    pots = [np.asarray(p, dtype=np.float64) for p in potentials]
    # leaf label -> node index per tree
    lnmap = []
    for t in trees:
        m = {}
        leaf_idx = np.nonzero(t.is_leaf)[0]
        for i in leaf_idx:
            m[int(t.keys[i])] = int(i)
        lnmap.append(m)

    picks: List[Tuple[int, int]] = []
    while True:
        # pick the max-potential valid node; scan order (tree, node index)
        # with strict > so earliest wins ties, matching the reference's
        # comp(ret, node) = ret.potential < node.potential scan.
        best = (-1, -1)
        best_pot = -np.inf
        for ti in range(n_tree):
            v = validity[ti]
            if not v.any():
                continue
            idx = np.nonzero(v)[0]
            local = idx[np.argmax(pots[ti][idx])]
            # np.argmax returns first max -> earliest index, as required
            if pots[ti][local] > best_pot:
                best = (ti, int(local))
                best_pot = pots[ti][local]
        if best[0] < 0:
            break
        ti, ni = best
        picks.append((ti, ni))
        t = trees[ti]
        validity[ti][ni] = False
        for a in t.ancestors(ni):
            validity[ti][a] = False
        # NOTE reference quirk (tree_greedy.hxx:122-130): leaf labels are
        # collected from traverseDescendants, which EXCLUDES the picked node
        # itself -- so picking a leaf does not invalidate that label in the
        # other trees.  Reproduced faithfully.
        leaf_labels = []
        for d in t.descendants(ni):
            validity[ti][d] = False
            if t.left[d] < 0:
                leaf_labels.append(int(t.keys[d]))
        for llabel in leaf_labels:
            for tj in range(n_tree):
                if tj == ti:
                    continue
                nj = lnmap[tj].get(llabel)
                if nj is not None:
                    validity[tj][nj] = False
                    for a in trees[tj].ancestors(nj):
                        validity[tj][a] = False
    return picks


def resolve_trees_greedy_subset(
    trees: Sequence[MergeTree], potentials: Sequence[np.ndarray]
) -> List[List[int]]:
    """Subset-inclusion multi-tree resolution (tree_greedy.hxx:155-230).

    After picking the best node across trees, each *other* tree greedily
    accepts (from highest node index down) any still-valid node touched by
    the picked leaf set whose own leaf set is a subset of the pick's;
    everything else touched is invalidated.  Returns per-tree pick lists.
    """
    n_tree = len(trees)
    pots = [np.asarray(p, dtype=np.float64) for p in potentials]
    validity = [np.ones(t.n_nodes, dtype=bool) for t in trees]
    sub_keys = [[set(map(int, sk)) for sk in collect_sub_keys(t, sort=False)]
                for t in trees]
    lnmap = []
    for t in trees:
        m = {}
        for i in np.nonzero(t.is_leaf)[0]:
            m[int(t.keys[i])] = int(i)
        lnmap.append(m)

    picks: List[List[int]] = [[] for _ in range(n_tree)]
    while True:
        best = (-1, -1)
        best_pot = -np.inf
        for ti in range(n_tree):
            v = validity[ti]
            if not v.any():
                continue
            idx = np.nonzero(v)[0]
            local = idx[np.argmax(pots[ti][idx])]
            if pots[ti][local] > best_pot:
                best = (ti, int(local))
                best_pot = pots[ti][local]
        if best[0] < 0:
            break
        ti, ni = best
        picks[ti].append(ni)
        t = trees[ti]
        validity[ti][ni] = False
        for a in t.ancestors(ni):
            validity[ti][a] = False
        # leaf labels via traverseDescendants: EXCLUDES the picked node, so
        # a picked leaf contributes no labels (reference quirk, kept)
        leaf_labels = []
        for d in t.descendants(ni):
            validity[ti][d] = False
            if t.left[d] < 0:
                leaf_labels.append(int(t.keys[d]))
        pick_keys = sub_keys[ti][ni]
        for tj in range(n_tree):
            if tj == ti:
                continue
            node_indices = set()
            for ll in leaf_labels:
                nj = lnmap[tj][ll]  # reference assumes present (no check)
                node_indices.add(nj)
                for a in trees[tj].ancestors(nj):
                    if validity[tj][a]:
                        node_indices.add(a)
            for nj in sorted(node_indices, reverse=True):
                if validity[tj][nj] and sub_keys[tj][nj] <= pick_keys:
                    picks[tj].append(nj)
                    validity[tj][nj] = False
                    for d in trees[tj].descendants(nj):
                        validity[tj][d] = False
                else:
                    validity[tj][nj] = False
    return picks
