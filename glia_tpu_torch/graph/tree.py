"""Merge trees as flat arrays.

Replaces the reference's ``TTree<T>`` node-vector (code/type/tree.hxx) with
struct-of-arrays storage: a merge order of n merges yields M = n + #leaves
nodes in *creation order* (children always precede parents), which makes
bottom-up passes simple forward scans and top-down passes backward scans --
the natural layout for both numpy and ``jax.lax.scan``.

Construction parity: genTree (code/hmt/tree_build.hxx:13-38) -- for each
merge (r0, r1, r2), create leaf nodes for unseen r0 then r1, then the
internal node r2 with children [node(r0), node(r1)].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class MergeTree:
    keys: np.ndarray      # int64 [M] node region labels, creation order
    parent: np.ndarray    # int32 [M], -1 for root
    left: np.ndarray      # int32 [M], -1 for leaves
    right: np.ndarray     # int32 [M], -1 for leaves
    order: np.ndarray     # int64 [n,3] the originating merge order

    @property
    def n_nodes(self) -> int:
        return len(self.keys)

    @property
    def is_leaf(self) -> np.ndarray:
        return self.left < 0

    @property
    def root(self) -> int:
        # tree.hxx root() = node with parent < 0; creation order puts it last
        return self.n_nodes - 1

    def ancestors(self, i: int) -> List[int]:
        out = []
        p = int(self.parent[i])
        while p >= 0:
            out.append(p)
            p = int(self.parent[p])
        return out

    def descendants(self, i: int) -> List[int]:
        """BFS order, excluding i itself (tree.hxx:114-127)."""
        out = []
        queue = [i]
        while queue:
            j = queue.pop(0)
            for c in (int(self.left[j]), int(self.right[j])):
                if c >= 0:
                    out.append(c)
                    queue.append(c)
        return out

    def leaves_under(self, i: int) -> List[int]:
        out = []
        stack = [i]
        while stack:
            j = stack.pop()
            if self.left[j] < 0:
                out.append(j)
            else:
                stack.append(int(self.right[j]))
                stack.append(int(self.left[j]))
        return out


def build_tree(order) -> MergeTree:
    """genTree (tree_build.hxx:13-38): order triples -> flat tree."""
    order = np.asarray(order, dtype=np.int64).reshape(-1, 3)
    nmap = {}
    keys, parent, left, right = [], [], [], []

    def new_node(key, l=-1, r=-1):
        keys.append(key)
        parent.append(-1)
        left.append(l)
        right.append(r)
        return len(keys) - 1

    for r0, r1, r2 in order:
        r0, r1, r2 = int(r0), int(r1), int(r2)
        if r0 not in nmap:
            nmap[r0] = new_node(r0)
        if r1 not in nmap:
            nmap[r1] = new_node(r1)
        n0, n1 = nmap[r0], nmap[r1]
        ni = new_node(r2, n0, n1)
        parent[n0] = ni
        parent[n1] = ni
        nmap[r2] = ni

    return MergeTree(
        keys=np.asarray(keys, dtype=np.int64),
        parent=np.asarray(parent, dtype=np.int32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        order=order,
    )


def node_potentials(tree: MergeTree, merge_probs) -> np.ndarray:
    """genTreeWithNodePotentials (tree_build.hxx:43-63).

    merge_probs: one P(merge) per internal node in creation (merge) order.
    Internal node potential = p; each child is multiplied by (1-p), with
    leaf children getting (1-p)^2; the root is finally squared.
    """
    merge_probs = np.asarray(merge_probs, dtype=np.float64)
    pot = np.ones(tree.n_nodes, dtype=np.float64)
    is_leaf = tree.is_leaf
    mi = 0
    for i in range(tree.n_nodes):
        if is_leaf[i]:
            continue
        p = merge_probs[mi]
        mi += 1
        pot[i] *= p
        psplit = 1.0 - p
        for c in (int(tree.left[i]), int(tree.right[i])):
            if is_leaf[c]:
                pot[c] = psplit * psplit
            else:
                pot[c] *= psplit
    pot[tree.root] *= pot[tree.root]
    return pot
