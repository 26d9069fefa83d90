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
from typing import List, Optional

import numpy as np

FMAX = np.finfo(np.float64).max


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
    def n_leaves(self) -> int:
        return int(self.is_leaf.sum())

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


    def depth_vector(self) -> np.ndarray:
        """Depth (root = 0) per node; backward scan works since parent > child."""
        d = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes - 2, -1, -1):
            p = self.parent[i]
            if p >= 0:
                d[i] = d[p] + 1
        return d


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


def gen_merge_paths(order, path_length: Optional[int] = None,
                    min_path_length: int = 1) -> List[List[int]]:
    """genMergePaths (tree_build.hxx:125-180).

    Without ``path_length``: root paths starting at merges whose both inputs
    are leaves, following parents to the root; returns merge-index paths.
    With ``path_length``: every merge starts a path, extended up to
    ``path_length``; kept if it reaches full length, or is >= min length
    AND starts at a leaf-leaf merge.
    """
    order = np.asarray(order, dtype=np.int64).reshape(-1, 3)
    n = len(order)
    non_leaf = {}
    child_merge = {}
    starts = []
    all_paths = []
    for i in range(n):
        child_merge[int(order[i, 0])] = i
        child_merge[int(order[i, 1])] = i
        non_leaf[int(order[i, 2])] = i
        leaf_leaf = (int(order[i, 0]) not in non_leaf
                     and int(order[i, 1]) not in non_leaf)
        if path_length is None:
            if leaf_leaf:
                starts.append(i)
        else:
            all_paths.append([i])
    paths = []
    if path_length is None:
        for s in starts:
            path = [s]
            key = int(order[path[-1], 2])
            while key in child_merge:
                path.append(child_merge[key])
                key = int(order[path[-1], 2])
            paths.append(path)
    else:
        non_leaf_keys = set(int(order[i, 2]) for i in range(n))
        for path in all_paths:
            key = int(order[path[-1], 2])
            while key in child_merge and len(path) < path_length:
                path.append(child_merge[key])
                key = int(order[path[-1], 2])
            i0 = path[0]
            leaf_leaf = (int(order[i0, 0]) not in non_leaf_keys
                         and int(order[i0, 1]) not in non_leaf_keys)
            if len(path) == path_length or (
                    len(path) >= min_path_length and leaf_leaf):
                paths.append(path)
    return paths


def pairs_lca(tree: MergeTree, pair_leaf_a, pair_leaf_b) -> np.ndarray:
    """LCA node index for many (leaf, leaf) pairs at once.

    Offline union-find over the merge sequence with small-to-large pair
    lists: a pair's LCA is the internal node created by the merge that
    first joins its endpoints' components -- O((M + P) log P), replacing
    per-pair ancestor walks (O(P * depth), quadratic on chain-like merge
    trees).  Pairs whose endpoints never join (or with leaf index < 0)
    get -1.
    """
    P = len(pair_leaf_a)
    out = np.full(P, -1, dtype=np.int64)
    comp = {}      # leaf/root node -> comp id
    parent = {}    # DSU
    plist = {}     # comp root -> list of pair ids

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    leaf_nodes = np.nonzero(tree.is_leaf)[0]
    for n in leaf_nodes:
        parent[int(n)] = int(n)
        plist[int(n)] = []
    for pi in range(P):
        a, b = int(pair_leaf_a[pi]), int(pair_leaf_b[pi])
        if a < 0 or b < 0 or a == b:
            continue
        plist[a].append(pi)
        plist[b].append(pi)
    pa = np.asarray(pair_leaf_a, dtype=np.int64)
    pb = np.asarray(pair_leaf_b, dtype=np.int64)
    for i in range(tree.n_nodes):
        l, r = int(tree.left[i]), int(tree.right[i])
        if l < 0:
            continue
        ra, rb = find(l), find(r)
        if len(plist[ra]) < len(plist[rb]):
            ra, rb = rb, ra
        # merge rb into ra
        keep = plist[ra]
        for pi in plist[rb]:
            if out[pi] >= 0:
                continue
            fa, fb = find(int(pa[pi])), find(int(pb[pi]))
            if {fa, fb} == {ra, rb}:
                out[pi] = i
            else:
                keep.append(pi)
        parent[rb] = ra
        plist[rb] = []
        plist[ra] = keep
        parent[i] = ra  # the new internal node joins the merged component
    return out


def dfs_intervals(tree: MergeTree):
    """Host preprocessing: leaf DFS positions + per-node [lo, hi) intervals.

    Returns (leaf_pos [M] with -1 for internal, lo [M], hi [M],
    leaf_order [n_leaves] = node index of the leaf at each DFS slot).
    """
    M = tree.n_nodes
    lo = np.zeros(M, dtype=np.int64)
    hi = np.zeros(M, dtype=np.int64)
    leaf_pos = np.full(M, -1, dtype=np.int64)
    leaf_order = []
    # iterative DFS from every root (tree may be a forest with extra leaves)
    roots = [i for i in range(M) if tree.parent[i] < 0]
    counter = 0
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, done = stack.pop()
            if done:
                hi[node] = counter
                continue
            if tree.left[node] < 0:
                lo[node] = counter
                leaf_pos[node] = counter
                leaf_order.append(node)
                counter += 1
                hi[node] = counter
            else:
                lo[node] = counter
                stack.append((node, True))
                stack.append((int(tree.right[node]), False))
                stack.append((int(tree.left[node]), False))
    return leaf_pos, lo, hi, np.asarray(leaf_order, dtype=np.int64)
