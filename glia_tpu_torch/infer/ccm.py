"""CCM (conditional model) tree inference: bottom-up DP + top-down picks.

Reference: code/hmt/tree_ccm.hxx and code/hmt/main_segment_ccm.cxx:29-51.
Node energies from merge probabilities p (one per internal node, merge
order): Em = -log p (FMAX if p ~ 0), Es = -log(1-p) (FMAX if p ~ 1);
leaves get Em = 0, Es = FMAX.  Saturating addition mirrors
stats::plusEqual (code/util/stats.hxx:9-17).

Host numpy, as in glia_tpu (the port's copy of glia_tpu.infer.ccm).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..constants import FEPS
from ..graph.tree import FMAX, MergeTree


def _plus_equal(a: float, b: float) -> float:
    """Saturating add (stats.hxx:9-17)."""
    if (a == FMAX and b >= 0.0) or (a >= 0.0 and b == FMAX):
        return FMAX
    if (a == -FMAX and b <= 0.0) or (a <= 0.0 and b == -FMAX):
        return -FMAX
    return a + b


def node_energies(tree: MergeTree, merge_probs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node (Em, Es) from merge probabilities (main_segment_ccm.cxx:39-51)."""
    p = np.asarray(merge_probs, dtype=np.float64)
    em = np.zeros(tree.n_nodes, dtype=np.float64)
    es = np.full(tree.n_nodes, FMAX, dtype=np.float64)
    internal = np.nonzero(~tree.is_leaf)[0]
    pi = p[: len(internal)]
    em[internal] = np.where(np.abs(pi) < FEPS, FMAX, -np.log(np.maximum(pi, 1e-300)))
    q = 1.0 - pi
    es[internal] = np.where(np.abs(q) < FEPS, FMAX, -np.log(np.maximum(q, 1e-300)))
    return em, es


def compute_energy_tuples(tree: MergeTree, em, es) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom-up DP (tree_ccm.hxx:13-27).

    EM[i] = em[i] + sum_children EM[child]
    ES[i] = es[i] + sum_children min(EM[child], ES[child])
    Forward scan works: children precede parents in creation order.
    """
    EM = np.array(em, dtype=np.float64)
    ES = np.array(es, dtype=np.float64)
    for i in range(tree.n_nodes):
        for c in (int(tree.left[i]), int(tree.right[i])):
            if c >= 0:
                EM[i] = _plus_equal(EM[i], EM[c])
                ES[i] = _plus_equal(ES[i], min(EM[c], ES[c]))
    return EM, ES


def resolve_factor_tree(tree: MergeTree, EM, ES) -> List[int]:
    """Top-down picks (tree_ccm.hxx:31-47): BFS from root; pick node iff
    EM < ES else recurse into children."""
    picks = []
    queue = [tree.root]
    while queue:
        i = queue.pop(0)
        if EM[i] < ES[i]:
            picks.append(i)
        else:
            l, r = int(tree.left[i]), int(tree.right[i])
            if l >= 0:
                queue.append(l)
                queue.append(r)
    return picks


def segment_ccm_picks(tree: MergeTree, merge_probs) -> List[int]:
    em, es = node_energies(tree, merge_probs)
    EM, ES = compute_energy_tuples(tree, em, es)
    return resolve_factor_tree(tree, EM, ES)


def node_energy_positive(tree: MergeTree, i: int, EM, ES, em, es) -> float:
    """Best labeling energy with node i labeled as a segment
    (tree_ccm.hxx:62-83)."""
    ret = EM[i]
    prev = i
    j = int(tree.parent[i])
    while j >= 0:
        ret = _plus_equal(ret, es[j])
        for c in (int(tree.left[j]), int(tree.right[j])):
            if c != prev:
                ret = _plus_equal(ret, min(EM[c], ES[c]))
        prev = j
        j = int(tree.parent[j])
    return ret


def node_energy_negative(tree: MergeTree, i: int, EM, ES, em, es) -> float:
    """Best labeling energy with node i NOT a segment (tree_ccm.hxx:87-115)."""
    ret = es[i]
    queue = [int(tree.left[i]), int(tree.right[i])] if tree.left[i] >= 0 else []
    while queue:
        j = queue.pop(0)
        if EM[j] < ES[j]:
            ret = _plus_equal(ret, EM[j])
        else:
            if tree.left[j] >= 0:
                queue.append(int(tree.left[j]))
                queue.append(int(tree.right[j]))
    prev = i
    j = int(tree.parent[i])
    while j >= 0:
        ret = _plus_equal(ret, es[j])
        for c in (int(tree.left[j]), int(tree.right[j])):
            if c != prev:
                ret = _plus_equal(ret, min(EM[c], ES[c]))
        prev = j
        j = int(tree.parent[j])
    return ret


# ---------------------------------------------------------------------------
# exponential full-label enumeration + marginals (tree_ccm.hxx:124-190)
# ---------------------------------------------------------------------------

def ccm_full_label_energies(tree: MergeTree, em, es):
    """computeFactorTreeFullLabelEnergy (tree_ccm.hxx:124-157).

    Returns (Em_full [n], Es_lists): Em_full[i] = energy of everything
    below i merging; Es_lists[i] = energies of ALL consistent labelings
    that resolve i's subtree (cartesian products of children labelings
    plus the "pick i" option), in the reference's enumeration order.
    Exponential time/space -- small trees only (the reference keeps this
    out of its main path too; capability parity).
    """
    n = tree.n_nodes
    em_full = np.zeros(n, dtype=np.float64)
    es_lists: List[List[float]] = [[] for _ in range(n)]
    for i in range(n):
        l, r = int(tree.left[i]), int(tree.right[i])
        if l < 0:
            em_full[i] = 0.0
            es_lists[i] = [0.0]
            continue
        em_sum = 0.0
        for c in (l, r):
            em_sum = _plus_equal(em_sum, em_full[c])
        em_full[i] = _plus_equal(float(em[i]), em_sum)
        out: List[float] = []
        for x0 in es_lists[l]:          # reference combination order:
            r0 = _plus_equal(float(es[i]), x0)   # first list outermost
            for x1 in es_lists[r]:
                out.append(_plus_equal(r0, x1))
        out.append(em_full[i])
        es_lists[i] = out
    return em_full, es_lists


def ccm_node_marginal_energy(tree: MergeTree, i: int, em, es, full=None):
    """computeFactorNodeMarginalEnergy (tree_ccm.hxx:160-190): energies
    of all labelings in which node i is a picked segment -- i's branch
    cost plus every combination of the off-path sibling subtrees'
    labelings, in the reference's enumeration order."""
    em_full, es_lists = full if full is not None \
        else ccm_full_label_energies(tree, em, es)
    e_branch = float(es[i])
    for c in (int(tree.left[i]), int(tree.right[i])):
        if c >= 0:
            e_branch = _plus_equal(e_branch, em_full[c])
    sib_lists: List[List[float]] = []
    prev = i
    for a in tree.ancestors(i):
        e_branch = _plus_equal(e_branch, float(es[a]))
        for c in (int(tree.left[a]), int(tree.right[a])):
            if c >= 0 and c != prev:
                sib_lists.append(es_lists[c])
        prev = a
    out = [e_branch]
    for lst in sib_lists:               # same fold order as combination
        out = [_plus_equal(res, x) for res in out for x in lst]
    return np.asarray(out, dtype=np.float64)
