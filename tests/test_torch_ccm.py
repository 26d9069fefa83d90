"""The port's CCM tree resolution (infer/ccm.py) and merge-path generator
(graph/tree.py gen_merge_paths) against glia_tpu's, on seeded random merge
trees and on tests/test_tree.py's cases.  Tolerance: exact (picks, paths
and energies equal; the same float64 arithmetic in the same order).
"""

import numpy as np
import pytest

from glia_tpu.graph.tree import build_tree as j_build_tree
from glia_tpu.graph.tree import gen_merge_paths as j_gen_merge_paths
from glia_tpu.infer import ccm as jccm
from glia_tpu_torch.graph.tree import FMAX, build_tree, gen_merge_paths
from glia_tpu_torch.infer import ccm

ORDER = np.array([[1, 2, 5], [3, 4, 6], [5, 6, 7]])


def random_order(rng, n_leaves, merge_all=True):
    """A merge order over leaves 1..n_leaves: random pairs of live regions
    merge into new keys; with ``merge_all`` False, a forest (some roots
    never merge)."""
    live = list(range(1, n_leaves + 1))
    nxt = n_leaves + 1
    rows = []
    stop = 1 if merge_all else max(2, n_leaves // 4)
    while len(live) > stop:
        i, j = rng.choice(len(live), 2, replace=False)
        a, b = live[i], live[j]
        live = [x for x in live if x not in (a, b)] + [nxt]
        rows.append([a, b, nxt])
        nxt += 1
    return np.array(rows, dtype=np.int64)


def random_probs(rng, n):
    """Merge probabilities with exact 0s and 1s mixed in, so that the
    saturating FMAX energies are exercised."""
    p = rng.random(n)
    p[rng.random(n) < 0.1] = 0.0
    p[rng.random(n) < 0.1] = 1.0
    return p


@pytest.mark.parametrize("probs", [[0.99, 0.99, 0.99], [0.01, 0.01, 0.01],
                                   [0.95, 0.05, 0.05]])
def test_ccm_picks_on_test_tree_cases(probs):
    want = jccm.segment_ccm_picks(j_build_tree(ORDER), probs)
    assert ccm.segment_ccm_picks(build_tree(ORDER), probs) == want


@pytest.mark.parametrize("seed", range(6))
def test_ccm_picks_on_random_trees(seed):
    rng = np.random.default_rng(seed)
    order = random_order(rng, int(rng.integers(5, 60)))
    p = random_probs(rng, len(order))
    tree, jtree = build_tree(order), j_build_tree(order)
    em, es = ccm.node_energies(tree, p)
    jem, jes = jccm.node_energies(jtree, p)
    np.testing.assert_array_equal(em, jem)
    np.testing.assert_array_equal(es, jes)
    EM, ES = ccm.compute_energy_tuples(tree, em, es)
    jEM, jES = jccm.compute_energy_tuples(jtree, jem, jes)
    np.testing.assert_array_equal(EM, jEM)
    np.testing.assert_array_equal(ES, jES)
    assert ccm.segment_ccm_picks(tree, p) == jccm.segment_ccm_picks(jtree, p)
    for i in rng.choice(tree.n_nodes, 5, replace=False):
        i = int(i)
        assert ccm.node_energy_positive(tree, i, EM, ES, em, es) == \
            jccm.node_energy_positive(jtree, i, jEM, jES, jem, jes)
        assert ccm.node_energy_negative(tree, i, EM, ES, em, es) == \
            jccm.node_energy_negative(jtree, i, jEM, jES, jem, jes)


@pytest.mark.parametrize("seed", range(3))
def test_ccm_full_label_and_marginal_energies(seed):
    rng = np.random.default_rng(seed + 10)
    order = random_order(rng, 7)
    p = random_probs(rng, len(order))
    tree, jtree = build_tree(order), j_build_tree(order)
    em, es = ccm.node_energies(tree, p)
    full = ccm.ccm_full_label_energies(tree, em, es)
    jfull = jccm.ccm_full_label_energies(jtree, em, es)
    np.testing.assert_array_equal(full[0], jfull[0])
    assert full[1] == jfull[1]
    for i in range(tree.n_nodes):
        np.testing.assert_array_equal(
            ccm.ccm_node_marginal_energy(tree, i, em, es, full),
            jccm.ccm_node_marginal_energy(jtree, i, em, es, jfull))


def test_plus_equal_saturates():
    for a, b in [(FMAX, 1.0), (1.0, FMAX), (-FMAX, -1.0), (-1.0, -FMAX),
                 (FMAX, -1.0), (2.0, 3.0)]:
        assert ccm._plus_equal(a, b) == jccm._plus_equal(a, b)


@pytest.mark.parametrize("args", [(None, 1), (2, 1), (3, 2), (4, 2)])
@pytest.mark.parametrize("seed", range(3))
def test_gen_merge_paths(seed, args):
    rng = np.random.default_rng(seed)
    for merge_all in (True, False):
        order = random_order(rng, 40, merge_all)
        assert gen_merge_paths(order, *args) == j_gen_merge_paths(order, *args)
    assert gen_merge_paths(ORDER, *args) == j_gen_merge_paths(ORDER, *args)
