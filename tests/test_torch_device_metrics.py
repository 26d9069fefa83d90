"""Port metrics/device.py and ops/tree_scan.py vs glia_tpu's.

The cases of tests/test_device_metrics.py and tests/test_tree_scan.py
(random label images from the shared ``rng`` fixture; a 48x48 synthetic
slice with its serial median merge order), run on the CPU in float64 on
both sides.  Required: contingency counts and pair counts equal; VI and
Rand within 1e-12 relative of glia_tpu's and of the host metrics; tree
interval sums within 1e-12 relative, interval minima and maxima equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glia_tpu.metrics.device as jd
import glia_tpu.ops.tree_scan as jts
import glia_tpu_torch.metrics.device as td
import glia_tpu_torch.ops.tree_scan as tts
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.graph.merge import greedy_merge_order
from glia_tpu.graph.rag import build_rag
from glia_tpu.graph.tree import build_tree as j_build_tree
from glia_tpu.metrics import centropy, contingency_table, eval_ri, eval_vi
from glia_tpu.metrics.contingency import pair_stats_from_counts
from glia_tpu.native import watershed_native
from glia_tpu_torch.graph.tree import build_tree


def _floats(xs):
    return [float(x) for x in xs]


def _labels(rng, shape, seg_hi, truth_hi):
    seg = rng.integers(1, seg_hi, shape).astype(np.int32)
    truth = rng.integers(0, truth_hi, shape).astype(np.int32)
    return seg, truth


def test_densify_labels_matches(rng):
    seg, truth = _labels(rng, (20, 20), 6, 5)
    for arr, ex in ((seg, ()), (truth, (0,))):
        got, n = td.densify_labels(arr, exclude=ex)
        want, m = jd.densify_labels(arr, exclude=ex)
        np.testing.assert_array_equal(got, want)
        assert n == m


def test_device_vi_matches(rng):
    seg, truth = _labels(rng, (20, 20), 6, 5)
    sid, S = td.densify_labels(seg)
    tid, T = td.densify_labels(truth, exclude=(0,))
    got = _floats(td.vi_device(sid, tid, S, T, device="cpu"))
    want = _floats(jd.vi_device(sid, tid, S, T))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == pytest.approx(
        centropy(truth, seg, excluded0=(0,), itk_quirk=False), rel=1e-9)
    assert got[1] == pytest.approx(
        centropy(seg, truth, excluded1=(0,), itk_quirk=False), rel=1e-9)


def test_device_rand_matches(rng):
    seg, truth = _labels(rng, (16, 16), 6, 5)
    sid, S = td.densify_labels(seg)
    tid, T = td.densify_labels(truth, exclude=(0,))
    got = _floats(td.adapted_rand_device(sid, tid, S, T, device="cpu"))
    np.testing.assert_allclose(
        got, _floats(jd.adapted_rand_device(sid, tid, S, T)), rtol=1e-12)
    np.testing.assert_allclose(got, eval_ri(seg, truth), rtol=1e-9)


def test_contingency_device_matches(rng):
    seg = np.array([0, 0, 1, 1, -1])
    truth = np.array([0, 1, 1, 1, 0])
    c = td.contingency_device(seg, truth, 2, 2, device="cpu")
    assert c.dtype == torch.float64
    np.testing.assert_array_equal(c, [[1, 1], [0, 2]])
    seg, truth = _labels(rng, (30, 30), 9, 7)
    sid, S = td.densify_labels(seg)
    tid, T = td.densify_labels(truth, exclude=(0,))
    np.testing.assert_array_equal(
        td.contingency_device(sid, tid, S, T, device="cpu"),
        np.asarray(jd.contingency_device(sid, tid, S, T)))


def _pairs(rng):
    seg, truth = _labels(rng, (24, 24), 9, 6)
    l0, l1, c = contingency_table(seg, truth, exclude_truth=(0,))
    sid, S = td.densify_labels(l0)
    tid, T = td.densify_labels(l1)
    return seg, truth, sid, tid, c, S, T


@pytest.mark.parametrize("itk_quirk", [True, False])
def test_sparse_pair_vi_matches(rng, itk_quirk):
    seg, truth, sid, tid, c, S, T = _pairs(rng)
    got = _floats(td.vi_from_pairs_device(sid, tid, c, S, T,
                                          itk_quirk=itk_quirk,
                                          device="cpu"))
    want = _floats(jd.vi_from_pairs_device(sid, tid, c, S, T,
                                           itk_quirk=itk_quirk))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if itk_quirk:
        np.testing.assert_allclose(got, eval_vi(seg, truth), rtol=1e-12,
                                   atol=1e-12)


def test_sparse_pair_rand_and_counts_match(rng):
    seg, truth, sid, tid, c, S, T = _pairs(rng)
    got = _floats(td.adapted_rand_from_pairs_device(sid, tid, c, S, T,
                                                    device="cpu"))
    np.testing.assert_allclose(
        got, _floats(jd.adapted_rand_from_pairs_device(sid, tid, c, S, T)),
        rtol=1e-12)
    np.testing.assert_allclose(got, eval_ri(seg, truth), rtol=1e-12)
    l0, l1, cc = contingency_table(seg, truth, exclude_truth=(0,))
    tp, _, fp, fn = pair_stats_from_counts(l0, l1, cc)
    counts = td.pair_counts_from_pairs_device(sid, tid, c, S, T,
                                              device="cpu")
    assert [int(x) for x in counts] == [tp, tp + fp, tp + fn]


# ---------------------------------------------------------------------------
# ops/tree_scan.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_case():
    data = synthetic_em_slice((48, 48), n_cells=8, seed=13)
    seg = watershed_native(data["pb"], 0.1)
    rag = build_rag(seg, contour_only=False)
    order, _ = greedy_merge_order(rag, data["pb"], policy="median")
    return data, rag, order


def test_node_region_stats_match(tree_case):
    data, rag, order = tree_case
    cfg = FeatureConfig.standard(data["pb"], n_bins=8)
    tf = TreeFeatures(rag, order, cfg)
    jtree = tf.tree
    tree = build_tree(order)
    leaf_nodes = np.nonzero(tree.is_leaf)[0]
    st = tf.stats.r_stats[0]
    leaf_stats = {("add", "sum"): st["sum"][leaf_nodes][:, None],
                  ("add", "cnt"): st["cnt"][leaf_nodes][:, None],
                  ("min", "min"): st["min"][leaf_nodes][:, None],
                  ("max", "max"): st["max"][leaf_nodes][:, None]}
    got = tts.node_region_stats_device(tree, leaf_stats, device="cpu")
    want = jts.node_region_stats_device(jtree, leaf_stats)
    M = tree.n_nodes
    for name in ("sum", "cnt"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-12)
        np.testing.assert_allclose(got[name][:, 0], st[name][:M],
                                   rtol=1e-12)
    for name in ("min", "max"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))
        np.testing.assert_array_equal(got[name][:, 0], st[name][:M])


def test_dfs_intervals_cover(tree_case):
    _, _, order = tree_case
    tree = build_tree(order)
    from glia_tpu_torch.graph.tree import dfs_intervals

    for a, b in zip(dfs_intervals(tree), jts.dfs_intervals(
            j_build_tree(order))):
        np.testing.assert_array_equal(a, b)
    _, lo, hi, leaf_order = dfs_intervals(tree)
    assert len(leaf_order) == tree.n_leaves
    assert lo[tree.root] == 0 and hi[tree.root] == tree.n_leaves


def test_interval_reduce_matches(rng):
    vals = rng.random((37, 2))
    lo = np.array([0, 5, 10, 36, 0, 8, 3])
    hi = np.array([37, 6, 20, 37, 1, 8, 35])   # one empty interval
    for kind in ("min", "max"):
        got = tts.interval_reduce(torch.as_tensor(vals), lo, hi, kind)
        want = np.asarray(jts.interval_reduce(jnp.asarray(vals), lo, hi,
                                              kind))
        np.testing.assert_array_equal(got, want)
        for i in range(len(lo)):
            if hi[i] > lo[i]:
                red = getattr(vals[lo[i]:hi[i]], kind)(axis=0)
                np.testing.assert_array_equal(got[i], red)
        assert bool(torch.isinf(got[5]).all())
    np.testing.assert_allclose(
        tts.interval_sums(torch.as_tensor(vals), lo, hi),
        np.asarray(jts.interval_sums(jnp.asarray(vals), lo, hi)),
        rtol=1e-12, atol=1e-15)


def test_interval_reduce_at_powers_of_two():
    """Intervals whose length is a power of two or one off it take the
    right sparse-table row."""
    L = 1 << 11
    vals = torch.arange(L, dtype=torch.float64)[:, None]
    lengths = np.array([1, 2, 3, 4, 7, 8, 9, 255, 256, 257, 1024, 2047,
                        2048])
    lo = np.zeros(len(lengths), dtype=np.int64)
    out = tts.interval_reduce(vals, lo, lengths, "max")
    np.testing.assert_array_equal(out[:, 0], lengths - 1)
