"""The port's hardware suite: its kernels and device engines on the CUDA
card (counterpart of tests_tpu/test_real_tpu.py, test for test, with its
sizes, seeds and tolerances).

Run on a machine with a card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py

``--noconftest`` keeps tests/conftest.py out: it imports JAX, which the
card's machine does not have.  This file imports only torch, numpy,
scipy, pytest and glia_tpu_torch; the port's own host oracles take the
place of glia_tpu's.  Without a card every test skips (the ``card``
fixture decides, at run time).
"""

import numpy as np
import pytest
import torch

# bench.py's section at the suite's sizes and seeds
from glia_tpu_torch.bench import bench_section as _section


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "-p no:cacheprovider tests/test_torch_on_card.py")


pytestmark = pytest.mark.usefixtures("card")


def _small_forest(n_trees=24, dim=16, seed=0):
    from glia_tpu_torch.models.forest import train_forest

    rng = np.random.default_rng(seed)
    X = rng.random((600, dim)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.8).astype(np.int32)
    return train_forest(X, y, n_trees=n_trees, seed=seed)


def test_cuda_forest_votes_compiled_parity():
    """Vote fractions from the CUDA kernel B1 match the numpy oracle
    (Model::predict semantics, rf.hxx:362-372)."""
    from glia_tpu_torch.models.forest import (ForestTables, forest_votes,
                                              predict_votes_np)
    from glia_tpu_torch.ops import cuda as kcuda

    model = _small_forest()
    rng = np.random.default_rng(1)
    X = rng.random((512, 16)).astype(np.float32)
    want = predict_votes_np(model, X)
    tables = ForestTables.from_model(model, torch.device("cuda"))
    before = kcuda.launches["forest_votes"]
    got = forest_votes(torch.as_tensor(X, device="cuda"), tables)
    assert kcuda.launches["forest_votes"] == before + 1
    got = got.cpu().numpy()
    np.testing.assert_allclose(got[:, : want.shape[1]], want, atol=1e-5)


def test_label_scorer_auto_picks_cuda_on_card():
    from glia_tpu_torch.models.forest import (make_label_scorer,
                                              predict_label_fraction)
    from glia_tpu_torch.ops import cuda as kcuda

    model = _small_forest()
    rng = np.random.default_rng(2)
    X = rng.random((256, 16)).astype(np.float32)
    fn = make_label_scorer(model, label=1)
    kcuda.reset_launches()
    got = fn(torch.as_tensor(X, device="cuda")).cpu().numpy()
    assert kcuda.launches["forest_votes"] == 1
    want = predict_label_fraction(model, X, label=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_merge_on_card_threshold_cut_parity():
    """The fused batched merge engine on the card retains threshold-cut
    VI parity with the host serial loop."""
    from glia_tpu_torch.graph.merge import apply_merge_order
    from glia_tpu_torch.graph.merge_device import (edge_mean_arrays,
                                                   merge_batched_device,
                                                   order_to_keys,
                                                   threshold_cut)
    from glia_tpu_torch.metrics import eval_vi
    from glia_tpu_torch.native import greedy_merge_native

    n_cells = 60
    data, seg, rag = _section(128, n_cells, 5)
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="mean")
    u, v, s, c = edge_mean_arrays(rag, data["pb"])
    order_b, sal_b, n_m = merge_batched_device(u, v, s, c, rag.n_regions)
    assert order_b.is_cuda
    assert n_m == len(order_h)
    k = rag.n_regions - n_cells
    tau = -sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    mask = threshold_cut(okeys, -sal_b[:n_m].double().cpu().numpy(), tau)
    seg_b = apply_merge_order(seg, okeys[mask])
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    _, _, vi_b = eval_vi(seg_b, data["truth"])
    _, _, vi_h = eval_vi(seg_h, data["truth"])
    assert abs(vi_b - vi_h) < 0.15, (vi_b, vi_h)


def test_exact_replay_cut_parity_on_card():
    """Threshold cut on exact replayed saliencies of the card's order
    tracks the serial VI tightly."""
    from glia_tpu_torch.graph.merge import apply_merge_order
    from glia_tpu_torch.graph.merge_device import (edge_mean_arrays,
                                                   merge_batched_device,
                                                   order_to_keys,
                                                   replay_exact_saliency,
                                                   threshold_cut)
    from glia_tpu_torch.metrics import eval_vi
    from glia_tpu_torch.native import greedy_merge_native

    n_cells = 60
    data, seg, rag = _section(128, n_cells, 5)
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="mean")
    u, v, s, c = edge_mean_arrays(rag, data["pb"])
    order_b, sal_b, n_m = merge_batched_device(u, v, s, c, rag.n_regions)
    k = rag.n_regions - n_cells
    tau = -sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    ex = replay_exact_saliency(u, v, s, c, order_b[:n_m].cpu().numpy())
    assert not np.isnan(ex).any()
    mask = threshold_cut(okeys, ex, tau)
    seg_b = apply_merge_order(seg, okeys[mask])
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    _, _, vi_b = eval_vi(seg_b, data["truth"])
    _, _, vi_h = eval_vi(seg_h, data["truth"])
    assert abs(vi_b - vi_h) < 0.05, (vi_b, vi_h)


def test_hist_median_fused_on_card():
    """Approx-median (histogram sketch) fused merge on the card: complete
    hierarchy and threshold-cut VI comparable to the host exact-median
    serial engine (struct_merge.hxx:90-136 semantics)."""
    from glia_tpu_torch.graph.merge import apply_merge_order
    from glia_tpu_torch.graph.merge_device import (edge_hist_arrays,
                                                   merge_batched_device_hist,
                                                   order_to_keys,
                                                   threshold_cut)
    from glia_tpu_torch.metrics import eval_vi
    from glia_tpu_torch.native import greedy_merge_native

    n_cells = 60
    data, seg, rag = _section(128, n_cells, 7)
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="median")
    u, v, h = edge_hist_arrays(rag, data["pb"], n_bins=32)
    order_b, sal_b, n_m = merge_batched_device_hist(u, v, h, rag.n_regions)
    assert order_b.is_cuda
    assert n_m == len(order_h)
    k = rag.n_regions - n_cells
    tau = -sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    mask = threshold_cut(okeys, -sal_b[:n_m].double().cpu().numpy(),
                         tau + 1e-9)
    seg_b = apply_merge_order(seg, okeys[mask])
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    _, _, vi_b = eval_vi(seg_b, data["truth"])
    _, _, vi_h = eval_vi(seg_h, data["truth"])
    assert abs(vi_b - vi_h) < 0.3, (vi_b, vi_h)


def test_tree_scan_on_card():
    """Per-level merge-tree activations (DFS-interval prefix sums) on the
    card match the host hierarchical oracle: cnt/min/max exactly, sums
    to float32 prefix-sum tolerance."""
    from glia_tpu_torch.data.synthetic import synthetic_em_slice
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.features.hierarchical import TreeFeatures
    from glia_tpu_torch.graph.merge import greedy_merge_order
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.native import watershed_native
    from glia_tpu_torch.ops.tree_scan import node_region_stats_device

    data = synthetic_em_slice((96, 96), n_cells=16, seed=13)
    seg = watershed_native(data["pb"], 0.1)
    rag = build_rag(seg, contour_only=False)
    order, _ = greedy_merge_order(rag, data["pb"], policy="median")
    cfg = FeatureConfig.standard(data["pb"], n_bins=8)
    tf = TreeFeatures(rag, order, cfg)
    tree = tf.tree
    leaf_nodes = np.nonzero(tree.is_leaf)[0]
    st = tf.stats.r_stats[0]
    leaf_stats = {
        ("add", "sum"): st["sum"][leaf_nodes][:, None],
        ("add", "cnt"): st["cnt"][leaf_nodes][:, None],
        ("min", "min"): st["min"][leaf_nodes][:, None],
        ("max", "max"): st["max"][leaf_nodes][:, None],
    }
    out = node_region_stats_device(tree, leaf_stats)
    assert out["sum"].is_cuda
    # isolated regions follow the tree's nodes in TreeFeatures' rows
    n = tree.n_nodes
    np.testing.assert_allclose(out["sum"].cpu().numpy()[:, 0],
                               st["sum"][:n], rtol=5e-4)
    np.testing.assert_allclose(out["cnt"].cpu().numpy()[:, 0],
                               st["cnt"][:n], rtol=1e-6)
    np.testing.assert_allclose(out["min"].cpu().numpy()[:, 0],
                               st["min"][:n], rtol=1e-6)
    np.testing.assert_allclose(out["max"].cpu().numpy()[:, 0],
                               st["max"][:n], rtol=1e-6)


def test_device_metrics_on_card():
    """VI and adapted Rand on the card match the host printers
    (gadget/main_eval_vi.cxx, main_eval_ri.cxx semantics)."""
    from glia_tpu_torch.metrics import centropy, eval_ri
    from glia_tpu_torch.metrics.device import (adapted_rand_device,
                                               densify_labels, vi_device)

    rng = np.random.default_rng(3)
    seg = rng.integers(1, 9, (64, 64)).astype(np.int32)
    truth = rng.integers(0, 7, (64, 64)).astype(np.int32)
    sid, S = densify_labels(seg)
    tid, T = densify_labels(truth, exclude=(0,))
    fs, fm, tot = (float(x) for x in vi_device(sid, tid, S, T))
    want_fs = centropy(truth, seg, excluded0=(0,), itk_quirk=False)
    want_fm = centropy(seg, truth, excluded1=(0,), itk_quirk=False)
    assert abs(fs - want_fs) < 1e-4 and abs(fm - want_fm) < 1e-4
    prec, rec, err = (float(x) for x in
                      adapted_rand_device(sid, tid, S, T))
    wp, wr, we = eval_ri(seg, truth)
    assert abs(prec - wp) < 1e-4 and abs(rec - wr) < 1e-4
    assert abs(err - we) < 1e-4


def test_bc_device_engine_compiled_on_card():
    """The classifier-in-the-loop device engine (merge_order_bc_device:
    feature assembly, kernel B1 and the superstep merge on the card,
    struct_merge_bc.hxx:10-58): complete hierarchy, mid-cut VI tracking
    the host serial BC order."""
    from glia_tpu_torch.examples.bench_bc_midcut import bc_midcut_compare
    from glia_tpu_torch.ops import cuda as kcuda

    kcuda.reset_launches()
    rows = bc_midcut_compare(side=96, n_cells=40, n_trees=24,
                             taus=(0.8, 0.5))
    assert kcuda.launches["forest_votes"] > 0
    dvis = [abs(r["dvi"]) for r in rows]
    assert max(dvis) <= 0.12, rows


def test_median_sketch_from_counts_on_card():
    """Counting-histogram median (the device feature assembler's core) on
    the card: within one grid step of the host's exact median."""
    import warnings

    from glia_tpu_torch.features.device import (_med_tables,
                                                _median_from_counts,
                                                counting_hist)

    rng = np.random.default_rng(9)

    class _I:
        def __init__(self, v):
            self.image = v

    v = rng.standard_normal(8000).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tab = np.asarray(_med_tables([_I(v)], 256)[0])
    h = counting_hist(v, np.zeros(len(v), np.int64), 1, tab, len(tab))[0]
    med = _median_from_counts(torch.as_tensor(h, device="cuda")[None, :],
                              tab)
    assert med.is_cuda
    med = float(med[0])
    true = float(np.partition(v, len(v) // 2)[len(v) // 2])
    step = tab[1] - tab[0]
    assert abs(med - true) <= step + 1e-6


def test_one_dispatch_merge_exact_on_card():
    """Merge and exact merge-time saliencies as one program
    (merge_batched_device_exact): saliencies match the serial host replay
    of the card's order, and the memoized call, a replay of the plan's
    CUDA graph, reproduces the discovery call."""
    from glia_tpu_torch.graph.merge_device import (
        edge_mean_arrays, merge_batched_device_exact, replay_exact_saliency)

    data, seg, rag = _section(160, 70, 9)
    u, v, s, c = edge_mean_arrays(rag, data["pb"])
    st1, st2 = {}, {}
    o1, s1, n1 = merge_batched_device_exact(u, v, s, c, rag.n_regions,
                                            stats=st1)
    o2, s2, n2 = merge_batched_device_exact(u, v, s, c, rag.n_regions,
                                            stats=st2)
    assert n2 == n1 > 0
    assert st2["plan_graph"] is True and st2["fallback"] is False
    np.testing.assert_array_equal(o2[:n2].cpu().numpy(),
                                  o1[:n1].cpu().numpy())
    ex_host = replay_exact_saliency(u, v, s, c, o2[:n2].cpu().numpy())
    ok = np.isfinite(ex_host)
    np.testing.assert_allclose(-s2[:n2].double().cpu().numpy()[ok],
                               ex_host[ok], rtol=1e-4, atol=1e-6)
