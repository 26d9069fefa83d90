"""Port features/hierarchical.TreeFeatures vs glia_tpu's, on a 96x96 slice.

It is the same numpy code, so the comparison is exact
(assert_array_equal): bc_features (with and without saliencies),
simple_features and region_features over a host merge order, for the
standard feature configuration and for one with histogram, median and
log-shape features and a label image.  Also the helpers the copy brought
along (sdivide, slog, pairs_lca, dfs_intervals).
"""

import numpy as np
import pytest

import glia_tpu.pipeline as jp
from glia_tpu.constants import sdivide as j_sdivide, slog as j_slog
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig as JCfg, HistImage as JImg
from glia_tpu.features.hierarchical import TreeFeatures as JTreeFeatures
from glia_tpu.graph.rag import build_rag as j_build_rag
from glia_tpu.graph.tree import build_tree as j_build_tree
from glia_tpu.graph.tree import pairs_lca as j_pairs_lca
from glia_tpu.native import greedy_merge_native
from glia_tpu.ops.tree_scan import dfs_intervals as j_dfs_intervals
from glia_tpu_torch.constants import sdivide, slog
from glia_tpu_torch.features.config import FeatureConfig, HistImage
from glia_tpu_torch.features.hierarchical import TreeFeatures
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.graph.tree import build_tree, dfs_intervals, pairs_lca


@pytest.fixture(scope="module")
def case():
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    order, sals = greedy_merge_native(j_build_rag(seg, contour_only=False),
                                      s["pb"], policy="median")
    return s, seg, order, sals


def _both(case, rich):
    s, seg, order, sals = case
    if rich:
        kw = dict(histogram_as_feats=True, median_as_feats=True,
                  use_log_shape=True, normalizing_area=96.0 * 96.0,
                  normalizing_length=96.0)
        labels = (s["intensity"] > 0.5).astype(np.float64)

        def cfg(C, I):
            return C(pb_image=s["pb"],
                     r_images=[I(s["pb"], 8, (0.0, 1.0))],
                     rl_images=[I(labels, 2, (0.0, 1.0))],
                     b_images=[I(s["pb"], 8, (0.0, 1.0)),
                               I(s["intensity"], 4, (0.1, 1.0))], **kw)

        jc, tc = cfg(JCfg, JImg), cfg(FeatureConfig, HistImage)
    else:
        jc = JCfg.standard(s["pb"], s["intensity"], n_bins=16)
        tc = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    want = JTreeFeatures(j_build_rag(seg, contour_only=False), order, jc,
                         saliencies=sals)
    got = TreeFeatures(build_rag(seg, contour_only=False), order, tc,
                       saliencies=sals)
    return got, want


@pytest.mark.parametrize("rich", [False, True], ids=["standard", "rich"])
@pytest.mark.parametrize("method", ["bc_features", "simple_features",
                                    "region_features",
                                    "boundary_features"])
def test_tree_features_equal(case, rich, method):
    got, want = _both(case, rich)
    a, b = getattr(got, method)(), getattr(want, method)()
    assert a.shape == b.shape and a.shape[0] > 20
    np.testing.assert_array_equal(a, b)


def test_bc_features_width_with_and_without_saliencies(case):
    s, seg, order, sals = case
    rag = build_rag(seg, contour_only=False)
    cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    with_sal = TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()
    without = TreeFeatures(rag, order, cfg).bc_features()
    assert with_sal.shape == (len(order), 148)
    assert without.shape == (len(order), 143)
    want = JTreeFeatures(j_build_rag(seg, contour_only=False), order,
                         JCfg.standard(s["pb"], s["intensity"], n_bins=16)
                         ).bc_features()
    np.testing.assert_array_equal(without, want)


def test_contour_only_rag_is_refused(case):
    s, seg, order, _ = case
    cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    with pytest.raises(ValueError, match="contour_only=False"):
        TreeFeatures(build_rag(seg, contour_only=True), order, cfg)


def test_safe_division_and_log_copies():
    x = np.array([0.0, 1e-17, 2.0, -3.0])
    np.testing.assert_array_equal(sdivide(1.0, x, -1.0),
                                  j_sdivide(1.0, x, -1.0))
    np.testing.assert_array_equal(slog(x, -1.0), j_slog(x, -1.0))
    assert sdivide(1.0, 0.0, 7.0) == j_sdivide(1.0, 0.0, 7.0) == 7.0
    assert slog(0.0, 7.0) == j_slog(0.0, 7.0) == 7.0
    assert slog(np.e) == pytest.approx(1.0)


def test_tree_helper_copies(case):
    _, _, order, _ = case
    tree, jtree = build_tree(order), j_build_tree(order)
    for a, b in zip(dfs_intervals(tree), j_dfs_intervals(jtree)):
        np.testing.assert_array_equal(a, b)
    leaves = np.nonzero(tree.is_leaf)[0]
    rng = np.random.default_rng(2)
    a = rng.choice(leaves, 200)
    b = rng.choice(leaves, 200)
    a[:3] = -1
    np.testing.assert_array_equal(pairs_lca(tree, a, b),
                                  j_pairs_lca(jtree, a, b))
