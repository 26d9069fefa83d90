"""The forest ensemble (kind "rf_ensemble") against glia_tpu's.

glia_tpu's hmt_train(classifier="rf_ensemble") trains three forests on the
BC samples split by the two region-area columns (models/train_ensemble.py,
tools.distribute_samples) and routes each merge to one of them
(models/ensemble.py ThresholdEnsemble).  Held here, on 96^2 slices:

- the port's distribute_samples / distribute and the median threshold
  give glia_tpu's groups;
- glia_tpu's trained ensemble, carried across with
  hmt_model_from_arrays(kind="rf_ensemble"), gives glia_tpu's merge
  probabilities and glia_tpu's hmt_segment results on engine="host" and
  engine="device" (glia_tpu's device steps composed with
  greedy_merge_device(mode="fused"), the engine the port has);
- backend="device" scores each member's rows through the device walk;
- the port's hmt_train(classifier="rf_ensemble") trains glia_tpu's three
  forests node for node, with the degenerate-group fallback;
- device_bc refuses an ensemble, as glia_tpu does.
"""

import numpy as np
import pytest

import glia_tpu.pipeline as jp
import glia_tpu.tools as jtools
import glia_tpu_torch.models.forest as tf
import glia_tpu_torch.pipeline as tp
import glia_tpu_torch.tools as ttools
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.graph.merge_device import greedy_merge_device
from glia_tpu.graph.rag import build_rag
from glia_tpu.graph.tree import build_tree, node_potentials
from glia_tpu.infer.greedy import resolve_tree_greedy
from glia_tpu.infer.segment import final_segmentation
from glia_tpu.models.ensemble import distribute as j_distribute
from glia_tpu.models.train_ensemble import (bc_area_feature_indices,
                                            train_forest_ensemble)
from glia_tpu_torch.features.config import FeatureConfig as TFeatureConfig
from glia_tpu_torch.models.ensemble import distribute as t_distribute
from glia_tpu_torch.models.train_ensemble import (
    bc_area_feature_indices as t_bc_area_feature_indices,
    train_forest_ensemble as t_train_forest_ensemble)

FOREST_ARRAYS = ("feature", "threshold", "left", "right", "leaf_class",
                 "n_classes", "max_depth", "classes")


def train_slices():
    return [synthetic_em_slice(shape=(96, 96), n_cells=20, seed=seed)
            for seed in (1, 2, 3)]


@pytest.fixture(scope="module")
def trained():
    """glia_tpu's ensemble on three slices, its training samples, and the
    ensemble carried into the port."""
    slices = train_slices()
    jm = jp.hmt_train(slices, classifier="rf_ensemble", n_trees=15)
    X, y = tp.training_samples(slices)
    ens = jm.extra["ensemble"]
    model = tp.hmt_model_from_arrays(
        kind="rf_ensemble",
        forests=[{k: getattr(f, k) for k in FOREST_ARRAYS}
                 for f in ens.forests],
        dim0=ens.dim0, dim1=ens.dim1, ensemble_threshold=ens.threshold,
        n_bins=jm.n_bins, policy=jm.policy)
    return slices, jm, model, X, y


def test_area_columns_and_groups_match(trained):
    slices, jm, _, X, y = trained
    s = slices[0]
    dims = bc_area_feature_indices(
        FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16))
    t_dims = t_bc_area_feature_indices(
        TFeatureConfig.standard(s["pb"], s["intensity"], n_bins=16))
    assert t_dims == dims
    ens = jm.extra["ensemble"]
    assert ens.threshold == float(np.median(X[:, dims[1]]))
    want = jtools.distribute_samples(X, y, *dims, ens.threshold)
    got = ttools.distribute_samples(X, y, *dims, ens.threshold)
    assert [len(g[0]) for g in got] == [len(g[0]) for g in want]
    assert min(len(g[0]) for g in got) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(t_distribute(X, *dims, ens.threshold),
                                  j_distribute(X, *dims, ens.threshold))


def test_carried_ensemble_gives_equal_probabilities(trained):
    _, jm, model, X, _ = trained
    want = jm.predict_merge_prob(X)
    got = model.predict_merge_prob(X, device="cpu")
    assert model.kind == "rf_ensemble"
    np.testing.assert_array_equal(got, want)


def test_ensemble_device_backend_scores_each_member(trained):
    _, _, model, X, _ = trained
    ens = model.extra["ensemble"]
    idx = t_distribute(X, ens.dim0, ens.dim1, ens.threshold)
    got = model.predict_merge_prob(X, backend="device", device="cpu")
    for k, forest in enumerate(ens.forests):
        sel = idx == k
        np.testing.assert_array_equal(
            got[sel], tf.predict_label_fraction(forest, X[sel], label=-1,
                                                backend="device",
                                                device="cpu"))
    # float32 count * fl32(1/T) against float64 votes / T
    np.testing.assert_allclose(got, model.predict_merge_prob(X), atol=1e-6)


def _glia_tpu_device_steps(s, jmodel):
    """glia_tpu's hmt_segment(engine="device") with its merge in
    mode="fused"."""
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_device(rag, s["pb"], policy=jmodel.policy,
                                      mode="fused")
    feats = jp._features_for(seg, s["pb"], s["intensity"], jmodel, order,
                             sals)
    probs = jmodel.predict_merge_prob(feats)
    tree = build_tree(order)
    picks = resolve_tree_greedy(tree, node_potentials(tree, probs))
    return final_segmentation(seg, tree, picks), {"order": order,
                                                  "probs": probs}


@pytest.mark.parametrize("engine,mode", [("host", "greedy"),
                                         ("host", "ccm"),
                                         ("device", "greedy")])
def test_carried_ensemble_segments_like_glia_tpu(trained, engine, mode):
    _, jm, model, _, _ = trained
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=5)
    if engine == "host":
        want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jm,
                                        engine="host", mode=mode)
    else:
        want_seg, want = _glia_tpu_device_steps(s, jm)
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine=engine, mode=mode, device="cpu")
    assert len(got["order"]) > 20
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got_seg, want_seg)


def test_hmt_train_rf_ensemble_matches_glia_tpu(trained):
    slices, jm, _, _, _ = trained
    stats = {}
    got = tp.hmt_train(slices, classifier="rf_ensemble", n_trees=15,
                       device="cpu", stats=stats)
    assert got.kind == "rf_ensemble" and got.forest is None
    ens, want = got.extra["ensemble"], jm.extra["ensemble"]
    assert (ens.dim0, ens.dim1, ens.threshold) == (want.dim0, want.dim1,
                                                   want.threshold)
    assert len(ens.forests) == 3
    for f, w in zip(ens.forests, want.forests):
        for k in FOREST_ARRAYS[:5]:
            np.testing.assert_array_equal(getattr(f, k), getattr(w, k))
        assert f.max_depth == w.max_depth
    assert stats["t_forest"] > 0


def test_degenerate_group_falls_back_to_all_rows():
    rng = np.random.default_rng(1)
    X = rng.random((300, 4))
    y = np.where(X[:, 2] + 0.3 * X[:, 3] > 0.6, 1, -1)
    # nothing below the threshold on column 1: group 0 is empty
    X[:, 1] += 1.0
    got = t_train_forest_ensemble(X, y, dim0=0, dim1=1, threshold=0.5,
                                  n_trees=11)
    want = train_forest_ensemble(X, y, dim0=0, dim1=1, threshold=0.5,
                                 n_trees=11)
    for f, w in zip(got.forests, want.forests):
        np.testing.assert_array_equal(f.feature, w.feature)
        np.testing.assert_array_equal(f.threshold, w.threshold)
    np.testing.assert_array_equal(got(X), want(X))


def test_ensemble_refused_where_glia_tpu_refuses_it(trained):
    _, _, model, _, _ = trained
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=5)
    with pytest.raises(ValueError, match="kind='rf'"):
        tp.hmt_segment(s["pb"], s["intensity"], model, engine="device_bc",
                       device="cpu")
    ens = model.extra["ensemble"]
    arrays = [{k: getattr(f, k) for k in FOREST_ARRAYS}
              for f in ens.forests]
    with pytest.raises(ValueError, match="3 forests"):
        tp.hmt_model_from_arrays(kind="rf_ensemble", forests=arrays[:2],
                                 dim0=1, dim1=2, ensemble_threshold=0.5)
    with pytest.raises(ValueError, match="missing"):
        tp.hmt_model_from_arrays(kind="rf_ensemble", forests=arrays)
