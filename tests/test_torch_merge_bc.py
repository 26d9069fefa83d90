"""The serial classifier-in-the-loop merge (merge_order_bc on the host)
against glia_tpu's.

The port's native.greedy_merge_bc_native (its copy of glia_bc.cc) and its
graph.merge_bc.greedy_merge_bc (the Python engine the C++ one reproduces)
must give glia_tpu's order rows and probabilities bit for bit on the 192^2
case of glia_tpu's own test (tests/test_merge_bc.py, a 30-tree forest
trained by glia_tpu on a 128^2 slice, carried across through its arrays).
The Python engine also runs with the port's batched scorer, and the
candidate features of DynamicRagState match glia_tpu's during a replay.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

import glia_tpu.graph.merge_bc as jmb
import glia_tpu.native as jn
import glia_tpu_torch.graph.merge_bc as tmb
import glia_tpu_torch.native as tn
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.features.labels import bc_labels
from glia_tpu.graph.rag import build_rag
from glia_tpu.models.forest import predict_label_fraction, train_forest
from glia_tpu_torch.features.config import FeatureConfig as TFeatureConfig
from glia_tpu_torch.graph.rag import build_rag as t_build_rag
from glia_tpu_torch.models.forest import ForestModel
from glia_tpu_torch.models.forest import \
    predict_label_fraction as t_predict_label_fraction


@pytest.fixture(scope="module")
def case():
    tr = synthetic_em_slice((128, 128), n_cells=25, seed=1)
    seg_t = jn.watershed_native(ndi.gaussian_filter(tr["pb"], 1.0),
                                level=0.004)
    rag_t = build_rag(seg_t, contour_only=False)
    cfg_t = FeatureConfig.standard(tr["pb"], tr["intensity"], n_bins=16)
    order_t, _ = jn.greedy_merge_native(rag_t, tr["pb"], policy="median")
    X = TreeFeatures(rag_t, order_t, cfg_t, saliencies=None).bc_features()
    y = bc_labels(seg_t, tr["truth"], order_t, rule="f1")[0]
    jmodel = train_forest(X, y, n_trees=30, seed=0)
    model = ForestModel.from_arrays(
        jmodel.feature, jmodel.threshold, jmodel.left, jmodel.right,
        jmodel.leaf_class, jmodel.n_classes, jmodel.max_depth,
        jmodel.classes)

    te = synthetic_em_slice((192, 192), n_cells=50, seed=5)
    seg0 = jn.watershed_native(ndi.gaussian_filter(te["pb"], 1.0),
                               level=0.004)
    rag = build_rag(seg0, contour_only=False)
    cfg = FeatureConfig.standard(te["pb"], te["intensity"], n_bins=16)
    want = jn.greedy_merge_bc_native(rag, cfg, jmodel)
    return te, seg0, jmodel, model, rag, cfg, want


def port_inputs(te, seg0):
    return (t_build_rag(seg0, contour_only=False),
            TFeatureConfig.standard(te["pb"], te["intensity"], n_bins=16))


def test_native_bc_engine_matches_glia_tpu(case):
    te, seg0, _, model, _, _, (want_order, want_probs) = case
    rag, cfg = port_inputs(te, seg0)
    order, probs = tn.greedy_merge_bc_native(rag, cfg, model)
    assert len(want_order) > 100
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(probs, want_probs)
    # max_merges stops the same engine early
    order5, probs5 = tn.greedy_merge_bc_native(rag, cfg, model, max_merges=5)
    np.testing.assert_array_equal(order5, want_order[:5])
    np.testing.assert_array_equal(probs5, want_probs[:5])


@pytest.mark.parametrize("scorer", ["glia_tpu_np", "port_np"])
def test_python_bc_engine_matches_glia_tpu(case, scorer):
    """The port's Python engine with a batched scorer: glia_tpu's host walk
    on glia_tpu's forest, or the port's on the carried forest."""
    te, seg0, jmodel, model, _, _, (want_order, want_probs) = case
    rag, cfg = port_inputs(te, seg0)
    if scorer == "glia_tpu_np":
        def batch(F):
            return predict_label_fraction(jmodel, F, label=-1)
    else:
        def batch(F):
            return t_predict_label_fraction(model, F, label=-1)
    order, probs = tmb.greedy_merge_bc(
        rag, cfg, lambda f: float(batch(f[None, :])[0]),
        predict_batch=batch)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(probs, want_probs)


def test_dynamic_state_candidate_features_match_glia_tpu():
    """Replaying a merge order through both DynamicRagStates gives the same
    candidate feature vectors at every step."""
    data = synthetic_em_slice(shape=(48, 48), n_cells=10, seed=11)
    seg = jn.watershed_native(data["pb"], level=0.12)
    jrag = build_rag(seg, contour_only=False)
    jcfg = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=8)
    rag = t_build_rag(seg, contour_only=False)
    cfg = TFeatureConfig.standard(data["pb"], data["intensity"], n_bins=8)
    order, _ = jn.greedy_merge_native(jrag, data["pb"], policy="mean")
    want, got = jmb.DynamicRagState(jrag, jcfg), tmb.DynamicRagState(rag, cfg)
    assert len(order) > 5
    for r0, r1, r2 in order:
        np.testing.assert_array_equal(
            got.candidate_features(int(r0), int(r1)),
            want.candidate_features(int(r0), int(r1)))
        want.merge(int(r0), int(r1), int(r2))
        got.merge(int(r0), int(r1), int(r2))


def test_native_bc_engine_checks(case):
    te, seg0, _, model, _, _, _ = case
    rag, cfg = port_inputs(te, seg0)
    # a forest that splits on a saliency column (148-wide features)
    wide = ForestModel.from_arrays(
        np.where(model.feature >= 0, 147, model.feature), model.threshold,
        model.left, model.right, model.leaf_class, model.n_classes,
        model.max_depth, model.classes)
    with pytest.raises(ValueError, match="BC features have 143"):
        tn.greedy_merge_bc_native(rag, cfg, wide)
    with pytest.raises(ValueError, match="contour_only=False"):
        tn.greedy_merge_bc_native(t_build_rag(seg0), cfg, model)
    bins = TFeatureConfig.standard(te["pb"], te["intensity"], n_bins=8)
    bins.b_images[0] = type(bins.b_images[0])(
        bins.b_images[0].image, 16, bins.b_images[0].hist_range)
    with pytest.raises(ValueError, match="r_images == b_images"):
        tn.greedy_merge_bc_native(rag, bins, model)
