"""Port hmt_segment(engine="device_bc") vs glia_tpu's, end to end.

A 96x96 synthetic slice (seed 4, 20 cells) and a forest trained by
glia_tpu (watershed -> pre-merge -> host merge order -> BC features and
labels -> train_forest, the steps of glia_tpu.pipeline.hmt_train) on
the BC feature vector the device_bc engine scores: without the saliency
columns, which hmt_train's forests split on and the engine does not
compute.  The forest reaches the port through ForestModel.from_arrays.
Required: identical merge order and final segmentation, probabilities
equal, evaluate() dicts equal to 1e-12.  Also: the device policy (no
silent CPU run) and the kernel wrapper's refusal of CPU tensors.
"""

import numpy as np
import pytest
import torch

import glia_tpu.pipeline as jp
import glia_tpu_torch.pipeline as tp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.features.labels import bc_labels
from glia_tpu.graph.rag import build_rag
from glia_tpu.models.forest import train_forest
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.models.forest import ForestModel, ForestTables
from glia_tpu_torch.ops.cuda import forest_votes_cuda, launches


@pytest.fixture(scope="module")
def case():
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, _ = greedy_merge_native(rag, s["pb"], policy="median")
    cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    X = TreeFeatures(rag, order, cfg).bc_features()
    y, _, _ = bc_labels(seg, s["truth"], order, rule="f1")
    f = train_forest(X, y, n_trees=20, seed=0)
    port_forest = ForestModel.from_arrays(
        f.feature, f.threshold, f.left, f.right, f.leaf_class, f.n_classes,
        f.max_depth, f.classes)
    return s, jp.HmtModel(forest=f), tp.HmtModel(forest=port_forest)


def test_hmt_segment_device_bc_matches_jax(case):
    s, jmodel, model = case
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel,
                                    engine="device_bc")
    stats = {}
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  device="cpu", stats=stats)
    np.testing.assert_array_equal(got["seg0"], want["seg0"])
    assert len(got["order"]) > 20
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    assert got["n_picks"] == want["n_picks"]
    np.testing.assert_array_equal(got_seg, want_seg)
    ev_want = jp.evaluate(want_seg, s["truth"])
    ev_got = tp.evaluate(got_seg, s["truth"])
    assert ev_got.keys() == ev_want.keys()
    for k in ev_want:
        assert ev_got[k] == pytest.approx(ev_want[k], rel=1e-12, abs=1e-12)
    assert stats["n_supersteps"] > 1
    assert {"t_watershed", "t_pre_merge", "t_rag", "t_build_state",
            "t_merge_loop", "t_tree_resolve", "t_segmentation"} <= set(stats)


def test_no_device_without_cuda_raises(case, monkeypatch):
    s, _, model = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def must_not_run(*a, **k):
        raise AssertionError("ran on the CPU without being asked")

    monkeypatch.setattr(tp, "watershed", must_not_run)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.hmt_segment(s["pb"], s["intensity"], model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.hmt_segment(s["pb"], s["intensity"], model, device="cuda")


@pytest.mark.parametrize("kw", [{"engine": "host"}, {"engine": "device"},
                                {"mode": "ccm"}])
def test_unported_engines_raise(case, kw):
    s, _, model = case
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tp.hmt_segment(s["pb"], s["intensity"], model, device="cpu", **kw)


def test_kernel_wrapper_refuses_cpu_tensors(case):
    _, _, model = case
    tables = ForestTables.from_model(model.forest, "cpu")
    before = dict(launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        forest_votes_cuda(torch.zeros((4, 143), dtype=torch.float32),
                          tables)
    assert launches == before
