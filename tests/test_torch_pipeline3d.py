"""The port's stack pipelines (glia_tpu_torch.pipeline3d) and the 3D paths
under them against glia_tpu's, on the CPU (glia_tpu in x64, the port in
float64).

Volumes are glia_tpu's own test stacks, made by both packages'
``synthetic_em_stack`` (which must agree bit for bit): (4, 64, 64) seed 17
and (4, 64, 64) seed 31 for training (tests/test_pipeline3d.py), (6, 40,
40) seed 9 (tests/test_3d.py), (12, 64, 64) seed 7
(tests/test_merge_device.py, the multi-phase engine's 3D adaptive plan),
and (4, 48, 48) seed 5 (tests/test_link3d.py).

Required: merge rows, probabilities, picks and segmentations equal on
every ``hmt_segment`` engine on a volume (``host``, ``device`` and
``device_bc``); forests trained on a volume equal node for node; 3D
``TreeFeatures`` within rtol 1e-12; the multi-phase engine's adaptive plan
engaging on the 3D RAG with no fallback; LINK3D forests and volumes
equal.  A forest trained on sections is refused on a volume, whose feature
vector is three columns wider (glia_tpu walks it on shifted columns).
"""

import numpy as np
import pytest
import torch

import glia_tpu.pipeline as jp
import glia_tpu.pipeline3d as jp3
import glia_tpu_torch.graph.merge_device as tm
import glia_tpu_torch.pipeline as tp
import glia_tpu_torch.pipeline3d as tp3
from glia_tpu.data.synthetic import synthetic_em_slice, synthetic_em_stack
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.features.labels import bc_labels
from glia_tpu.graph.merge_device import edge_mean_arrays, greedy_merge_device
from glia_tpu.graph.merge_device import merge_batched_device as j_batched
from glia_tpu.graph.rag import build_rag
from glia_tpu.models.forest import train_forest
from glia_tpu.native import greedy_merge_native, watershed_native
from glia_tpu_torch.data.synthetic import synthetic_em_stack as t_stack
from glia_tpu_torch.features.config import FeatureConfig as TFeatureConfig
from glia_tpu_torch.features.hierarchical import TreeFeatures as TTreeFeatures
from glia_tpu_torch.graph.rag import build_rag as t_build_rag
from glia_tpu_torch.models.forest import ForestModel
from glia_tpu_torch.models.forest import train_forest as t_train_forest

FEAT_RTOL = 1e-12
FOREST_ARRAYS = ("feature", "threshold", "left", "right", "leaf_class")
# (shape, n_cells, seed) of glia_tpu's test stacks
STACKS = {"pipeline3d": ((4, 64, 64), 10, 17),
          "pipeline3d_train": ((4, 64, 64), 10, 31),
          "link3d": ((4, 48, 48), 8, 5),
          "3d": ((6, 40, 40), 10, 9),
          "adaptive_plan": ((12, 64, 64), 30, 7)}
SEG_KW = dict(watershed_level=0.04, pre_merge_size=15)


def volume(stack):
    return (stack["pb3d"],
            np.stack([s["intensity"] for s in stack["slices"]]))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_synthetic_em_stack_matches(name):
    shape, n_cells, seed = STACKS[name]
    want = synthetic_em_stack(shape=shape, n_cells=n_cells, seed=seed)
    got = t_stack(shape=shape, n_cells=n_cells, seed=seed)
    for k in ("truth3d", "pb3d"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["slices"]) == shape[0]
    for g, w in zip(got["slices"], want["slices"]):
        for k in ("truth", "pb", "intensity"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def stack():
    return synthetic_em_stack(shape=(4, 64, 64), n_cells=10, seed=17)


@pytest.fixture(scope="module")
def train_volume():
    tr = synthetic_em_stack(shape=(4, 64, 64), n_cells=10, seed=31)
    pb, intensity = volume(tr)
    return {"pb": pb, "intensity": intensity, "truth": tr["truth3d"]}


@pytest.fixture(scope="module")
def models(train_volume):
    """glia_tpu's and the port's hmt_train on the training volume, and
    forests on its BC vector without the saliency columns (the vector of
    engine="device_bc"), trained by glia_tpu."""
    jm = jp.hmt_train([train_volume], n_trees=20, **SEG_KW)
    model = tp.hmt_train([train_volume], n_trees=20, **SEG_KW)
    pb, intensity = train_volume["pb"], train_volume["intensity"]
    seg = jp.pre_merge(jp.watershed(pb, 0.04), pb, (15,))
    rag = build_rag(seg, contour_only=False)
    order, _ = greedy_merge_native(rag, pb, policy="median")
    X = TreeFeatures(rag, order,
                     FeatureConfig.standard(pb, intensity, n_bins=16)
                     ).bc_features()
    y, _, _ = bc_labels(seg, train_volume["truth"], order, rule="f1")
    f = train_forest(X, y, n_trees=20, seed=0)
    bc = ForestModel.from_arrays(
        *(getattr(f, k) for k in FOREST_ARRAYS), f.n_classes, f.max_depth,
        f.classes, n_features=X.shape[1])
    return {"glia_tpu": jm, "port": model,
            "glia_tpu_bc": jp.HmtModel(forest=f),
            "port_bc": tp.HmtModel(forest=bc)}


def test_hmt_train_on_a_volume_matches(models):
    """A volume's BC vector is 151 columns (a section's 148: each region
    block one wider, for the third centroid coordinate), 146 without the
    saliency columns; the forests equal node for node."""
    jf, f = models["glia_tpu"].forest, models["port"].forest
    for k in FOREST_ARRAYS:
        np.testing.assert_array_equal(getattr(f, k), getattr(jf, k))
    assert f.n_features == 151
    assert models["port_bc"].forest.n_features == 146


def test_tree_features_on_a_volume_match():
    shape, n_cells, seed = STACKS["3d"]
    st = synthetic_em_stack(shape=shape, n_cells=n_cells, seed=seed)
    pb = np.stack([s["pb"] for s in st["slices"]])
    seg = watershed_native(pb, level=0.1)
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_native(rag, pb, policy="median")
    want = TreeFeatures(rag, order, FeatureConfig.standard(pb, n_bins=8),
                        saliencies=sals)
    got = TTreeFeatures(t_build_rag(seg, contour_only=False), order,
                        TFeatureConfig.standard(pb, n_bins=8),
                        saliencies=sals)
    for fn in ("region_features", "bc_features", "simple_features"):
        g, w = getattr(got, fn)(), getattr(want, fn)()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FEAT_RTOL, atol=0)


# hmt3d_segment's default walk is the device walk ("device" runs it)
ENGINES = {"host": dict(engine="host", backend="np"),
           "host_device_walk": dict(engine="host", backend="device"),
           "device": dict(engine="device"),
           "device_bc": dict(engine="device_bc")}


def _glia_tpu_segment(pb, intensity, model, engine="host",
                      backend="device"):
    if engine == "host" and backend == "np":
        return jp3.hmt3d_segment(pb, intensity, model, **SEG_KW)
    return jp.hmt_segment(pb, intensity, model, engine=engine,
                          backend=backend, **SEG_KW)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_hmt3d_segment_matches(name, stack, models):
    kw = ENGINES[name]
    bc = "_bc" if kw["engine"] == "device_bc" else ""
    pb, intensity = volume(stack)
    want_seg, want = _glia_tpu_segment(pb, intensity,
                                       models["glia_tpu" + bc], **kw)
    stats = {}
    got_seg, got = tp3.hmt3d_segment(pb, intensity, models["port" + bc],
                                     device="cpu", stats=stats, **SEG_KW,
                                     **kw)
    assert got_seg.shape == pb.shape
    for k in ("seg0", "order", "probs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["order"]) > 50
    assert got["n_picks"] == want["n_picks"]
    np.testing.assert_array_equal(got_seg, want_seg)
    truth = stack["truth3d"]
    assert tp.evaluate(got_seg, truth) == jp.evaluate(want_seg, truth)
    assert {"t_watershed", "t_pre_merge", "t_rag", "t_merge_loop",
            "t_tree_resolve", "t_segmentation"} <= set(stats)


REFUSED = {"host": dict(engine="host", backend="np"),
           "host_device_walk": dict(engine="host", backend="device"),
           "device": dict(engine="device"),
           "device_bc": dict(engine="device_bc")}


@pytest.fixture(scope="module")
def section_models():
    """Forests trained by the port on 2D sections: hmt_train's (148
    columns) and one on random rows of the sections' BC width without
    saliencies (143)."""
    slices = [synthetic_em_slice((64, 64), n_cells=10, seed=s)
              for s in (31, 32)]
    rng = np.random.default_rng(0)
    X = rng.random((80, 143))
    y = np.where(rng.random(80) < 0.5, 1, -1)
    return {"full": tp.hmt_train(slices, n_trees=10, **SEG_KW),
            "bc": tp.HmtModel(forest=t_train_forest(X, y, n_trees=10))}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_forest_trained_on_sections_is_refused_on_a_volume(
        name, stack, section_models):
    """ROADMAP fault: glia_tpu segments a volume with a forest trained on
    sections, walking its splits on the columns three places off; the
    port refuses it by its width on every engine."""
    kw = REFUSED[name]
    model = section_models["bc" if kw["engine"] == "device_bc" else "full"]
    assert model.forest.n_features in (143, 148)
    pb, intensity = volume(stack)
    with pytest.raises(ValueError, match="trained on 14[38] features"):
        tp3.hmt3d_segment(pb, intensity, model, device="cpu", **SEG_KW,
                          **kw)


def test_glia_tpu_walks_a_section_forest_on_a_volume(stack):
    """The fault the refusal guards against: glia_tpu's hmt3d_segment
    returns a segmentation with a 148-column forest on 151-column
    vectors."""
    slices = [synthetic_em_slice((64, 64), n_cells=10, seed=s)
              for s in (31, 32)]
    jm = jp.hmt_train(slices, n_trees=10, **SEG_KW)
    assert int(jm.forest.feature.max()) < 148
    pb, intensity = volume(stack)
    seg, info = jp3.hmt3d_segment(pb, intensity, jm, **SEG_KW)
    assert seg.shape == pb.shape and len(info["probs"]) > 0


@pytest.fixture(scope="module")
def plan_rag():
    shape, n_cells, seed = STACKS["adaptive_plan"]
    st = synthetic_em_stack(shape=shape, n_cells=n_cells, seed=seed)
    seg = watershed_native(st["pb3d"], level=0.01)
    return st["pb3d"], seg, build_rag(seg, contour_only=False)


def test_adaptive_plan_engages_on_3d_rag(plan_rag):
    """glia_tpu's tests/test_merge_device.py:555: the multi-phase engine's
    adaptive plan on a 3D supervoxel RAG, with no fallback, then replayed
    from the memo; rows equal to glia_tpu's."""
    pb, _, rag = plan_rag
    u, v, s, c = edge_mean_arrays(rag, pb)
    tm._PLAN_MEMO.clear()
    first, again = {}, {}
    order, sal, n_m = tm.merge_batched_device(
        u, v, s, c, rag.n_regions, mode="fused_ms", stats=first,
        device="cpu")
    order2, sal2, n_m2 = tm.merge_batched_device(
        u, v, s, c, rag.n_regions, mode="fused_ms", stats=again,
        device="cpu")
    assert first["fallback"] is False and again["fallback"] is False
    assert first["plan_replayed"] is False and again["plan_replayed"]
    assert n_m > 0 and n_m2 == n_m
    np.testing.assert_array_equal(order2.numpy()[:n_m],
                                  order.numpy()[:n_m])
    j_order, _, j_n = j_batched(u, v, s, c, rag.n_regions, mode="fused_ms")
    assert int(j_n) == n_m
    np.testing.assert_array_equal(order.numpy()[:n_m],
                                  np.asarray(j_order)[:n_m])


def test_plan_memo_shape_collision_costs_one_fallback(plan_rag):
    """The plan memo is keyed by shape, as glia_tpu's: another graph of
    the same (E, R), the 3D RAG with its region ids reversed, replays the
    plan measured on the first.  That costs at most one fallback (which
    drops the plan, so the next call measures its own), and every call
    gives the rows of a call on an empty memo."""
    pb, _, rag = plan_rag
    u, v, s, c = edge_mean_arrays(rag, pb)
    R = rag.n_regions
    ru, rv = R - 1 - v, R - 1 - u

    def run(uu, vv):
        st = {}
        order, _, n_m = tm.merge_batched_device(
            uu, vv, s, c, R, mode="fused_ms", stats=st, device="cpu")
        return order.numpy()[:n_m], st

    tm._PLAN_MEMO.clear()
    want, _ = run(u, v)
    tm._PLAN_MEMO.clear()
    _, first = run(ru, rv)
    assert first["fallback"] is False and first["plan_replayed"] is False
    seen = [run(u, v) for _ in range(3)]
    assert sum(st["fallback"] for _, st in seen) <= 1
    assert seen[0][1]["fallback"] or seen[0][1]["plan_replayed"]
    assert seen[-1][1]["fallback"] is False
    assert seen[-1][1]["plan_replayed"]
    for order, _ in seen:
        np.testing.assert_array_equal(order, want)
    assert len(tm._PLAN_MEMO) == 1


@pytest.mark.parametrize("policy", ["mean", "median", "median_minsize"])
def test_greedy_merge_device_on_a_volume_matches(policy, plan_rag):
    pb, seg, rag = plan_rag
    want_o, want_s = greedy_merge_device(rag, pb, policy=policy)
    got_o, got_s = tm.greedy_merge_device(
        t_build_rag(seg, contour_only=False), pb, policy=policy,
        device="cpu")
    assert len(got_o) > 100
    np.testing.assert_array_equal(got_o, want_o)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("backend", ["np", "device"])
def test_link3d_pipeline_matches(backend, stack):
    """glia_tpu's tests/test_pipeline3d.py round trip: the truth sections
    as segmentations, the link forest equal node for node, the linked
    volume equal (the device walk on the CPU gives the same links)."""
    slices = stack["slices"]
    segs = [s["truth"] for s in slices]
    jmodel = jp3.link3d_train(slices, segs, n_trees=30)
    model = tp3.link3d_train(slices, segs, n_trees=30)
    for k in FOREST_ARRAYS:
        np.testing.assert_array_equal(getattr(model, k), getattr(jmodel, k))
    want = jp3.link3d_segment(slices, segs, jmodel, min_score=0.5)
    stats = {}
    got = tp3.link3d_segment(slices, segs, model, min_score=0.5,
                             backend=backend, device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats["pairs"] > 0 and stats["links"] > 0
    truth = stack["truth3d"]
    from glia_tpu_torch.metrics import eval_ri

    err = eval_ri([got[z] for z in range(len(slices))],
                  [truth[z] for z in range(len(slices))])[2]
    assert err < 0.1


def test_link3d_segment_needs_a_card_by_default(stack, monkeypatch):
    """With its defaults link3d_segment walks the link forest on the
    card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    slices = stack["slices"][:2]
    segs = [s["truth"] for s in slices]
    model = tp3.link3d_train(slices, segs, n_trees=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp3.link3d_segment(slices, segs, model)


def test_hmt3d_segment_needs_a_card_by_default(stack, models,
                                               monkeypatch):
    """With its defaults hmt3d_segment walks the forest on the card, and
    raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pb, intensity = volume(stack)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp3.hmt3d_segment(pb, intensity, models["port"], **SEG_KW)
