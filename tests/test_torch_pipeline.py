"""Port hmt_segment (engines "device_bc" and "device") vs glia_tpu's, end
to end.

A 96x96 synthetic slice (seed 4, 20 cells) and a forest trained by
glia_tpu (watershed -> pre-merge -> host merge order -> BC features and
labels -> train_forest, the steps of glia_tpu.pipeline.hmt_train) on
the BC feature vector the device_bc engine scores: without the saliency
columns, which hmt_train's forests split on and the engine does not
compute.  The forest reaches the port through ForestModel.from_arrays.
Required: identical merge order and final segmentation, probabilities
equal, evaluate() dicts equal to 1e-12.  Also: the device policy (no
silent CPU run) and the kernel wrapper's refusal of CPU tensors.

engine="device" (pb-policy merge order on the device, host BC features,
one forest scoring) runs on the same slice for the policies mean, median
and median_minsize, each with a forest trained by glia_tpu on the 148-wide
BC features (with the saliency columns, which this engine scores).  It is
held against the same steps composed from glia_tpu's functions with
greedy_merge_device's default (mode="fused_ms"): identical seg0, order,
probabilities (host walk and device walk), picks and final segmentation,
evaluate() equal to 1e-12; and against glia_tpu's own
hmt_segment(engine="device"): identical rows and segmentation.  A default
hmt_segment call runs engine="host" on both sides.
"""

import numpy as np
import pytest
import torch

import glia_tpu.pipeline as jp
import glia_tpu_torch.graph.merge_device as tmd
import glia_tpu_torch.native as tn
import glia_tpu_torch.pipeline as tp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.features.labels import bc_labels
from glia_tpu.graph.merge_device import greedy_merge_device
from glia_tpu.graph.rag import build_rag
from glia_tpu.graph.tree import build_tree, node_potentials
from glia_tpu.infer.greedy import resolve_tree_greedy
from glia_tpu.infer.segment import final_segmentation
from glia_tpu.metrics import eval_vi
from glia_tpu.models.forest import train_forest
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.features.config import FeatureConfig as TFeatureConfig
from glia_tpu_torch.graph.rag import build_rag as t_build_rag
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
                                  engine="device_bc", device="cpu",
                                  stats=stats)
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
        tp.hmt_segment(s["pb"], s["intensity"], model, engine="device_bc")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.hmt_segment(s["pb"], s["intensity"], model, engine="device_bc",
                       device="cuda")
    for kw in ({}, {"device": "cuda"}, {"backend": "device"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.hmt_segment(s["pb"], s["intensity"], model, engine="device",
                           **kw)
    for engine in ("device", "host"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.hmt_segment(s["pb"], s["intensity"], model, engine=engine,
                           mode="ccm")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.hmt_train([s], classifier="mlp")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.hmt_train_sshmt([s], [s])


@pytest.mark.parametrize("kw", [{"classifier": "rf"},
                                {"classifier": "rf_ensemble"}])
def test_unported_engines_raise(case, kw, monkeypatch):
    """hmt_train's forest classifiers (once not ported) train on the host
    (no card asked for), return their kind of model, and an unknown
    classifier raises."""
    s, _, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tp.hmt_train([s], n_trees=5, **kw)
    assert m.kind == kw["classifier"]
    forests = ([m.forest] if m.kind == "rf"
               else m.extra["ensemble"].forests)
    assert [f.n_trees for f in forests] == [5] * len(forests)
    with pytest.raises(ValueError, match="rf|rf_ensemble|mlp"):
        tp.hmt_train([s], classifier=kw["classifier"] + "_x", device="cpu")


def test_kernel_wrapper_refuses_cpu_tensors(case):
    _, _, model = case
    tables = ForestTables.from_model(model.forest, "cpu")
    before = dict(launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        forest_votes_cuda(torch.zeros((4, 143), dtype=torch.float32),
                          tables)
    assert launches == before


# ---------------------------------------------------------------------------
# engine="device"
# ---------------------------------------------------------------------------

POLICIES = ["mean", "median", "median_minsize"]


@pytest.fixture(scope="module", params=POLICIES)
def device_case(request):
    """The slice and, for one policy, a forest trained as hmt_train does:
    on bc_features() of the host merge order with its saliencies."""
    policy = request.param
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_native(rag, s["pb"], policy=policy)
    cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    X = TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()
    assert X.shape[1] == 148
    y, _, _ = bc_labels(seg, s["truth"], order, rule="f1")
    f = train_forest(X, y, n_trees=20, seed=0)
    jmodel = jp.HmtModel(forest=f, policy=policy)
    model = tp.hmt_model_from_arrays(
        f.feature, f.threshold, f.left, f.right, f.leaf_class, f.n_classes,
        f.max_depth, f.classes, n_bins=jmodel.n_bins,
        boundary_thresholds=jmodel.boundary_thresholds,
        policy=jmodel.policy, kind=jmodel.kind,
        feature_set=jmodel.feature_set)
    return s, jmodel, model


def _glia_tpu_device_steps(s, jmodel, backend):
    """glia_tpu.pipeline.hmt_segment(engine="device") (pipeline.py:280-283,
    329-341) with the forest walk ``backend``."""
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_device(rag, s["pb"], policy=jmodel.policy)
    feats = jp._features_for(seg, s["pb"], s["intensity"], jmodel, order,
                             sals)
    probs = jmodel.predict_merge_prob(feats, backend=backend)
    tree = build_tree(order)
    picks = resolve_tree_greedy(tree, node_potentials(tree, probs))
    return final_segmentation(seg, tree, picks), {
        "seg0": seg, "order": order, "probs": probs, "n_picks": len(picks)}


@pytest.mark.parametrize("backend", ["np", "device"])
def test_hmt_segment_device_matches_glia_tpu_steps(device_case, backend):
    """A first merge on the shape: the stages are timed apart (a later
    mean merge with exact saliencies is one program, t_plan_program)."""
    s, jmodel, model = device_case
    want_seg, want = _glia_tpu_device_steps(
        s, jmodel, "np" if backend == "np" else "jax")
    for memo in (tmd._PLAN_MEMO, tmd._PLAN_LAST_STEPS, tmd._EXACT_SAL_L):
        memo.clear()
    stats = {}
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine="device", backend=backend,
                                  device="cpu", stats=stats)
    np.testing.assert_array_equal(got["seg0"], want["seg0"])
    assert len(got["order"]) > 20
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    assert got["probs"].dtype == want["probs"].dtype
    assert got["n_picks"] == want["n_picks"]
    np.testing.assert_array_equal(got_seg, want_seg)
    ev_want = jp.evaluate(want_seg, s["truth"])
    ev_got = tp.evaluate(got_seg, s["truth"])
    assert ev_got.keys() == ev_want.keys()
    for k in ev_want:
        assert ev_got[k] == pytest.approx(ev_want[k], rel=1e-12, abs=1e-12)
    assert stats["n_supersteps"] >= 1
    assert {"t_watershed", "t_pre_merge", "t_rag", "t_merge_loop",
            "t_exact_saliency", "t_features", "t_predict",
            "t_tree_resolve", "t_segmentation"} <= set(stats)


def test_hmt_segment_device_vs_glia_tpu_multiphase_engine(device_case):
    """glia_tpu's own hmt_segment(engine="device"): both merge in
    mode="fused_ms", so the same rows, probabilities and segmentation."""
    s, jmodel, model = device_case
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel,
                                    engine="device")
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine="device", device="cpu")
    np.testing.assert_array_equal(got["seg0"], want["seg0"])
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got_seg, want_seg)
    _, _, vi = eval_vi(got_seg, want_seg)
    assert vi == 0.0


def test_hmt_segment_defaults_match_glia_tpu(device_case):
    """hmt_segment with default arguments runs engine="host" in both
    packages (glia_tpu's flow: hmt_train, then hmt_segment)."""
    s, jmodel, model = device_case
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel)
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  device="cpu")
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got_seg, want_seg)


def test_hmt_segment_device_two_phases_matches_glia_tpu():
    """engine="device" on a section whose merge runs two phases of the
    multi-phase engine: the same rows, probabilities and segmentation as
    glia_tpu's hmt_segment(engine="device")."""
    train = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    seg = jp.pre_merge(jp.watershed(train["pb"], 0.05), train["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_native(rag, train["pb"], policy="mean")
    cfg = FeatureConfig.standard(train["pb"], train["intensity"], n_bins=16)
    X = TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()
    y, _, _ = bc_labels(seg, train["truth"], order, rule="f1")
    f = train_forest(X, y, n_trees=10, seed=0)
    jmodel = jp.HmtModel(forest=f, policy="mean")
    model = tp.hmt_model_from_arrays(
        f.feature, f.threshold, f.left, f.right, f.leaf_class, f.n_classes,
        f.max_depth, f.classes, policy="mean")
    s = synthetic_em_slice(shape=(512, 512), n_cells=800, seed=6)
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel,
                                    engine="device")
    stats = {}
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine="device", device="cpu",
                                  stats=stats)
    assert len(stats["buckets"]) == 2 and stats["fallback"] is False
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got_seg, want_seg)


def test_bc_engines_refuse_a_forest_of_another_width(case, tmp_path):
    """A forest trained on 148 columns reads the 143 BC columns in the
    wrong places even when it never splits past column 142: both BC
    engines refuse it, by its training width.  Carried over without a
    width, only its splits are checked, as before."""
    s, _, _ = case
    rng = np.random.default_rng(7)
    X = rng.random((300, 148))
    X[:, 143:] = 0.0              # constant: never split on
    y = np.where(X[:, 0] + X[:, 142] > 1.0, 1, -1)
    f = tp.train_forest(X, y, n_trees=5, seed=0)
    assert f.n_features == 148 and f.feature.max() < 143
    with pytest.raises(ValueError, match="trained on 148"):
        tp.hmt_segment(s["pb"], s["intensity"], tp.HmtModel(forest=f),
                       engine="device_bc", device="cpu")
    seg = tp.pre_merge(tp.watershed(s["pb"], 0.05), s["pb"], (30,))
    cfg = TFeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    with pytest.raises(ValueError, match="trained on 148"):
        tn.greedy_merge_bc_native(t_build_rag(seg, contour_only=False),
                                  cfg, f)
    f.save(tmp_path / "f.npz")
    assert ForestModel.load(tmp_path / "f.npz").n_features == 148
    m = tp.hmt_model_from_arrays(f.feature, f.threshold, f.left, f.right,
                                 f.leaf_class, f.n_classes, f.max_depth,
                                 f.classes, n_features=148)
    assert m.forest.n_features == 148
    bare = tp.hmt_model_from_arrays(f.feature, f.threshold, f.left,
                                    f.right, f.leaf_class, f.n_classes,
                                    f.max_depth, f.classes).forest
    assert bare.n_features is None
    kw = dict(label=1, backend="device", device="cpu")
    np.testing.assert_array_equal(
        tp.predict_label_fraction(bare, X[:, :143], **kw),
        tp.predict_label_fraction(f, X, **kw))
    with pytest.raises(ValueError, match="trained on 148"):
        tp.predict_label_fraction(f, X[:, :143], **kw)


def test_predict_merge_prob_backends(device_case):
    s, jmodel, model = device_case
    rng = np.random.default_rng(9)
    X = rng.random((300, 148))
    for backend, jbackend in (("np", "np"), ("device", "jax")):
        got = model.predict_merge_prob(X, backend=backend, device="cpu")
        want = jmodel.predict_merge_prob(X, backend=jbackend)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="backend"):
        model.predict_merge_prob(X, backend="pallas", device="cpu")


def test_device_engine_checks_policy_and_model(case):
    s, _, model = case
    bad = tp.HmtModel(forest=model.forest, policy="max")
    with pytest.raises(ValueError, match="policies"):
        tp.hmt_segment(s["pb"], s["intensity"], bad, engine="device",
                       device="cpu")
    assert tp.HmtModel(forest=model.forest).policy == "median"
    f = model.forest
    args = (f.feature, f.threshold, f.left, f.right, f.leaf_class,
            f.n_classes, f.max_depth, f.classes)
    with pytest.raises(ValueError, match="kind"):
        tp.hmt_model_from_arrays(*args, kind="mlp")
    # an ensemble takes three forests' arrays, not one forest's
    with pytest.raises(ValueError, match="kind='rf_ensemble'"):
        tp.hmt_model_from_arrays(*args, kind="rf_ensemble")
    member = dict(zip(tp.FOREST_ARRAYS, args))
    ens = tp.hmt_model_from_arrays(kind="rf_ensemble", forests=[member] * 3,
                                   dim0=40, dim1=76, ensemble_threshold=9.0)
    X = np.random.default_rng(2).random((50, 143)) * 20
    np.testing.assert_array_equal(
        ens.predict_merge_prob(X, device="cpu"),
        model.predict_merge_prob(X, device="cpu"))
    with pytest.raises(ValueError, match="feature_set"):
        tp.hmt_model_from_arrays(*args, feature_set="partial")
    # a forest on the "simple" features runs on the host and device
    # engines; device_bc assembles the full vector only, as in glia_tpu
    simple = tp.hmt_model_from_arrays(*args, feature_set="simple")
    with pytest.raises(ValueError, match="feature_set"):
        tp.hmt_segment(s["pb"], s["intensity"], simple, engine="device_bc",
                       device="cpu")
    m = tp.hmt_model_from_arrays(*args, n_bins=8, policy="mean")
    assert (m.n_bins, m.policy) == (8, "mean")
    np.testing.assert_array_equal(m.forest.threshold, f.threshold)


# ---------------------------------------------------------------------------
# engine="host", mode="ccm", training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_merge_native_matches(policy):
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    want = greedy_merge_native(build_rag(seg, contour_only=False), s["pb"],
                               policy=policy)
    got = tn.greedy_merge_native(t_build_rag(seg, contour_only=False),
                                 s["pb"], policy=policy)
    assert len(got[0]) > 20
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="policy"):
        tn.greedy_merge_native(t_build_rag(seg, contour_only=False),
                               s["pb"], policy="max")


@pytest.mark.parametrize("backend", ["np", "device"])
@pytest.mark.parametrize("mode", ["greedy", "ccm"])
def test_hmt_segment_host_forest_matches(device_case, mode, backend):
    s, jmodel, model = device_case
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel,
                                    engine="host", mode=mode,
                                    backend="np" if backend == "np"
                                    else "jax")
    stats = {}
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine="host", mode=mode, backend=backend,
                                  device="cpu", stats=stats)
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    assert got["n_picks"] == want["n_picks"]
    np.testing.assert_array_equal(got_seg, want_seg)
    assert {"t_merge_loop", "t_features", "t_predict",
            "t_tree_resolve"} <= set(stats)


def test_hmt_segment_device_bc_ccm_matches(case):
    s, jmodel, model = case
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jmodel,
                                    engine="device_bc", mode="ccm")
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], model,
                                  engine="device_bc", mode="ccm",
                                  device="cpu")
    assert got["n_picks"] == want["n_picks"]
    np.testing.assert_array_equal(got_seg, want_seg)


TRAIN_SLICES = {"mlp": [((64, 64), 12, 21)],
                "logsig": [((96, 96), 20, 11), ((96, 96), 20, 12)]}


@pytest.fixture(scope="module")
def trained():
    """hmt_train(classifier="mlp") on one 64x64 slice with mlp_hidden
    (2, 2): a case whose Adam trajectory is stable under glia_tpu's
    schedule (3 x 500 steps), so that the two sides' weights can agree
    (test_torch_learn.py shows the (16, 8) default parting after ~300
    steps); hmt_train_sshmt with glia_tpu's defaults on one labeled
    (label_fraction 0.5) and one unlabeled 96x96 slice."""
    sl = {k: [synthetic_em_slice(shape, n_cells=c, seed=seed)
              for shape, c, seed in v] for k, v in TRAIN_SLICES.items()}
    jm = jp.hmt_train(sl["mlp"], classifier="mlp", mlp_hidden=(2, 2))
    st = {}
    tm = tp.hmt_train(sl["mlp"], classifier="mlp", mlp_hidden=(2, 2),
                      device="cpu", stats=st)
    jl = jp.hmt_train_sshmt(sl["logsig"][:1], sl["logsig"][1:],
                            label_fraction=0.5)
    tl = tp.hmt_train_sshmt(sl["logsig"][:1], sl["logsig"][1:],
                            label_fraction=0.5, device="cpu")
    return {"mlp": (jm, tm), "logsig": (jl, tl), "mlp_stats": st}


@pytest.mark.parametrize("kind", ["mlp", "logsig"])
def test_trained_weights_match_glia_tpu(trained, kind):
    jm, tm = trained[kind]
    assert (tm.kind, tm.feature_set, tm.policy, tm.n_bins) == (
        jm.kind, jm.feature_set, jm.policy, jm.n_bins)
    w, ref = tm.extra["w"], jm.extra["w"]
    assert np.max(np.abs(w - ref)) <= 1e-6 * np.max(np.abs(ref))
    np.testing.assert_array_equal(tm.extra["minmax"], jm.extra["minmax"])
    if kind == "mlp":
        assert (tm.extra["n1"], tm.extra["n2"]) == (2, 2)
        st = trained["mlp_stats"]
        assert st["n_steps"] == 1500
        assert {"t_segment", "t_features", "t_labels", "t_path_groups",
                "t_optimizer"} <= set(st)
    else:
        hj, ht = jm.extra["history"], tm.extra["history"]
        assert len(ht) == len(hj) == 5
        for a, b in zip(ht, hj):
            for k in ("energy", "sigma_u", "sigma_s"):
                assert a[k] == pytest.approx(b[k], rel=1e-9)


@pytest.mark.parametrize("mode", ["greedy", "ccm"])
@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("kind", ["mlp", "logsig"])
def test_hmt_segment_with_trained_models(trained, kind, engine, mode):
    """Each side segments the 96x96 test slice with its own trained model:
    the same merge rows (both device engines run mode="fused_ms"),
    probabilities within 1e-6, the same final segmentation (VI 0)."""
    jm, tm = trained[kind]
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"], jm,
                                    engine=engine, mode=mode)
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"], tm,
                                  engine=engine, mode=mode, device="cpu")
    assert len(got["order"]) == len(want["order"]) > 20
    np.testing.assert_array_equal(got["order"], want["order"])
    gap = np.max(np.abs(got["probs"] - want["probs"]))
    assert gap <= 1e-6, f"merge probabilities differ by {gap}"
    _, _, vi = eval_vi(got_seg, want_seg)
    assert vi == 0.0, f"final segmentations differ: VI {vi}"
    assert got["n_picks"] == want["n_picks"]


@pytest.mark.parametrize("kind", ["mlp", "logsig"])
def test_model_from_arrays_predicts_glia_tpu_probabilities(trained, kind):
    """glia_tpu's trained model carried across as numpy arrays: the same
    probabilities (rtol 1e-12) and the same segmentation on the host
    engine.  The MLP is glia_tpu's (16, 8) default training."""
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=4)
    if kind == "mlp":
        jm = jp.hmt_train([synthetic_em_slice((96, 96), n_cells=20,
                                              seed=11)], classifier="mlp")
        m = jm.extra
        tm = tp.hmt_model_from_arrays(kind="mlp", w=m["w"],
                                      minmax=m["minmax"], n1=m["n1"],
                                      n2=m["n2"], policy=jm.policy)
    else:
        jm = trained["logsig"][0]
        tm = tp.hmt_model_from_arrays(kind="logsig", w=jm.extra["w"],
                                      minmax=jm.extra["minmax"],
                                      feature_set="simple")
    X = np.random.default_rng(3).random((50, len(jm.extra["minmax"][0])))
    np.testing.assert_allclose(tm.predict_merge_prob(X, device="cpu"),
                               jm.predict_merge_prob(X), rtol=1e-12)
    want_seg, _ = jp.hmt_segment(s["pb"], s["intensity"], jm, engine="host")
    got_seg, _ = tp.hmt_segment(s["pb"], s["intensity"], tm, engine="host",
                                device="cpu")
    np.testing.assert_array_equal(got_seg, want_seg)
    with pytest.raises(ValueError, match="kind"):
        tp.hmt_model_from_arrays(kind=kind, minmax=jm.extra["minmax"])
