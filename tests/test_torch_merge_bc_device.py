"""Port device BC merge engine vs glia_tpu.graph.merge_bc_device.

On the 48x48 case of tests/test_merge_bc_device.py (standard and
median_as_feats configs): build_state gives equal arrays, the initial
candidate features and valid mask match (rtol 1e-12, float64 on both
sides), and merge_order_bc_device gives identical order rows and
probabilities within rtol 1e-9 with the linear predictor of that file and
with a forest scorer (JAX: make_label_scorer(backend="xla", embed=True);
port: the plain walk on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import glia_tpu.graph.merge_bc_device as jmbd
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig, HistImage
from glia_tpu.graph.rag import build_rag as jax_build_rag
from glia_tpu.models.forest import make_label_scorer as jax_label_scorer
from glia_tpu.models.forest import train_forest
from glia_tpu.native import watershed_native
from glia_tpu_torch.graph import merge_bc_device as mbd
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.models.forest import ForestModel, make_label_scorer


def _cfgs(data):
    def q(a, k):
        return np.round(np.asarray(a) * k) / k

    pb_q, in_q = q(data["pb"], 32), q(data["intensity"], 24)
    return {
        "standard": FeatureConfig.standard(
            data["pb"], data["intensity"], n_bins=8,
            boundary_thresholds=(0.3, 0.6)),
        "median": FeatureConfig(
            pb_image=data["pb"],
            r_images=[HistImage(pb_q, 6, (0.0, 1.0), "pb"),
                      HistImage(in_q, 10, (0.0, 1.0), "in")],
            rl_images=[],
            b_images=[HistImage(in_q, 9, (0.0, 1.0), "in"),
                      HistImage(pb_q, 5, (0.0, 1.0), "pb")],
            boundary_thresholds=[0.3, 0.6],
            normalizing_area=4.0, normalizing_length=2.0,
            histogram_as_feats=True, median_as_feats=True),
    }


@pytest.fixture(scope="module")
def case():
    data = synthetic_em_slice(shape=(48, 48), n_cells=8, seed=77)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0), level=0.02)
    return (jax_build_rag(seg, contour_only=False),
            build_rag(seg, contour_only=False), _cfgs(data))


CONFIGS = ["standard", "median"]


def _port_features(rag, cfg):
    state_np, static = mbd.build_state(rag, cfg)
    state = mbd.state_to_device(state_np, torch.device("cpu"), torch.float64)
    feats, valid = mbd.candidate_features(state, static)
    return feats.numpy(), valid.numpy()


def test_rag_copy_matches(case):
    jrag, rag, _ = case
    for k in ("keys", "sizes", "edges", "edge_ptr", "edge_pixels",
              "dir_pairs", "dir_ptr", "dir_pixels", "border_ptr",
              "border_pixels", "region_ptr", "region_pixels"):
        np.testing.assert_array_equal(getattr(rag, k), getattr(jrag, k))


@pytest.mark.parametrize("name", CONFIGS)
def test_build_state_arrays_equal(case, name):
    jrag, rag, cfgs = case
    want, jstatic = jmbd.build_state(jrag, cfgs[name])
    got, static = mbd.build_state(rag, cfgs[name])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for f in ("C", "E", "R", "feat_dim", "res_off", "rmin_off"):
        assert getattr(static, f) == getattr(jstatic, f), f
    for p in ("ca", "cm", "cx", "ea"):
        assert getattr(static, p).slices == getattr(jstatic, p).slices


@pytest.mark.parametrize("name", CONFIGS)
def test_initial_candidate_features_match(case, name):
    jrag, rag, cfgs = case
    state_np, jstatic = jmbd.build_state(jrag, cfgs[name])
    want, want_valid = jax.jit(
        lambda s: jmbd.candidate_features(s, jstatic))(
            {k: jnp.asarray(v) for k, v in state_np.items()})
    got, valid = _port_features(rag, cfgs[name])
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    assert valid.sum() > 10
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def _linear(W):
    def jax_fn(X):
        Wd = jnp.asarray(W)
        return 1.0 / (1.0 + jnp.exp(-(X @ Wd[:-1] + Wd[-1])))

    def port_fn(X):
        Wt = torch.from_numpy(W).to(X.dtype)
        return 1.0 / (1.0 + torch.exp(-(X @ Wt[:-1] + Wt[-1])))

    return jax_fn, port_fn


def _assert_same_merge(jrag, rag, cfg, jax_run, port_fn):
    want_order, want_probs = jax_run(jrag, cfg)
    stats = {}
    got_order, got_probs = mbd.merge_order_bc_device(
        rag, cfg, port_fn, stats=stats, device="cpu")
    assert len(want_order) > 0
    np.testing.assert_array_equal(got_order, want_order)
    np.testing.assert_allclose(got_probs, want_probs, rtol=1e-9, atol=0)
    assert stats["n_supersteps"] > 1 and stats["n_scored"] > 0


def _linear_weights(cfg):
    return np.random.default_rng(5).normal(
        0, 0.05, jmbd.bc_feat_dim(cfg, 2) + 1)


@pytest.fixture(scope="module")
def jax_linear_orders(case):
    """glia_tpu's merge order and probabilities with the linear predictor,
    per config (each JAX merge loop compiles once)."""
    jrag, _, cfgs = case
    return {name: jmbd.merge_order_bc_device(
                jrag, cfgs[name], _linear(_linear_weights(cfgs[name]))[0])
            for name in CONFIGS}


@pytest.mark.parametrize("name", CONFIGS)
def test_merge_order_linear_predictor(case, jax_linear_orders, name):
    jrag, rag, cfgs = case
    port_fn = _linear(_linear_weights(cfgs[name]))[1]
    _assert_same_merge(jrag, rag, cfgs[name],
                       lambda r, c: jax_linear_orders[name], port_fn)


@pytest.mark.parametrize("name", CONFIGS)
def test_merge_order_forest_scorer(case, name):
    jrag, rag, cfgs = case
    cfg = cfgs[name]
    X = _port_features(rag, cfg)[0]
    rng = np.random.default_rng(2)
    y = np.where(X[:, 0] + rng.normal(0, X[:, 0].std(), len(X))
                 > np.median(X[:, 0]), 1, -1)
    jforest = train_forest(X, y, n_trees=15, seed=1)
    fn, consts = jax_label_scorer(jforest, label=-1, backend="xla",
                                  embed=True)
    forest = ForestModel.from_arrays(
        jforest.feature, jforest.threshold, jforest.left, jforest.right,
        jforest.leaf_class, jforest.n_classes, jforest.max_depth,
        jforest.classes)
    _assert_same_merge(
        jrag, rag, cfg,
        lambda r, c: jmbd.merge_order_bc_device(r, c, fn,
                                                predict_consts=consts),
        make_label_scorer(forest, label=-1, device="cpu"))


def test_max_supersteps_caps_the_loop(case, jax_linear_orders):
    """Two supersteps give the first rows of glia_tpu's full order."""
    _, rag, cfgs = case
    cfg = cfgs["standard"]
    want, want_probs = jax_linear_orders["standard"]
    stats = {}
    got, probs = mbd.merge_order_bc_device(
        rag, cfg, _linear(_linear_weights(cfg))[1], max_supersteps=2,
        stats=stats, device="cpu")
    assert stats["n_supersteps"] == 2 and 0 < len(got) < len(want)
    np.testing.assert_array_equal(got, want[:len(got)])
    np.testing.assert_allclose(probs, want_probs[:len(got)], rtol=1e-9)


@pytest.mark.parametrize("name", CONFIGS)
def test_edges_stay_sorted_by_lower_endpoint(case, name):
    """Over a whole merge: ``e_lo`` is non-decreasing, equals ``eu`` on
    every alive edge and on every edge its sum does not drop, so the sums
    by lower endpoint may state sorted ids (segment_sum_torch checks the
    order on the CPU at every call, too)."""
    _, rag, cfgs = case
    cfg = cfgs[name]
    state_np, static = mbd.build_state(rag, cfg)
    state = mbd.state_to_device(state_np, torch.device("cpu"), torch.float64)
    port_fn = _linear(_linear_weights(cfg))[1]
    n_steps, n_dead_inside = 0, 0
    while bool((state["e_alive"] & state["e_table"]).any()) and n_steps < 40:
        lo, eu, alive = state["e_lo"], state["eu"], state["e_alive"]
        assert bool((lo[1:] >= lo[:-1]).all())
        assert bool(((lo == eu) | (lo == static.C)).all())
        assert bool((lo[alive] == eu[alive]).all())
        n_dead_inside += int((~alive & (lo < static.C)).sum())
        state = mbd.superstep(state, static, port_fn)[0]
        n_steps += 1
    assert n_steps > 1
    # duplicates that died in a dedupe stay inside their run
    assert n_dead_inside > 0


def test_state_to_device_refuses_unsorted_edges(case):
    _, rag, cfgs = case
    state_np, _ = mbd.build_state(rag, cfgs["standard"])
    state_np = dict(state_np, eu=state_np["eu"][::-1].copy())
    with pytest.raises(ValueError, match="sorted by lower endpoint"):
        mbd.state_to_device(state_np, torch.device("cpu"), torch.float64)
