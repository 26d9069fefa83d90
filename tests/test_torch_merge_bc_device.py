"""Port device BC merge engine vs glia_tpu.graph.merge_bc_device.

On the 48x48 case of tests/test_merge_bc_device.py (standard and
median_as_feats configs): build_state gives equal arrays, the initial
candidate features and valid mask match (rtol 1e-12, float64 on both
sides), and merge_order_bc_device gives identical order rows and
probabilities within rtol 1e-9 with the linear predictor of that file and
with a forest scorer (JAX: make_label_scorer(backend="xla", embed=True);
port: the plain walk on the CPU).  The port runs each superstep on the
prefix of the edge arrays that holds the live edges: a superstep gives the
same bits on any such prefix, and a whole merge the same bits as one
that never cuts the arrays.
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
from glia_tpu_torch.utils import profiling


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


def _forest(rag, cfg):
    """A 15-tree forest trained on the initial candidates' features:
    (glia_tpu's forest, the port's ForestModel of it)."""
    X = _port_features(rag, cfg)[0]
    rng = np.random.default_rng(2)
    y = np.where(X[:, 0] + rng.normal(0, X[:, 0].std(), len(X))
                 > np.median(X[:, 0]), 1, -1)
    jforest = train_forest(X, y, n_trees=15, seed=1)
    return jforest, ForestModel.from_arrays(
        jforest.feature, jforest.threshold, jforest.left, jforest.right,
        jforest.leaf_class, jforest.n_classes, jforest.max_depth,
        jforest.classes)


@pytest.fixture(scope="module")
def forests(case):
    _, rag, cfgs = case
    return {name: _forest(rag, cfgs[name]) for name in CONFIGS}


@pytest.mark.parametrize("name", CONFIGS)
def test_merge_order_forest_scorer(case, forests, name):
    jrag, rag, cfgs = case
    cfg = cfgs[name]
    jforest, forest = forests[name]
    fn, consts = jax_label_scorer(jforest, label=-1, backend="xla",
                                  embed=True)
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


def _cut(state, rows):
    return {k: v[:rows] if k in mbd.EDGE_KEYS else v
            for k, v in state.items()}


def _bits(t):
    """``t`` with floats as their bit patterns (NaN equals itself)."""
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _assert_same_bits(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), what


@pytest.mark.parametrize("cut", ["bucket", "live"])
@pytest.mark.parametrize("name", CONFIGS)
def test_superstep_on_a_live_prefix_gives_the_same_bits(case, forests,
                                                        name, cut):
    """A superstep on a state cut to the smallest capacity that holds its
    live edges, or to exactly those, gives the superstep of the whole
    state: the prefix of every edge array, every component array, the
    merged rows, their probabilities and the counts."""
    _, rag, cfgs = case
    state_np, static = mbd.build_state(rag, cfgs[name])
    state = mbd.state_to_device(state_np, torch.device("cpu"), torch.float64)
    scorer = make_label_scorer(forests[name][1], label=-1, device="cpu")
    E, n_steps = static.E, 0
    # whole-state supersteps until the live edges fit half the capacity
    while True:
        state, *_, n_left, _, _, n_live = mbd.superstep(state, static,
                                                        scorer)
        n_steps += 1
        n_live = int(n_live)
        assert int(n_left) > 0 and n_steps < 10
        if mbd._edge_capacity(E, n_live, 0) > 0 and n_steps >= 2:
            break
    assert not bool(state["e_alive"][n_live:].any())
    assert bool((state["e_lo"][n_live:] == static.C).all())
    rows = n_live
    if cut == "bucket":
        rows = ((E - 1) >> mbd._edge_capacity(E, n_live, 0)) + 1
        assert n_live <= rows < E
    full = mbd.superstep(state, static, scorer)
    part = mbd.superstep(_cut(state, rows), static, scorer)
    st_f, st_p = full[0], part[0]
    ok_f, ok_p = full[3], part[3]
    assert bool(ok_p.any()) and not bool(ok_f[rows:].any())
    _assert_same_bits(ok_p, ok_f[:rows], "ok")
    _assert_same_bits(part[1][ok_p], full[1][ok_f], "rows")
    _assert_same_bits(part[2][ok_p], full[2][ok_f], "probs")
    for i, what in zip(range(4, 8), ("n_left", "n_scored", "n_new",
                                     "n_live")):
        assert int(part[i]) == int(full[i]), what
    live = int(full[7])
    assert sorted(st_p) == sorted(st_f)
    for k in st_f:
        want = st_f[k][:live] if k in mbd.EDGE_KEYS else st_f[k]
        got = st_p[k][:live] if k in mbd.EDGE_KEYS else st_p[k]
        _assert_same_bits(got, want, k)


@pytest.mark.parametrize("max_supersteps", [None, 5])
@pytest.mark.parametrize("name", CONFIGS)
def test_merge_on_live_prefixes_gives_the_same_bits(case, forests, name,
                                                    max_supersteps,
                                                    monkeypatch):
    """A whole merge, or one cut at its fifth superstep, gives the same
    order, probabilities and merges a superstep as the same merge run on
    every staged edge; its edge rows a superstep start at E and halve
    while the live edges of the superstep before fit."""
    _, rag, cfgs = case
    scorer = make_label_scorer(forests[name][1], label=-1, device="cpu")
    lives = []
    real = mbd.superstep

    def superstep(state, static, predict_fn):
        out = real(state, static, predict_fn)
        lives.append(int(out[7]))
        return out

    def run():
        st = {}
        order, probs = mbd.merge_order_bc_device(
            rag, cfgs[name], scorer, max_supersteps=max_supersteps,
            stats=st, device="cpu")
        return order, probs, st

    monkeypatch.setattr(mbd, "superstep", superstep)
    profiling.reset()
    order, probs, st = run()
    counts = [r.counts for r in profiling.records if r.name == "bc.merge"]
    live = list(lives)
    monkeypatch.setattr(mbd, "_edge_capacity", lambda E, n_live, k: k)
    want_order, want_probs, want = run()

    E, rows = st["E"], st["edge_rows_per_superstep"]
    assert want["edge_rows_per_superstep"] == [E] * want["n_supersteps"]
    np.testing.assert_array_equal(order, want_order)
    assert probs.tobytes() == want_probs.tobytes()
    for k in ("merges_per_superstep", "n_supersteps", "n_scored", "E"):
        assert st[k] == want[k], k
    assert len(rows) == st["n_supersteps"] and rows[0] == E
    assert rows[-1] < E
    # each the smallest capacity ceil(E / 2**k), k never falling, that
    # holds the live edges the superstep before left
    caps = {((E - 1) >> k) + 1 for k in range((E - 1).bit_length() + 1)}
    for i in range(1, len(rows)):
        fit = min(c for c in caps if c >= live[i - 1])
        assert rows[i] == min(rows[i - 1], fit)
    assert [c["bc.edge_rows"] for c in counts] == [sum(rows)]
