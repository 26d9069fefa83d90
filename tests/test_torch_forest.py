"""Port forest walk vs glia_tpu's three forms of the same function.

The port's plain walk (glia_tpu_torch.models.forest.forest_votes_torch)
against glia_tpu's host oracle predict_votes_np, its XLA gather walk
forest_votes_jax_fn and its Pallas kernel forest_votes_pallas_fn (in
interpret mode), on sklearn forests trained by glia_tpu's train_forest;
and the packed node records and the launch plan of the CUDA kernel (the
walk over the records ends on the leaves of the walk over the flat tables).
The JAX forms run jitted, as glia_tpu runs them (make_predict_votes_jax,
make_forest_votes_pallas, the merge loop): under jit XLA computes votes / T
as count * fl32(1/T), which the port reproduces.  Tolerance: exact.  The
float32 walks compare bitwise; the float64 oracle's count / T compares
through the vote counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glia_tpu.models.forest import (
    forest_votes_jax_fn,
    predict_votes_np,
    train_forest,
)
from glia_tpu.models.forest import predict_label_fraction as jax_fraction
from glia_tpu.models.forest import ForestModel as JaxForestModel
from glia_tpu.ops.pallas.forest import forest_votes_pallas_fn
from glia_tpu_torch.models.forest import (
    ForestModel,
    ForestTables,
    forest_leaves_packed_torch,
    forest_leaves_torch,
    forest_votes,
    forest_votes_torch,
    make_label_scorer,
    pack_nodes,
    predict_label_fraction,
)
from glia_tpu_torch.models.forest import predict_votes_np as port_votes_np
from glia_tpu_torch.ops.cuda import (
    FOREST_STATIC_SMEM,
    FOREST_THREADS,
    MAX_CLASSES,
    forest_launch_plan,
    forest_splits,
)


def _to_port(m):
    return ForestModel.from_arrays(m.feature, m.threshold, m.left, m.right,
                                   m.leaf_class, m.n_classes, m.max_depth,
                                   m.classes)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    y = np.where((X[:, 0] + 0.3 * X[:, 3] > 0.6) | (X[:, 5] > 0.9), 1, -1)
    return X, y


@pytest.fixture(scope="module", params=["shallow", "deep"])
def forest_case(request):
    if request.param == "shallow":
        X, y = _data(300, 7, 1)
        model = train_forest(X, y, n_trees=11, seed=3, max_depth=3)
    else:
        X, y = _data(2000, 20, 2)
        model = train_forest(X, y, n_trees=31, seed=4)
    # rows whose features sit exactly on split thresholds: ties go left
    rng = np.random.default_rng(7)
    ties = X[:256].copy()
    ti, ni = np.nonzero(model.feature >= 0)
    for r in range(len(ties)):
        k = rng.integers(0, len(ti), 8)
        ties[r, model.feature[ti[k], ni[k]]] = model.threshold[ti[k], ni[k]]
    return model, np.concatenate([X, ties])


def _port_votes(model, X):
    tables = ForestTables.from_model(_to_port(model), "cpu")
    return forest_votes_torch(torch.from_numpy(X), tables).numpy()


def test_walk_matches_host_oracle_counts(forest_case):
    model, X = forest_case
    got = _port_votes(model, X)
    want = predict_votes_np(model, X)
    T = model.n_trees
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.rint(got.astype(np.float64) * T),
                                  np.rint(want * T))
    np.testing.assert_array_equal(
        got, np.rint(want * T).astype(np.float32)
        * (np.float32(1) / np.float32(T)))


def test_host_oracle_copy_matches(forest_case):
    model, X = forest_case
    np.testing.assert_array_equal(port_votes_np(_to_port(model), X),
                                  predict_votes_np(model, X))


def test_walk_matches_xla_walk(forest_case):
    model, X = forest_case
    fn, tables = forest_votes_jax_fn(model)
    want = np.asarray(jax.jit(fn)(
        jnp.asarray(X), {k: jnp.asarray(v) for k, v in tables.items()}))
    np.testing.assert_array_equal(_port_votes(model, X), want)


def test_walk_matches_pallas_kernel(forest_case):
    model, X = forest_case
    fn, tab = forest_votes_pallas_fn(model, block_b=256, interpret=True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(X), jnp.asarray(tab)))
    np.testing.assert_array_equal(_port_votes(model, X), want)


def test_walk_ends_on_a_leaf_of_each_tree(forest_case):
    model, X = forest_case
    tables = ForestTables.from_model(_to_port(model), "cpu")
    leaves = forest_leaves_torch(torch.from_numpy(X), tables)
    assert leaves.shape == (len(X), model.n_trees)
    assert bool((tables.feature[leaves] < 0).all())
    np.testing.assert_array_equal(
        (leaves // tables.n_nodes).numpy(),
        np.broadcast_to(np.arange(model.n_trees), leaves.shape))


def test_float64_features_compare_as_float32(forest_case):
    """f64 features are cast to f32 before comparing, as glia_tpu does."""
    model, X = forest_case
    X64 = X.astype(np.float64) + 1e-12
    tables = ForestTables.from_model(_to_port(model), "cpu")
    got = forest_votes_torch(torch.from_numpy(X64), tables).numpy()
    np.testing.assert_array_equal(got, _port_votes(model, X))


def test_save_load_round_trip(forest_case, tmp_path):
    model, X = forest_case
    path = tmp_path / "rf.npz"
    model.save(path)
    loaded = ForestModel.load(path)
    for k in ("feature", "threshold", "left", "right", "leaf_class",
              "classes"):
        np.testing.assert_array_equal(getattr(loaded, k), getattr(model, k))
    assert (loaded.n_classes, loaded.max_depth) == (model.n_classes,
                                                    model.max_depth)
    loaded.save(tmp_path / "port.npz")
    back = JaxForestModel.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(back.threshold, model.threshold)
    tables = ForestTables.from_model(loaded, "cpu")
    np.testing.assert_array_equal(
        forest_votes_torch(torch.from_numpy(X), tables).numpy(),
        _port_votes(model, X))


def test_label_scorer_cpu_picks_the_label_column(forest_case):
    model, X = forest_case
    score = make_label_scorer(_to_port(model), label=-1, device="cpu")
    li = int(np.nonzero(model.classes == -1)[0][0])
    np.testing.assert_array_equal(score(torch.from_numpy(X)).numpy(),
                                  _port_votes(model, X)[:, li])
    tables = ForestTables.from_model(_to_port(model), "cpu")
    np.testing.assert_array_equal(
        forest_votes(torch.from_numpy(X), tables).numpy(),
        _port_votes(model, X))


def test_from_arrays_rejects_bad_tables():
    f = np.array([[0, -1, -1]], np.int32)
    thr = np.zeros((1, 3), np.float32)
    ok = dict(feature=f, threshold=thr, left=np.array([[1, 0, 0]]),
              right=np.array([[2, 0, 0]]), leaf_class=np.zeros((1, 3)),
              n_classes=2, max_depth=1, classes=np.array([-1, 1]))
    m = ForestModel.from_arrays(**ok)
    assert m.feature.dtype == np.int32 and m.threshold.dtype == np.float32
    with pytest.raises(ValueError, match="child index"):
        ForestModel.from_arrays(**{**ok, "right": np.array([[3, 0, 0]])})
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        ForestModel.from_arrays(**{**ok, "left": np.array([[1, 0]])})


def test_walk_rejects_features_beyond_the_sample_width():
    """A forest that splits on column >= D raises instead of reading
    another row (glia_tpu's flat gather reads the next sample there)."""
    m = ForestModel.from_arrays(
        np.array([[5, -1, -1]]), np.zeros((1, 3)), np.array([[1, 0, 0]]),
        np.array([[2, 0, 0]]), np.zeros((1, 3)), 2, 1, np.array([-1, 1]))
    tables = ForestTables.from_model(m, "cpu")
    with pytest.raises(ValueError, match="feature 5"):
        forest_votes_torch(torch.zeros((4, 5)), tables)


@pytest.mark.parametrize("backend,jbackend", [("np", "np"),
                                              ("device", "jax")])
@pytest.mark.parametrize("label", [-1, 1])
def test_predict_label_fraction_matches(forest_case, backend, jbackend,
                                        label):
    """backend="np" divides in float64 (votes / T); the device walk casts
    X to float32 and gives count * fl32(1/T) in float32, as glia_tpu's
    jitted walk does.  Both equal glia_tpu's bit for bit."""
    model, X = forest_case
    X64 = X.astype(np.float64)
    got = predict_label_fraction(_to_port(model), X64, label=label,
                                 backend=backend, device="cpu")
    want = np.asarray(jax_fraction(model, X64, label=label,
                                   backend=jbackend))
    assert got.dtype == want.dtype
    assert got.dtype == (np.float64 if backend == "np" else np.float32)
    np.testing.assert_array_equal(got, want)


def test_predict_label_fraction_rejects_unknown_backend(forest_case):
    model, X = forest_case
    with pytest.raises(ValueError, match="np|device"):
        predict_label_fraction(_to_port(model), X, label=-1, backend="xla",
                               device="cpu")


def test_device_backend_needs_cuda_unless_cpu_is_named(forest_case,
                                                       monkeypatch):
    model, X = forest_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_label_fraction(_to_port(model), X, label=-1,
                               backend="device")
    # the host walk needs no device
    predict_label_fraction(_to_port(model), X, label=-1, backend="np")


# ---------------------------------------------------------------------------
# the packed node records the CUDA kernel reads, and its launch plan
# ---------------------------------------------------------------------------

def _stump_forest():
    """Three trees of [T, 5] slots: a lone leaf, a stump, and a tree of
    five nodes; the first two end in padding."""
    f = np.array([[-1, -1, -1, -1, -1], [2, -1, -1, -1, -1],
                  [0, 1, -1, -1, -1]], np.int32)
    thr = np.array([[0, 0, 0, 0, 0], [0.5, 0, 0, 0, 0],
                    [0.25, 0.75, 0, 0, 0]], np.float32)
    left = np.array([[0, 0, 0, 0, 0], [1, 0, 0, 0, 0], [1, 3, 0, 0, 0]])
    right = np.array([[0, 0, 0, 0, 0], [2, 0, 0, 0, 0], [2, 4, 0, 0, 0]])
    cls = np.array([[1, 0, 0, 0, 0], [0, 0, 1, 0, 0], [0, 0, 1, 1, 0]])
    return ForestModel.from_arrays(f, thr, left, right, cls, 2, 2,
                                   np.array([-1, 1]))


def test_packed_walk_ends_on_the_same_leaves(forest_case):
    model, X = forest_case
    tables = ForestTables.from_model(_to_port(model), "cpu")
    Xt = torch.from_numpy(X)
    assert torch.equal(forest_leaves_packed_torch(Xt, tables),
                       forest_leaves_torch(Xt, tables))


def test_packed_records_of_stumps_and_padding():
    model = _stump_forest()
    packed, start, n_real = pack_nodes(model)
    np.testing.assert_array_equal(n_real, [1, 3, 5])
    np.testing.assert_array_equal(start, [0, 1, 4, 9])
    assert packed.shape == (9, 4) and packed.dtype == np.int32
    # a leaf: feature -1, its class in the left field
    np.testing.assert_array_equal(packed[0], [-1, 0, 1, 0])
    np.testing.assert_array_equal(
        packed[1], [2, np.float32(0.5).view(np.int32), 1, 2])
    np.testing.assert_array_equal(packed[3], [-1, 0, 1, 0])
    tables = ForestTables.from_model(model, "cpu")
    X = torch.tensor([[0.1, 0.9, 0.5], [0.25, 0.75, 0.6], [0.9, 0.0, 0.0]])
    want = forest_leaves_torch(X, tables)
    assert torch.equal(forest_leaves_packed_torch(X, tables), want)
    np.testing.assert_array_equal(want.numpy(),
                                  [[0, 6, 14], [0, 7, 13], [0, 6, 12]])


def test_real_nodes_must_be_a_prefix():
    model = _stump_forest()
    # the stump's right child moves behind a slot that nothing refers to
    model.right[1, 0] = 3
    with pytest.raises(ValueError, match="tree 1.*prefix"):
        pack_nodes(model)
    with pytest.raises(ValueError, match="prefix"):
        ForestTables.from_model(model, "cpu")


@pytest.mark.parametrize("B,D", [(23807, 143), (8919, 148), (100, 7),
                                 (5000, 1000)])
def test_launch_plan_fits_the_device(B, D):
    """Every stage fits its buffer, the block fits the shared memory, and
    the split does not exceed the stages (H100: 132 SMs, 232,448 bytes)."""
    n_real = np.random.default_rng(3).integers(50, 648, 255)
    limit = 232448
    plan = forest_launch_plan(n_real, D, limit)
    assert plan["staged"]
    TS, G = 1 << plan["ts_log2"], plan["G"]
    assert 32 <= TS <= 256 and FOREST_THREADS % TS == 0
    start = np.concatenate([[0], np.cumsum(n_real)])
    edges = np.minimum(np.arange(0, 255 + G, G), 255)
    assert np.diff(start[edges]).max() <= plan["buf_nodes"]
    assert plan["x_stride"] >= D and plan["x_stride"] % 2 == 1
    smem = 4 * (TS * MAX_CLASSES + 256 + TS * plan["x_stride"]) \
        + 32 * plan["buf_nodes"]
    assert smem + FOREST_STATIC_SMEM <= limit
    n_splits = forest_splits(plan, 255, B, 132)
    assert 1 <= n_splits <= -(-255 // G)
    # the blocks of all tiles make at most one wave, unless the tiles
    # alone are more than the SMs
    assert n_splits == 1 or -(-B // TS) * n_splits <= 132
    # a smaller batch is split further, to fill the SMs
    assert forest_splits(plan, 255, 64, 132) >= n_splits


@pytest.mark.parametrize("n_real,D", [([40000] * 4, 143), ([500] * 16, 4000)],
                         ids=["large_tree", "wide_rows"])
def test_launch_plan_falls_back_to_global_memory(n_real, D):
    plan = forest_launch_plan(np.array(n_real), D, 232448)
    assert not plan["staged"] and plan["buf_nodes"] == 0
    assert 1 <= forest_splits(plan, len(n_real), 1000, 132) \
        <= -(-len(n_real) // plan["G"])


def test_launch_plan_without_shared_memory_walks_global_memory():
    """A limit of 0 bytes (what ``global_memory=True`` plans with) gives the
    global-memory instantiation for a forest that would fit."""
    n_real = np.random.default_rng(3).integers(50, 648, 255)
    assert forest_launch_plan(n_real, 143, 232448)["staged"]
    plan = forest_launch_plan(n_real, 143, 0)
    assert not plan["staged"] and plan["x_stride"] == 143
