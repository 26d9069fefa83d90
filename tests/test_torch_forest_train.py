"""The port's forest trainer against sklearn and glia_tpu's train_forest.

glia_tpu grows its forests with sklearn's RandomForestClassifier
(glia_tpu/models/forest.py train_forest); the port grows them with its own
CART trainer (glia_tpu_torch/native/src/glia_forest.cc) behind
glia_tpu_torch.models.forest.train_forest, which draws each tree's
bootstrap counts and feature stream as sklearn 1.9 does.  Held here:

- one tree on one feature, on given integer sample weights, equals
  sklearn's DecisionTreeClassifier node for node (feature, float32
  threshold, children, leaf class, depth), also where values lie within
  1e-7 of each other and where many values tie;
- forests with mtry = D and max_depth 2 equal glia_tpu's node for node,
  balanced and not, on unbalanced labels;
- default forests on the 96^2 pipeline's BC samples: held-out error within
  0.03 of glia_tpu's, node counts and depths within 25 % of its means,
  every node reachable, each tree's leaves pure on its own bootstrap
  unless its rows cannot be told apart, independent of n_jobs (and, since
  the port draws sklearn's feature stream, equal to glia_tpu's node for
  node);
- a forest the port trained, handed to glia_tpu through its arrays, gives
  glia_tpu's vote fractions and glia_tpu's hmt_segment results on
  engine="host" and engine="device_bc" (143-wide features);
- hmt_train(classifier="rf") gives glia_tpu's forest;
- the legacy model format: files of glia_tpu's writer read to an equal
  forest, the port's writer gives glia_tpu's bytes, categorical models are
  refused.
"""

import struct

import numpy as np
import pytest
from sklearn.tree import DecisionTreeClassifier

import glia_tpu.models.forest as jf
import glia_tpu.models.rf_legacy as jl
import glia_tpu.pipeline as jp
import glia_tpu_torch.models.forest as tf
import glia_tpu_torch.models.rf_legacy as tl
import glia_tpu_torch.pipeline as tp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig
from glia_tpu.features.hierarchical import TreeFeatures
from glia_tpu.features.labels import bc_labels
from glia_tpu.graph.rag import build_rag
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.native import forest_train_native

FIELDS = ("feature", "threshold", "left", "right", "leaf_class")


def assert_same_forest(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.max_depth == want.max_depth
    assert got.n_classes == want.n_classes
    np.testing.assert_array_equal(got.classes, want.classes)


def to_glia_tpu(m):
    return jf.ForestModel(feature=m.feature, threshold=m.threshold,
                          left=m.left, right=m.right,
                          leaf_class=m.leaf_class, n_classes=m.n_classes,
                          max_depth=m.max_depth, classes=m.classes)


# ---------------------------------------------------------------------------
# one tree, node for node
# ---------------------------------------------------------------------------

def one_feature_case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 800
    if kind == "continuous":
        x = rng.normal(size=n)
    elif kind == "ties":
        x = rng.integers(0, 12, n).astype(np.float64)
    else:
        # clusters of values closer than 1e-7 (distinct in float32 near
        # 1e-3): a split never falls inside a cluster
        x = (1e-3 * rng.integers(1, 40, n)
             + 3e-8 * rng.integers(0, 3, n))
    y = np.where(np.sin(5 * x) + 0.4 * rng.normal(size=n) > 0, 1, -1)
    counts = rng.poisson(0.8, n).astype(np.int32)
    return x[:, None], y, counts


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["continuous", "ties", "within_1e-7"])
def test_one_tree_matches_decision_tree(kind, seed):
    X, y, counts = one_feature_case(kind, seed)
    if kind == "within_1e-7":
        x32 = np.sort(np.unique(X.astype(np.float32)))
        assert (np.diff(x32) <= 1e-7).any()
    sk = DecisionTreeClassifier(max_features=None, random_state=seed).fit(
        X, y, sample_weight=counts).tree_
    classes, y_idx = np.unique(y, return_inverse=True)
    (got,), depth = forest_train_native(
        X.astype(np.float32), y_idx, len(classes), counts[None, :],
        np.array([seed + 1], np.uint32), mtry=1)
    feature, threshold, left, right, leaf_class = got
    assert sk.node_count > 20
    np.testing.assert_array_equal(feature, sk.feature)
    np.testing.assert_array_equal(threshold,
                                  sk.threshold.astype(np.float32))
    np.testing.assert_array_equal(left, np.maximum(sk.children_left, 0))
    np.testing.assert_array_equal(right, np.maximum(sk.children_right, 0))
    np.testing.assert_array_equal(leaf_class,
                                  np.argmax(sk.value[:, 0, :], axis=1))
    assert depth[0] == sk.max_depth


def test_native_trainer_checks_its_arguments():
    X = np.zeros((4, 2), np.float32)
    y = np.array([0, 1, 0, 1])
    ok = dict(n_classes=2, counts=np.ones((1, 4), np.int32),
              seeds=np.ones(1, np.uint32), mtry=1)
    with pytest.raises(ValueError, match="class index"):
        forest_train_native(X, y + 1, **ok)
    with pytest.raises(ValueError, match=r"\[T, n\]"):
        forest_train_native(X, y, **{**ok, "counts": np.ones((1, 3))})
    with pytest.raises(ValueError, match="negative"):
        forest_train_native(X, y, **{**ok, "counts": -np.ones((1, 4))})
    with pytest.raises(ValueError, match="finite"):
        tf.train_forest(np.array([[0.0], [np.nan]]), [1, -1])
    with pytest.raises(ValueError, match="finite"):
        tf.train_forest(np.array([[0.0], [1e39]]), [1, -1])


# ---------------------------------------------------------------------------
# shallow forests: per-tree seeds, weighted bootstrap draws, Gini, thresholds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("balance_classes", [True, False])
def test_shallow_forest_matches_glia_tpu(balance_classes):
    rng = np.random.default_rng(7)
    n, D = 1200, 5
    X = rng.normal(size=(n, D))
    y = np.where(X[:, 0] + 0.5 * X[:, 1] + 0.7 * rng.normal(size=n) > 1.0,
                 -1, 1)
    assert 0.1 < (y == -1).mean() < 0.3
    kw = dict(mtry=D, max_depth=2, n_trees=20,
              balance_classes=balance_classes, seed=3)
    assert_same_forest(tf.train_forest(X, y, **kw),
                       jf.train_forest(X, y, **kw))


def test_bootstrap_draws_are_sklearns():
    """The counts behind each tree equal the draws sklearn's forest makes
    (the class counts at every root, weighted by them, equal sklearn's)."""
    from sklearn.ensemble import RandomForestClassifier

    rng = np.random.default_rng(8)
    X = rng.normal(size=(900, 4))
    y = np.where(rng.random(900) < 0.2, -1, 1)
    rf = RandomForestClassifier(n_estimators=5, max_samples=0.7,
                                class_weight="balanced", random_state=11,
                                max_depth=1).fit(X, y)
    _, y_idx, counts, seeds = tf.bootstrap_draws(y, 5, seed=11)
    for t, est in enumerate(rf.estimators_):
        want = est.tree_.value[0, 0] * est.tree_.weighted_n_node_samples[0]
        got = np.bincount(y_idx, weights=counts[t], minlength=2)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert seeds[t] == np.random.RandomState(est.random_state).randint(
            0, np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# default forests on the pipeline's BC samples
# ---------------------------------------------------------------------------

def bc_samples(seed, saliencies=True):
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=seed)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    order, sals = greedy_merge_native(rag, s["pb"], policy="median")
    cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
    X = TreeFeatures(rag, order, cfg,
                     saliencies=sals if saliencies else None).bc_features()
    y, _, _ = bc_labels(seg, s["truth"], order, rule="f1")
    return X, y


@pytest.fixture(scope="module")
def samples():
    train = [bc_samples(seed) for seed in (1, 2, 3)]
    X = np.concatenate([t[0] for t in train])
    y = np.concatenate([t[1] for t in train])
    assert X.shape[1] == 148 and np.isfinite(X).all()
    return X, y, bc_samples(5)


@pytest.fixture(scope="module")
def default_forests(samples):
    X, y, _ = samples
    return (tf.train_forest(X, y, n_trees=30, seed=0, n_jobs=1),
            jf.train_forest(X, y, n_trees=30, seed=0))


def real_nodes(m, t):
    return int(np.sum(m.feature[t] != -1))


def tree_depths(m):
    out = []
    for t in range(m.n_trees):
        depth = {0: 0}
        for n in range(real_nodes(m, t)):
            if m.feature[t, n] >= 0:
                for c in (m.left[t, n], m.right[t, n]):
                    depth[int(c)] = depth[n] + 1
        out.append(max(depth.values()))
    return np.array(out)


def test_default_forest_held_out_error(samples, default_forests):
    _, _, (Xh, yh) = samples
    port, ref = default_forests
    errors = []
    for m in (port, ref):
        p = tf.predict_label_fraction(m, Xh, label=-1)
        errors.append(float(np.mean((p > 0.5) != (yh == -1))))
    majority = min((yh == -1).mean(), (yh == 1).mean())
    assert errors[0] < majority
    assert abs(errors[0] - errors[1]) <= 0.03


def test_default_forest_structure(default_forests):
    port, ref = default_forests
    nodes = [np.array([real_nodes(m, t) for t in range(m.n_trees)])
             for m in (port, ref)]
    depths = [tree_depths(m) for m in (port, ref)]
    assert nodes[0].mean() > 5
    assert abs(nodes[0].mean() / nodes[1].mean() - 1) <= 0.25
    assert abs(depths[0].mean() / depths[1].mean() - 1) <= 0.25
    assert port.max_depth == depths[0].max()
    # the port draws sklearn's feature stream too: equal node for node
    assert_same_forest(port, ref)


def test_default_forest_every_node_reachable(default_forests):
    port, _ = default_forests
    for t in range(port.n_trees):
        n_real = real_nodes(port, t)
        # real nodes first, padding (feature -1) after them
        assert (port.feature[t, n_real:] == -1).all()
        seen, stack = set(), [0]
        while stack:
            n = stack.pop()
            seen.add(n)
            if port.feature[t, n] >= 0:
                stack += [int(port.left[t, n]), int(port.right[t, n])]
        assert seen == set(range(n_real))


def test_default_forest_leaves_pure_on_bootstrap(samples, default_forests):
    X, y, _ = samples
    port, _ = default_forests
    _, y_idx, counts, _ = tf.bootstrap_draws(y, port.n_trees, seed=0)
    X32 = X.astype(np.float32)
    for t in range(port.n_trees):
        rows = np.nonzero(counts[t])[0]
        node = np.zeros(len(rows), np.int64)
        for _ in range(port.max_depth + 1):
            f = port.feature[t, node]
            go = X32[rows, np.maximum(f, 0)] <= port.threshold[t, node]
            node = np.where(f < 0, node,
                            np.where(go, port.left[t, node],
                                     port.right[t, node]))
        for leaf in np.unique(node):
            at = rows[node == leaf]
            assert port.leaf_class[t, leaf] in y_idx[at]
            if len(np.unique(y_idx[at])) > 1:
                # only rows that no split can tell apart share a leaf
                span = X32[at].max(0) - X32[at].min(0)
                assert (span <= 1e-7).all()


def test_default_forest_independent_of_n_jobs(samples, default_forests):
    X, y, _ = samples
    port, _ = default_forests
    assert_same_forest(tf.train_forest(X, y, n_trees=30, seed=0, n_jobs=4),
                       port)


# ---------------------------------------------------------------------------
# a port-trained forest handed to glia_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["np", "jax"])
def test_port_forest_in_glia_tpu_gives_equal_fractions(samples,
                                                       default_forests,
                                                       backend):
    _, _, (Xh, _) = samples
    port, _ = default_forests
    want = jf.predict_label_fraction(to_glia_tpu(port), Xh, label=-1,
                                     backend=backend)
    got = tf.predict_label_fraction(
        port, Xh, label=-1, backend="np" if backend == "np" else "device",
        device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def bc_forest():
    """A port forest on the 143-wide BC features (no saliencies), the
    features engine="device_bc" scores."""
    train = [bc_samples(seed, saliencies=False) for seed in (1, 2, 3)]
    X = np.concatenate([t[0] for t in train])
    y = np.concatenate([t[1] for t in train])
    assert X.shape[1] == 143
    return tf.train_forest(X, y, n_trees=20, seed=0)


@pytest.mark.parametrize("engine,mode", [("host", "greedy"),
                                         ("host", "ccm"),
                                         ("device_bc", "greedy")])
def test_port_forest_in_glia_tpu_segments_alike(samples, default_forests,
                                                bc_forest, engine, mode):
    port = bc_forest if engine == "device_bc" else default_forests[0]
    s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=5)
    want_seg, want = jp.hmt_segment(s["pb"], s["intensity"],
                                    jp.HmtModel(forest=to_glia_tpu(port)),
                                    engine=engine, mode=mode)
    got_seg, got = tp.hmt_segment(s["pb"], s["intensity"],
                                  tp.HmtModel(forest=port), engine=engine,
                                  mode=mode, device="cpu")
    assert len(got["order"]) > 20
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got_seg, want_seg)


def test_hmt_train_rf_matches_glia_tpu():
    slices = [synthetic_em_slice(shape=(96, 96), n_cells=20, seed=seed)
              for seed in (1, 2)]
    stats = {}
    got = tp.hmt_train(slices, classifier="rf", n_trees=12, device="cpu",
                       stats=stats)
    want = jp.hmt_train(slices, classifier="rf", n_trees=12)
    assert got.kind == "rf" and got.feature_set == "full"
    assert_same_forest(got.forest, want.forest)
    assert stats["t_forest"] > 0


# ---------------------------------------------------------------------------
# legacy model format
# ---------------------------------------------------------------------------

def test_legacy_file_of_glia_tpu_reads_to_an_equal_forest(default_forests,
                                                          tmp_path):
    _, ref = default_forests
    path = tmp_path / "ref.bin"
    jl.write_legacy_model(path, jl.forest_to_legacy(ref))
    want_raw = jl.read_legacy_model(path)
    got_raw = tl.read_legacy_model(path)
    assert got_raw.keys() == want_raw.keys()
    for k, v in want_raw.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got_raw[k], v, err_msg=k)
        else:
            assert got_raw[k] == v, k
    got = tl.load_legacy_forest(path)
    assert_same_forest(got, jl.load_legacy_forest(path))
    X = np.random.default_rng(3).normal(size=(200, 148))
    np.testing.assert_array_equal(
        tf.predict_label_fraction(got, X, label=-1),
        jf.predict_label_fraction(ref, X, label=-1))


def test_legacy_writer_gives_glia_tpus_bytes(default_forests, tmp_path):
    port, _ = default_forests
    for mtry in (0, 7):
        tl.write_legacy_model(tmp_path / "port.bin",
                              tl.forest_to_legacy(port, mtry))
        jl.write_legacy_model(tmp_path / "ref.bin",
                              jl.forest_to_legacy(to_glia_tpu(port), mtry))
        assert ((tmp_path / "port.bin").read_bytes()
                == (tmp_path / "ref.bin").read_bytes())


def test_legacy_reader_refuses_categorical_models(tmp_path):
    blob = bytearray(520)
    # a non-empty orig_uniques vector header (begin=0, end=8)
    struct.pack_into("<qq", blob, 0, 0, 8)
    path = tmp_path / "cat.bin"
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="categorical"):
        tl.read_legacy_model(path)
    with pytest.raises(ValueError, match="categorical"):
        tl.load_legacy_forest(path)
