"""The port's SSHMT training (learn/dnf.py, learn/sshmt.py,
learn/samplers.py, learn/predict.py, models/train_ensemble.py) against
glia_tpu's, on the CPU in float64 on both sides (glia_tpu in x64, jitted,
as its own tests run it).

Inputs come from numpy seeds.  Tolerances:
- DNF values and gradients, energies and their gradients: rtol 1e-12
  (the same expression, summed in another order);
- trained weights: max |w - w_glia_tpu| <= 1e-6 * max |w_glia_tpu|, equal
  history length and each round's energy and sigmas to rtol 1e-9; the
  supervised MLP2 at 3 rounds of 50 steps to 1e-9.
  Each training case is one whose optimizer trajectory is stable, so that
  rounding differences stay small.  Under glia_tpu's supervised MLP2
  schedule (3 rounds of 500 Adam steps) the trajectory is chaotic on these
  inputs, and the two sides part after a few hundred steps: the gaps by
  steps a round, for torch.optim.Adam and for an Adam in optax's update
  order, are printed by ``python tests/test_torch_mlp_horizon.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glia_tpu.learn import dnf as jdnf
from glia_tpu.learn import samplers as jsamp
from glia_tpu.learn import sshmt as jsshmt
from glia_tpu.learn.predict import feature_minmax as j_minmax
from glia_tpu.learn.predict import predict_logsig as j_pred_logsig
from glia_tpu.learn.predict import predict_mlp2 as j_pred_mlp2
from glia_tpu.learn.predict import rescale_features as j_rescale
from glia_tpu.models.mlp import mlp2_init as j_mlp2_init
from glia_tpu.models.train_ensemble import \
    train_mlp_supervised as j_train_mlp
from glia_tpu_torch.learn import dnf, samplers, sshmt
from glia_tpu_torch.learn.predict import (feature_minmax, predict_logsig,
                                          predict_mlp2, rescale_features)
from glia_tpu_torch.models.train_ensemble import train_mlp_supervised

W_RTOL = 1e-6


def weight_gap(w, ref):
    return np.max(np.abs(w - ref)) / np.max(np.abs(ref))


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


DNFS = {
    "monotonic": (lambda f: jdnf.monotonic_dnf(f, 0.95),
                  lambda f: dnf.monotonic_dnf(f, 0.95)),
    "relaxed": (jdnf.relaxed_monotonic_dnf, dnf.relaxed_monotonic_dnf),
    "unique": (lambda f: jdnf.unique_dnf(f, 0.9),
               lambda f: dnf.unique_dnf(f, 0.9)),
}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(DNFS))
def test_dnf_value_and_gradient(kind, n):
    jfn, tfn = DNFS[kind]
    f = np.random.default_rng(n).random((7, n))
    want = np.asarray(jfn(jnp.asarray(f)))
    want_g = np.asarray(jax.grad(lambda x: jfn(x).sum())(jnp.asarray(f)))
    x = t64(f, grad=True)
    got = tfn(x)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-12,
                               atol=1e-15)


def chain_case(n=60, seed=0, D=2):
    """glia_tpu's test_train_sshmt_learns inputs: features in R^D, labels
    from a logistic truth, a chain merge order so that paths exist."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, D))
    true_p = 1 / (1 + np.exp(-(3 - 6 * X[:, 0])))
    labels = np.where(true_p > 0.5, -1, 1)
    order = np.array([[i + 1, n + 10 + i, n + 11 + i] for i in range(n - 1)])
    return X, labels, order


def test_path_groups_and_supervised_match():
    X, labels, order = chain_case()
    d = sshmt.SshmtDefaults()
    got = sshmt.build_path_groups(order, X[:-1], d)
    want = jsshmt.build_path_groups(order, X[:-1], jsshmt.SshmtDefaults())
    assert [g["len"] for g in got] == [g["len"] for g in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])
    s = sshmt.build_supervised(X, labels, d)
    w = jsshmt.build_supervised(X, labels, jsshmt.SshmtDefaults())
    np.testing.assert_array_equal(s["x"], w["x"])
    np.testing.assert_array_equal(s["y"], w["y"])


@pytest.mark.parametrize("sup_loss", ["gaussian", "ce"])
@pytest.mark.parametrize("classifier", ["logsig", "mlp2"])
def test_make_energy_value_and_gradient(classifier, sup_loss):
    X, labels, order = chain_case(n=40, seed=3, D=4)
    d = sshmt.SshmtDefaults()
    groups = sshmt.build_path_groups(order, X[:-1], d)
    sup = sshmt.build_supervised(X, labels, d)
    D = sup["x"].shape[1]
    if classifier == "logsig":
        w0 = np.random.default_rng(5).normal(0, 1, D)
        args = ()
    else:
        w0 = j_mlp2_init(D, 5, 3, seed=2)
        args = (D, 5, 3)
    je = jsshmt.make_energy(jsshmt.make_classifier(classifier, *args),
                            groups, sup, 0.7, 0.8, 1.3, sup_loss=sup_loss)
    te = sshmt.make_energy(sshmt.make_classifier(classifier, *args), groups,
                           sup, 0.7, 0.8, 1.3, sup_loss=sup_loss,
                           device="cpu")
    assert (te[3], te[4]) == (je[3], je[4])
    e, g = jax.value_and_grad(je[0])(jnp.asarray(w0), 0.3, 0.2)
    w = t64(w0, grad=True)
    got = te[0](w, 0.3, 0.2)
    got.backward()
    assert got.item() == pytest.approx(float(e), rel=1e-12)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(g)).max())
    for jf, tf in ((je[1], te[1]), (je[2], te[2])):
        assert float(tf(t64(w0))) == pytest.approx(float(jf(w0)), rel=1e-12)


def test_make_energy_batch_replaces_the_supervised_set():
    X, labels, order = chain_case(n=40, seed=3)
    d = sshmt.SshmtDefaults()
    groups = sshmt.build_path_groups(order, X[:-1], d)
    sup = sshmt.build_supervised(X, labels, d)
    part = {k: v[:9] for k, v in sup.items()}
    clf = sshmt.make_classifier("logsig")
    full = sshmt.make_energy(clf, groups, sup, device="cpu")[0]
    small = sshmt.make_energy(clf, groups, part, device="cpu")[0]
    w = t64(np.linspace(-1, 1, 3))
    batch = {k: t64(v) for k, v in part.items()}
    assert float(full(w, 0.5, 0.4, batch)) == float(small(w, 0.5, 0.4))


TRAININGS = {
    "adam": dict(optimizer="adam", lr=0.2),
    "momentum": dict(optimizer="momentum", lr=0.01),
    "sgd": dict(optimizer="sgd", lr=0.01),
    "mlp2_adam": dict(classifier="mlp2", mlp_hidden=(5, 3), lr=0.2,
                      inner_steps=50),
    "uniform_batch": dict(sup_batch=16, lr=0.2),
    "class_batch": dict(sup_batch=16, balance_sup_batch=True, lr=0.2),
    "mlp2_uniform_batch": dict(classifier="mlp2", mlp_hidden=(5, 3),
                               sup_batch=16, lr=0.2, inner_steps=50),
    "ce": dict(sup_loss="ce", lr=0.3, wu=0.2),
    "wu0": dict(wu=0.0, lr=0.2),
    "mlp2_wu0": dict(classifier="mlp2", mlp_hidden=(4, 2), wu=0.0,
                     lr=0.05),
}


@pytest.mark.parametrize("name", sorted(TRAININGS))
def test_train_sshmt_matches_glia_tpu(name):
    X, labels, order = chain_case()
    kw = dict(n_sigma_update=3, inner_steps=80)
    kw.update(TRAININGS[name])
    want = jsshmt.train_sshmt([X[:-1]], [order], X, labels, **kw)
    got = sshmt.train_sshmt([X[:-1]], [order], X, labels, device="cpu",
                            **kw)
    assert got["w"].dtype == np.float64
    assert weight_gap(got["w"], want["w"]) <= W_RTOL
    assert len(got["history"]) == len(want["history"]) == \
        kw["n_sigma_update"]
    for g, w in zip(got["history"], want["history"]):
        assert g["round"] == w["round"]
        for k in ("energy", "sigma_u", "sigma_s"):
            assert g[k] == pytest.approx(w[k], rel=1e-9)
    assert (got["dim"], got["classifier"]) == (want["dim"],
                                               want["classifier"])


def test_train_sshmt_stats_and_device_policy(monkeypatch):
    X, labels, order = chain_case()
    st = {}
    out = sshmt.train_sshmt([X[:-1]], [order], X, labels, n_sigma_update=2,
                            inner_steps=7, device="cpu", stats=st)
    assert st["n_steps"] == 14
    assert st["t_optimizer"] > 0 and st["t_path_groups"] >= 0
    assert st["sigma_u"] == out["history"][-1]["sigma_u"]
    assert st["sigma_s"] == out["history"][-1]["sigma_s"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sshmt.train_sshmt([X[:-1]], [order], X, labels)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mlp_supervised(X, labels, steps=1)


@pytest.fixture(scope="module")
def mlp_samples():
    """Supervised samples (BC features and labels) of two 96² slices."""
    import glia_tpu.pipeline as jp
    from glia_tpu.data.synthetic import synthetic_em_slice
    from glia_tpu.features.config import FeatureConfig
    from glia_tpu.features.hierarchical import TreeFeatures
    from glia_tpu.features.labels import bc_labels
    from glia_tpu.graph.rag import build_rag
    from glia_tpu.native import greedy_merge_native

    X, y = [], []
    for seed in (11, 12):
        s = synthetic_em_slice(shape=(96, 96), n_cells=20, seed=seed)
        seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
        rag = build_rag(seg, contour_only=False)
        order, sals = greedy_merge_native(rag, s["pb"], policy="median")
        cfg = FeatureConfig.standard(s["pb"], s["intensity"], n_bins=16)
        X.append(TreeFeatures(rag, order, cfg, saliencies=sals)
                 .bc_features())
        y.append(bc_labels(seg, s["truth"], order, rule="f1")[0])
    return np.concatenate(X), np.concatenate(y)


def test_train_mlp_supervised_matches_glia_tpu(mlp_samples):
    """glia_tpu's MLP2 (16, 8) at 3 rounds of 50 Adam steps, where the
    trajectory is still stable: weights within 1e-9 of the largest."""
    X, y = mlp_samples
    want = j_train_mlp(X, y, hidden=(16, 8), steps=50)
    got = train_mlp_supervised(X, y, hidden=(16, 8), steps=50,
                               device="cpu")
    assert (got["n1"], got["n2"]) == (16, 8)
    np.testing.assert_array_equal(got["minmax"], want["minmax"])
    assert weight_gap(got["w"], want["w"]) <= 1e-9


def test_predict_functions_match(mlp_samples):
    X, _ = mlp_samples
    mm = feature_minmax(X)
    np.testing.assert_array_equal(mm, j_minmax(X))
    np.testing.assert_array_equal(rescale_features(X, mm), j_rescale(X, mm))
    D = X.shape[1] + 1
    w = j_mlp2_init(D, 16, 8, seed=4)
    np.testing.assert_allclose(predict_mlp2(w, X, mm, 16, 8, device="cpu"),
                               j_pred_mlp2(w, X, mm, 16, 8), rtol=1e-12)
    ws = np.random.default_rng(2).normal(0, 0.3, D)
    Xr = rescale_features(X, mm)
    got = predict_logsig(ws, Xr, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, j_pred_logsig(ws, Xr), rtol=1e-12)
    assert predict_logsig(ws, Xr, device="cpu",
                          dtype=torch.float32).dtype == np.float32


def test_samplers_copy_the_streams():
    labels = np.random.default_rng(1).integers(0, 2, 53) * 2 - 1
    pairs = [(samplers.UniformBatchSampler(53, 16, 3),
              jsamp.UniformBatchSampler(53, 16, 3)),
             (samplers.ClassBatchSampler(labels, 10, 3),
              jsamp.ClassBatchSampler(labels, 10, 3))]
    for got, want in pairs:
        for _ in range(12):
            np.testing.assert_array_equal(got.next_batch(),
                                          want.next_batch())
