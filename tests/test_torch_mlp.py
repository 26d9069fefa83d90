"""The port's Logsig and MLP2 (models/mlp.py) against glia_tpu.models.mlp,
on the CPU in float64 on both sides.

Forward values and gradients: rtol 1e-12 (the same expression; matrix
products summed in another order).  The gradient at a ReLU tie (a hidden
pre-activation exactly 0) is glia_tpu's 0.5, not torch.relu's 0.  The flat
weight layout is glia_tpu's: the same vector gives the same network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glia_tpu.models import mlp as jmlp
from glia_tpu_torch.models import mlp

D, N1, N2 = 6, 5, 3


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def case(seed=0, B=40):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(0, 1, (B, D - 1)), np.ones((B, 1))], 1)
    return X, jmlp.mlp2_init(D, N1, N2, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mlp2_forward_and_gradient(seed):
    X, w0 = case(seed)

    def jloss(w, X):
        return jnp.sum(jmlp.mlp2_forward(w, X, D, N1, N2) ** 2)

    want = np.asarray(jmlp.mlp2_forward(jnp.asarray(w0), jnp.asarray(X),
                                        D, N1, N2))
    gw, gx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w0),
                                             jnp.asarray(X))
    w, x = t64(w0, grad=True), t64(X, grad=True)
    got = mlp.mlp2_forward(w, x, D, N1, N2)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("seed", [0, 1])
def test_logsig_forward_and_gradient(seed):
    X, _ = case(seed)
    w0 = np.random.default_rng(seed).normal(0, 0.5, D)
    want = np.asarray(jmlp.logsig_forward(jnp.asarray(w0), jnp.asarray(X)))
    g = jax.grad(lambda w: jnp.sum(jmlp.logsig_forward(w, jnp.asarray(X))))(
        jnp.asarray(w0))
    w = t64(w0, grad=True)
    got = mlp.logsig_forward(w, t64(X))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g), rtol=1e-12)


def test_relu_tie_gradient_is_one_half():
    """A first-layer unit whose pre-activation is exactly 0 on a sample:
    glia_tpu's jnp.maximum(x, 0.0) passes half the gradient there."""
    X = np.array([[1.0, -1.0, 0.5, 2.0, 0.0, 1.0]])
    w0 = np.full(mlp.mlp2_dim(D, N1, N2), 0.25)
    # unit 0 of W0 is column-major rows [0:D]: make x . W0[:, 0] == 0
    w0[:D] = [1.0, 1.0, 0.0, 0.0, 3.0, 0.0]
    W0, _, _ = mlp.mlp2_unpack(t64(w0), D, N1, N2)
    assert float((t64(X) @ W0)[0, 0]) == 0.0
    g = np.asarray(jax.grad(
        lambda w: jnp.sum(jmlp.mlp2_forward(w, jnp.asarray(X), D, N1, N2)))(
            jnp.asarray(w0)))
    w = t64(w0, grad=True)
    mlp.mlp2_forward(w, t64(X), D, N1, N2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), g, rtol=1e-12, atol=1e-15)
    # the half-gradient shows in unit 0's weights: X[0, j] * 0.5 * upstream
    w1 = w.detach().clone().requires_grad_(True)
    h = t64(X) @ mlp.mlp2_unpack(w1, D, N1, N2)[0]
    mlp._relu(h).sum().backward()
    assert w1.grad[:D].tolist() == (0.5 * X[0]).tolist()


def test_flat_layout_round_trip():
    w0 = np.arange(mlp.mlp2_dim(D, N1, N2), dtype=np.float64)
    got = [a.numpy() for a in mlp.mlp2_unpack(t64(w0), D, N1, N2)]
    want = [np.asarray(a) for a in jmlp.mlp2_unpack(jnp.asarray(w0), D, N1,
                                                    N2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # column-major: W0[i, j] is w[j * D + i]; the pieces tile the vector
    assert got[0][2, 3] == 3 * D + 2
    flat = np.concatenate([got[0].T.ravel(), got[1].T.ravel(), got[2]])
    np.testing.assert_array_equal(flat, w0)


def test_init_and_modules():
    np.testing.assert_array_equal(mlp.mlp2_init(D, N1, N2, seed=7),
                                  jmlp.mlp2_init(D, N1, N2, seed=7))
    assert mlp.mlp2_dim(D, N1, N2) == jmlp.mlp2_dim(D, N1, N2)
    X, w0 = case(3)
    net = mlp.MLP2(D, N1, N2, seed=3, dtype=torch.float64)
    assert [p.numel() for p in net.parameters()] == [len(w0)]
    np.testing.assert_array_equal(net.w.detach().numpy(), w0)
    want = jmlp.MLP2(D, N1, N2, seed=3)(X)
    np.testing.assert_allclose(net(t64(X)).detach().numpy(), want,
                               rtol=1e-12)
    ls = mlp.Logsig(t64(w0[:D]))
    np.testing.assert_allclose(
        ls(t64(X)).detach().numpy(),
        np.asarray(jmlp.logsig_forward(jnp.asarray(w0[:D]), jnp.asarray(X))),
        rtol=1e-12)
    with pytest.raises(ValueError, match="weights"):
        mlp.MLP2(D, N1, N2, w=w0[:-1])
    Xb = mlp.append_bias(t64(X[:, :-1]))
    np.testing.assert_array_equal(Xb.numpy(), jmlp.append_bias(X[:, :-1]))
