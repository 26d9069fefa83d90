"""Logistic unit and 2-hidden-layer MLP in PyTorch (the port of
glia_tpu.models.mlp).

Functional parity with the reference's hand-written Eigen nets:
  - Logsig (code/alg/function.hxx:12-50): f = sigmoid(w . x); callers append
    the bias 1.0 to x themselves (main_pred_logsig.cxx:23).
  - MLP2 (code/alg/nn.hxx:14-134): h1 = relu(x^T W0); h2 = relu([h1,1] W1);
    f = sigmoid([h2,1] . w2).  Flat weight layout [W0 (D x N1, col-major),
    W1 ((N1+1) x N2, col-major), w2 (N2+1)] (nn.hxx:33,118-124), kept
    identical so weight vectors interchange with glia_tpu and the
    reference.

The ReLU is ``maximum(x, 0)`` as glia_tpu writes it, whose gradient at a
tie x == 0 is 0.5 in JAX and in torch.maximum alike; the reference zeroes
it there (nn.hxx:100-106).  The port follows glia_tpu, its yardstick.

Every function works on batches of tensors; ``torch.autograd`` gives the
training gradients.  The matrix products are ``torch.matmul``, as glia_tpu
leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def mlp2_unpack(w: torch.Tensor, D: int, N1: int, N2: int):
    """Views of the flat weights: W0 [D, N1], W1 [N1+1, N2], w2 [N2+1]."""
    w0 = w[: D * N1].reshape(N1, D).T          # col-major D x N1
    o = D * N1
    w1 = w[o: o + (N1 + 1) * N2].reshape(N2, N1 + 1).T
    o += (N1 + 1) * N2
    w2 = w[o: o + N2 + 1]
    return w0, w1, w2


def _relu(x: torch.Tensor) -> torch.Tensor:
    # torch.maximum, not torch.relu (gradient 0 at a tie) or clamp_min (1):
    # jnp.maximum(x, 0.0) gives 0.5 there
    return torch.maximum(x, x.new_zeros(()))


def mlp2_forward(w: torch.Tensor, X: torch.Tensor, D: int, N1: int,
                 N2: int) -> torch.Tensor:
    """Batched MLP2 forward: X [B, D] -> probabilities [B]."""
    w0, w1, w2 = mlp2_unpack(w, D, N1, N2)
    ones = X.new_ones((X.shape[0], 1))
    h1 = _relu(X @ w0)
    h2 = _relu(torch.cat([h1, ones], dim=1) @ w1)
    h3 = torch.cat([h2, ones], dim=1) @ w2
    # the stable sigmoid (jax.nn.sigmoid in glia_tpu): the naive form
    # backprops 0*inf = NaN once exp(-x) overflows
    return torch.sigmoid(h3)


def mlp2_init(D, N1, N2, seed=0, scale=None) -> np.ndarray:
    """He-style random init from numpy's default_rng(seed): the same stream
    as glia_tpu's, so both sides start from the same weights."""
    rng = np.random.default_rng(seed)
    if scale is None:
        scale = np.sqrt(2.0 / max(D, 1))
    w0 = rng.normal(0, scale, D * N1)
    w1 = rng.normal(0, np.sqrt(2.0 / (N1 + 1)), (N1 + 1) * N2)
    w2 = rng.normal(0, np.sqrt(2.0 / (N2 + 1)), N2 + 1)
    return np.concatenate([w0, w1, w2])


def mlp2_dim(D, N1, N2) -> int:
    return D * N1 + (N1 + 1) * N2 + N2 + 1


def logsig_forward(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Batched Logsig: X [B, D] (bias already appended) -> [B].  Kept in
    glia_tpu's naive 1/(1+exp) form: Logsig consumes min-max rescaled
    inputs, so exp(-x) does not overflow."""
    return 1.0 / (1.0 + torch.exp(-(X @ w)))


def append_bias(X: torch.Tensor) -> torch.Tensor:
    """[B, D] -> [B, D+1] with a last column of ones."""
    return torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)


class Logsig(nn.Module):
    """Logsig over one flat weight vector ``w`` [D] (bias included)."""

    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.as_tensor(w))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return logsig_forward(self.w, X)


class MLP2(nn.Module):
    """MLP2 over one flat weight vector in glia_tpu's layout
    (``mlp2_unpack``); ``w`` defaults to ``mlp2_init(D, N1, N2, seed)``."""

    def __init__(self, D: int, N1: int, N2: int, w=None, seed: int = 0,
                 device: Optional[torch.device] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.D, self.N1, self.N2 = D, N1, N2
        if w is None:
            w = mlp2_init(D, N1, N2, seed)
        w = torch.as_tensor(w, device=device, dtype=dtype)
        if w.shape != (mlp2_dim(D, N1, N2),):
            raise ValueError(f"MLP2({D}, {N1}, {N2}) takes "
                             f"{mlp2_dim(D, N1, N2)} weights, got "
                             f"{tuple(w.shape)}")
        self.w = nn.Parameter(w)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return mlp2_forward(self.w, X, self.D, self.N1, self.N2)
