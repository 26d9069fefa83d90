"""How long glia_tpu's supervised MLP2 training and the port's stay
together, on the CPU in float64 (glia_tpu in x64, as its tests run it).

    python tests/test_torch_mlp_horizon.py [--steps 25 50 100 150 300 500]

Trains MLP2 (16, 8) with ``train_mlp_supervised`` (3 EM rounds of
``steps`` Adam steps, lr 0.05) on the BC features and f1 labels of two
96 x 96 synthetic sections, on both sides, and prints one JSON line per
``steps``: the largest weight gap relative to glia_tpu's largest weight,
for the port as it is (``torch.optim.Adam``) and for the port with an Adam
written in optax's order of operations (``OptaxOrderAdam``).  A first line
holds that optimizer against ``optax.adam`` itself over 200 steps of
random gradients.  The measurement asserts nothing; under pytest the
module runs only that first check, which must give optax's bits.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import glia_tpu.pipeline as jp  # noqa: E402
from glia_tpu.data.synthetic import synthetic_em_slice  # noqa: E402
from glia_tpu.features.config import FeatureConfig  # noqa: E402
from glia_tpu.features.hierarchical import TreeFeatures  # noqa: E402
from glia_tpu.features.labels import bc_labels  # noqa: E402
from glia_tpu.graph.rag import build_rag  # noqa: E402
from glia_tpu.models.train_ensemble import \
    train_mlp_supervised as j_train_mlp  # noqa: E402
from glia_tpu.native import greedy_merge_native  # noqa: E402
from glia_tpu_torch.learn import sshmt  # noqa: E402
from glia_tpu_torch.models.train_ensemble import \
    train_mlp_supervised  # noqa: E402


class OptaxOrderAdam(torch.optim.Optimizer):
    """optax.adam(lr) in optax's order of operations:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g*g + b2 nu,
    w + (-lr) * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(t=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                st["t"] += 1
                g = p.grad
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                mu_hat = st["mu"] / (1 - b1 ** st["t"])
                nu_hat = st["nu"] / (1 - b2 ** st["t"])
                p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))


def optax_order_check(n=200, d=50, lr=0.05):
    """OptaxOrderAdam against optax.adam on the same random gradients."""
    rng = np.random.default_rng(0)
    grads = rng.normal(0, 1, (n, d)) * rng.lognormal(0, 2, (n, 1))
    w0 = rng.normal(0, 1, d)
    opt = optax.adam(lr)
    w, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    p = torch.tensor(w0, requires_grad=True)
    tor = OptaxOrderAdam([p], lr=lr)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.tensor(g)
        tor.step()
    got, want = p.detach().numpy(), np.asarray(w)
    return {"steps": n, "identical": bool(np.array_equal(got, want)),
            "max_abs_gap": float(np.max(np.abs(got - want)))}


def test_optax_order_adam_is_optax_adam():
    assert optax_order_check()["identical"]


def samples():
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


def gap(w, ref):
    return float(np.max(np.abs(w - ref)) / np.max(np.abs(ref)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, nargs="+",
                    default=[25, 50, 100, 150, 300, 500])
    args = ap.parse_args()
    print(json.dumps({"optax_order_vs_optax": optax_order_check()}),
          flush=True)
    X, y = samples()
    torch_adam = sshmt.make_optimizer

    def optax_order(name, params, lr):
        if name == "adam":
            return OptaxOrderAdam(params, lr)
        return torch_adam(name, params, lr)

    for steps in args.steps:
        want = j_train_mlp(X, y, hidden=(16, 8), steps=steps)["w"]
        line = {"samples": list(X.shape), "steps_per_round": steps,
                "adam_steps": 3 * steps}
        for name, make in (("torch_adam", torch_adam),
                           ("optax_order_adam", optax_order)):
            sshmt.make_optimizer = make
            got = train_mlp_supervised(X, y, hidden=(16, 8), steps=steps,
                                       device="cpu")["w"]
            line[name] = gap(got, want)
        sshmt.make_optimizer = torch_adam
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
    os._exit(0)  # JAX's background threads may hold the exit
