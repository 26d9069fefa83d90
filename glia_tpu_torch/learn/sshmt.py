"""SSHMT semi-supervised training in PyTorch (the port of
glia_tpu.learn.sshmt).

Reference pipeline (code/sshmt/main_train_sshmt_logsig.cxx,
code/sshmt/sshmt_util.hxx, code/sshmt/energy_function.hxx):

  E(w) = wr * ||w||^2 / 2
       + wu * ( ||Yu - DNF_w(paths)||^2 / (2 su^2) + Nu * log(su^2) / 2 )
       + ws * ( ||Ys - f_w(Xs)||^2   / (2 ss^2) + Ns * log(ss^2) / 2 )

with f = Logsig or MLP2 (merge probability), DNF = MonotonicDNF over
root-path samples (target = mergeTarget), Yu = pathTarget^len, and Ys from
the label->target map {+1 (split): 0.05, -1 (merge): 0.95}
(main_train_sshmt_logsig.cxx:37-45 defaults).

Training (main_train_sshmt_logsig.cxx:134-156): nSigmaUpdate outer EM
rounds; each round runs the inner optimizer then re-estimates the noise
variances as sigma^2 = ||Y-F||^2 / N, floored at minSigma2
(sshmt_util.hxx:140-145).

Paths of different lengths are grouped so each group is one dense
[P, len, D] tensor.  The groups are built on the host (numpy) and
uploaded once; the energy is a torch function of the flat weights, and
``torch.autograd`` gives its gradient.  The inner optimizers are
``torch.optim`` versions of glia_tpu's optax ones, made anew every EM round
as glia_tpu re-initialises its optax state.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, default_dtype, resolve_device, synchronize
from ..graph.tree import gen_merge_paths
from ..models.mlp import MLP2, Logsig, logsig_forward, mlp2_forward
from .dnf import monotonic_dnf, relaxed_monotonic_dnf, unique_dnf
from .samplers import ClassBatchSampler, UniformBatchSampler


@dataclass
class SshmtDefaults:
    """Hyper-parameters (main_train_sshmt_logsig.cxx:37-45)."""

    min_sigma2: float = 1e-6
    path_target: float = 1.0
    merge_target: float = 0.95
    max_path_length: int = 3
    min_path_length: int = 2
    pos_label_target: float = 0.05   # label +1 (split)
    neg_label_target: float = 0.95   # label -1 (merge)


def build_path_groups(order, merge_feats, defaults: SshmtDefaults,
                      append_bias=True):
    """PathInput equivalent (code/sshmt/input.hxx:11-60).

    merge_feats: [n_merges, D] boundary features per merge (order-aligned).
    Returns list of dicts {x: [P, len, D'], y: [P]} grouped by path length
    (numpy, float64).
    """
    merge_feats = np.asarray(merge_feats, dtype=np.float64)
    if append_bias:
        merge_feats = np.concatenate(
            [merge_feats, np.ones((len(merge_feats), 1))], axis=1)
    paths = gen_merge_paths(order, defaults.max_path_length,
                            defaults.min_path_length)
    groups: Dict[int, List] = {}
    for p in paths:
        groups.setdefault(len(p), []).append(p)
    out = []
    for length, plist in sorted(groups.items()):
        x = merge_feats[np.asarray(plist, dtype=np.int64)]  # [P, len, D']
        y = np.full(len(plist), defaults.path_target ** length)
        out.append({"x": x, "y": y, "len": length})
    return out


def build_supervised(feats, labels, defaults: SshmtDefaults,
                     append_bias=True):
    """SampleInput equivalent (input.hxx:63-104): features + targets from
    the label map (numpy, float64)."""
    feats = np.asarray(feats, dtype=np.float64)
    if append_bias:
        feats = np.concatenate([feats, np.ones((len(feats), 1))], axis=1)
    labels = np.asarray(labels)
    y = np.where(labels > 0, defaults.pos_label_target,
                 defaults.neg_label_target)
    return {"x": feats, "y": y.astype(np.float64)}


def make_classifier(kind="logsig", D=None, N1=None, N2=None):
    """Batched classifier fn(w, X [B, D]) -> [B]."""
    if kind == "logsig":
        return logsig_forward
    if kind == "mlp2":
        return lambda w, X: mlp2_forward(w, X, D, N1, N2)
    raise ValueError(kind)


DNF_KINDS = {
    "monotonic": lambda f, target: monotonic_dnf(f, target),
    "relaxed": lambda f, target: relaxed_monotonic_dnf(f),
    "unique": lambda f, target: unique_dnf(f, target),
}


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip is minimum(maximum(x, lo), hi): gradient 0.5 at either
    # bound, where torch.clamp gives 1
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def make_energy(classifier, path_groups, supervised, wr=1.0, wu=1.0,
                ws=1.0, merge_target=0.95, dnf="monotonic",
                sup_loss="gaussian", device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None):
    """Build E(w, su2, ss2) and its parts as torch functions of w.

    path_groups / supervised: numpy, from build_path_groups /
    build_supervised; uploaded here once to ``device`` (the CUDA card by
    default) in ``dtype`` (default_dtype of the device).
    sup_loss: "gaussian" -> MonotonicDnfGaussian (energy_function.hxx:77-137)
              "ce"       -> MonotonicDnfGaussianCrossEntropy (:12-72),
                            binary CE on the supervised term (sigma_s
                            ignored; targets clipped into (0,1))
    Returns (energy_fn, unsup_sq_loss_fn, sup_sq_loss_fn, n_unsup, n_sup).
    ``energy_fn(w, su2, ss2, sup=None)``: ``sup`` ({"x", "y"} tensors)
    replaces the supervised set for one call, as a minibatch does.
    The *_sq_loss functions return ||Y-F||^2 (for the sigma EM updates).
    """
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)

    def up(a):
        return torch.tensor(np.asarray(a), device=dev).to(dt)

    dnf_fn = DNF_KINDS[dnf]
    groups = [{"x": up(g["x"]), "y": up(g["y"]), "len": g["len"]}
              for g in path_groups]
    sup0 = ({"x": up(supervised["x"]), "y": up(supervised["y"])}
            if supervised is not None else None)
    n_unsup = sum(len(g["y"]) for g in groups)
    n_sup = len(sup0["y"]) if sup0 is not None else 0

    def unsup_sq_loss(w):
        total = 0.0
        for g in groups:
            P, L, D = g["x"].shape
            f = classifier(w, g["x"].reshape(P * L, D)).reshape(P, L)
            v = dnf_fn(f, merge_target)
            total = total + torch.sum((g["y"] - v) ** 2)
        return total

    def sup_sq_loss(w, sup=None):
        sup = sup0 if sup is None else sup
        if sup is None:
            return w.new_zeros(())
        p = classifier(w, sup["x"])
        return torch.sum((sup["y"] - p) ** 2)

    def sup_ce_loss(w, sup):
        p = _clip(classifier(w, sup["x"]), 1e-12, 1 - 1e-12)
        y = _clip(sup["y"], 1e-12, 1 - 1e-12)
        return -torch.sum(y * torch.log(p) + (1 - y) * torch.log(1 - p))

    def energy(w, su2, ss2, sup=None):
        sup = sup0 if sup is None else sup
        ns = len(sup["y"]) if sup is not None else 0
        e = wr * 0.5 * torch.sum(w * w)
        if n_unsup and wu:
            e = e + wu * (0.5 * unsup_sq_loss(w) / su2
                          + n_unsup * math.log(su2) / 2.0)
        if ns and ws:
            if sup_loss == "ce":
                e = e + ws * sup_ce_loss(w, sup)
            else:
                e = e + ws * (0.5 * sup_sq_loss(w, sup) / ss2
                              + ns * math.log(ss2) / 2.0)
        return e

    return energy, unsup_sq_loss, sup_sq_loss, n_unsup, n_sup


def make_optimizer(name, params, lr):
    """torch.optim versions of glia_tpu's optax choices: "adam" ->
    optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8), "momentum" ->
    optax.sgd(lr, momentum=0.9), anything else -> optax.sgd(lr)."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    return torch.optim.SGD(params, lr=lr)


def train_sshmt(merge_feats_per_image, orders, sup_feats, sup_labels,
                classifier="logsig", mlp_hidden=(10, 5), wr=1.0, wu=1.0,
                ws=1.0, n_sigma_update=10, inner_steps=100,
                optimizer="adam", lr=0.1, seed=0,
                defaults: Optional[SshmtDefaults] = None, verbose=False,
                sup_batch=0, balance_sup_batch=False, sup_loss="gaussian",
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                stats: Optional[dict] = None):
    """Full SSHMT training loop (EM over sigmas, torch.optim inner
    optimizer) on ``device`` (the CUDA card by default) in ``dtype``.

    merge_feats_per_image: list of [n_merges_i, D] arrays; orders: matching
    merge orders.  sup_feats/sup_labels: labeled boundary samples (+1 split
    / -1 merge).  sup_batch > 0 enables minibatch supervised epochs
    (UniformBatchSampler / ClassBatchSampler per alg/gd.hxx:86-157 +
    type/sampler.hxx).  A ``stats`` dict receives t_path_groups (host) and
    t_optimizer (the EM rounds, synchronised) in seconds, rounds, n_steps,
    and the final sigma_u and sigma_s.
    Returns dict with weights (numpy) and training history.
    """
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    st = stats if stats is not None else {}
    defaults = defaults or SshmtDefaults()
    t = time.perf_counter()
    groups: List[dict] = []
    for feats, order in zip(merge_feats_per_image, orders):
        groups += build_path_groups(order, feats, defaults)
    # merge groups of equal length across images
    merged: Dict[int, dict] = {}
    for g in groups:
        if g["len"] in merged:
            m = merged[g["len"]]
            m["x"] = np.concatenate([m["x"], g["x"]])
            m["y"] = np.concatenate([m["y"], g["y"]])
        else:
            merged[g["len"]] = dict(g)
    path_groups = [merged[k] for k in sorted(merged)]
    supervised = build_supervised(sup_feats, sup_labels, defaults) \
        if sup_feats is not None and len(sup_feats) else None
    st["t_path_groups"] = time.perf_counter() - t

    D = (path_groups[0]["x"].shape[-1] if path_groups
         else supervised["x"].shape[-1])
    if classifier == "logsig":
        net = Logsig(torch.zeros(D, dtype=dt, device=dev))
        clf = make_classifier("logsig")
    else:
        N1, N2 = mlp_hidden
        net = MLP2(D, N1, N2, seed=seed, device=dev, dtype=dt)
        clf = make_classifier("mlp2", D, N1, N2)

    energy, unsup_sq, sup_sq, n_u, n_s = make_energy(
        clf, path_groups, supervised, wr, wu, ws, defaults.merge_target,
        sup_loss=sup_loss, device=dev, dtype=dt)

    # optional supervised minibatching: the energy over the sampled batch
    # (paths stay full-batch as in the reference default)
    sampler = None
    if sup_batch and supervised is not None and sup_batch < n_s:
        if balance_sup_batch:
            sampler = ClassBatchSampler(
                np.where(np.asarray(sup_labels) > 0, 1, -1), sup_batch,
                seed)
        else:
            sampler = UniformBatchSampler(n_s, sup_batch, seed)
        sup_x = torch.as_tensor(supervised["x"], device=dev).to(dt)
        sup_y = torch.as_tensor(supervised["y"], device=dev).to(dt)

    def update_sigmas(su2, ss2):
        # sigma^2 = ||Y-F||^2 / N, floored (sshmt_util.hxx:140-145)
        with torch.no_grad():
            if n_u:
                su2 = max(defaults.min_sigma2, float(unsup_sq(net.w)) / n_u)
            if n_s:
                ss2 = max(defaults.min_sigma2, float(sup_sq(net.w)) / n_s)
        return su2, ss2

    synchronize(dev)
    t = time.perf_counter()
    su2, ss2 = update_sigmas(1.0, 1.0)
    history = []
    for round_i in range(n_sigma_update):
        opt = make_optimizer(optimizer, net.parameters(), lr)
        for _ in range(inner_steps):
            batch = None
            if sampler is not None:
                bi = torch.as_tensor(sampler.next_batch(), device=dev)
                batch = {"x": sup_x[bi], "y": sup_y[bi]}
            opt.zero_grad(set_to_none=True)
            e = energy(net.w, su2, ss2, batch)
            e.backward()
            opt.step()
            e = e.detach()
        # e: the energy of the round's last step, before its update
        su2, ss2 = update_sigmas(su2, ss2)
        history.append({"round": round_i, "energy": float(e),
                        "sigma_u": float(np.sqrt(su2)),
                        "sigma_s": float(np.sqrt(ss2))})
        if verbose:
            print(f"learn-{round_i + 1}: su={np.sqrt(su2):.4g} "
                  f"ss={np.sqrt(ss2):.4g} E={float(e):.4g}")
    w = net.w.detach().cpu().numpy()
    st["t_optimizer"] = time.perf_counter() - t
    st["rounds"], st["n_steps"] = n_sigma_update, n_sigma_update * inner_steps
    st["sigma_u"], st["sigma_s"] = float(np.sqrt(su2)), float(np.sqrt(ss2))
    return {"w": w, "sigma_u2": su2, "sigma_s2": ss2,
            "history": history, "classifier": classifier, "dim": D}
