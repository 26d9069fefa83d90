"""High-level HMT pipeline (PyTorch port of glia_tpu.pipeline).

Training, on the host up to the classifier:

  watershed -> pre_merge -> RAG -> host merge order (C++) -> merge-tree
  features + merge/split labels -> hmt_train(classifier="rf"): a random
  forest grown on the host by the port's CART trainer (C++);
  classifier="rf_ensemble": three forests routed by the region areas;
  classifier="mlp": MLP2 with Adam on the device; hmt_train_sshmt: SSHMT
  Logsig over the "simple" features on the device

Inference, ``hmt_segment``, ending in tree resolution (greedy or CCM) ->
final segmentation -> eval (VI / adapted Rand):

  engine="device_bc": watershed -> pre_merge -> RAG -> classifier-in-the-
  loop merge order on the device (BC features + forest scores every
  superstep)

  engine="device": watershed -> pre_merge -> RAG -> pb-policy merge order
  on the device (multi-phase engine) with exact saliencies -> host features of the merge tree
  -> merge probabilities from the classifier

  engine="host" (the default): the same with the serial C++ merge order
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .constants import sdivide
from .device import DeviceLike, resolve_device
from .features.config import FeatureConfig
from .features.hierarchical import TreeFeatures
from .features.labels import bc_labels
from .graph.merge import apply_merge_order, greedy_merge_order
from .graph.merge_bc_device import merge_order_bc_device
from .graph.merge_device import greedy_merge_device
from .graph.rag import build_rag
from .graph.tree import build_tree, node_potentials
from .infer.ccm import segment_ccm_picks
from .infer.greedy import resolve_tree_greedy
from .infer.segment import final_segmentation, relabel_image
from .learn.predict import (feature_minmax, predict_logsig, predict_mlp2,
                            rescale_features)
from .learn.sshmt import train_sshmt
from .metrics import eval_ri, eval_vi
from .models.forest import (ForestModel, make_label_scorer,
                            predict_label_fraction, train_forest)
from .models.train_ensemble import (bc_area_feature_indices, forest_ensemble,
                                    train_forest_ensemble,
                                    train_mlp_supervised)
from .native import greedy_merge_native, pre_merge_native, watershed_native
from .utils import profiling

KINDS = ("rf", "rf_ensemble", "mlp", "logsig")
FEATURE_SETS = ("full", "simple")
FOREST_ARRAYS = ("feature", "threshold", "left", "right", "leaf_class",
                 "n_classes", "max_depth", "classes")


def watershed(pb, level=0.0, relabel=False):
    """gadget/main_watershed.cxx equivalent (C++ priority flood);
    ``relabel`` numbers the regions 1, 2, ... by decreasing size."""
    seg = watershed_native(np.asarray(pb, dtype=np.float32), level)
    if relabel:
        seg = relabel_image(seg, 1)
    return seg


def pre_merge(labels, pb, size_thresholds=(50,), rpb_threshold=0.5,
              engine="native"):
    """gadget/main_pre_merge.cxx: greedily merge regions that are small
    (< thresholds[0]) or medium (< thresholds[1]) with high mean pb
    (mostly-membrane fragments), using pooled-mean saliency.

    engine="native" runs the C++ serial loop; engine="py" the Python heap
    engine with the condition as a callback (graph.merge), the parity
    oracle.  Returns the relabeled image after all permitted merges."""
    labels = np.asarray(labels)
    rag = build_rag(labels, contour_only=False)
    if engine == "native":
        order, _ = pre_merge_native(rag, pb, size_thresholds, rpb_threshold)
        return apply_merge_order(labels, order)
    if engine != "py":
        raise ValueError(f"pre_merge engine {engine!r} (native|py)")
    pbf = np.asarray(pb, dtype=np.float64).ravel()

    # per-region pb sums for the mean-pb condition, maintained over merges
    pb_sum = {}
    for i, k in enumerate(rag.keys):
        s, e = int(rag.region_ptr[i]), int(rag.region_ptr[i + 1])
        pb_sum[int(k)] = float(pbf[rag.region_pixels[s:e]].sum())

    t0 = size_thresholds[0]
    t1 = size_thresholds[1] if len(size_thresholds) > 1 else None

    def fcond(u, v, sizes, _cache):
        su, sv = sizes[u], sizes[v]
        k0, k1 = (u, v) if su <= sv else (v, u)
        s0, s1 = min(su, sv), max(su, sv)
        if s0 < t0:
            return True
        if t1 is not None:
            if s0 < t1 and sdivide(pb_sum[k0], s0, 0.0) > rpb_threshold:
                return True
            if s1 < t1 and sdivide(pb_sum[k1], s1, 0.0) > rpb_threshold:
                return True
        return False

    def on_merge(r0, r1, r2):
        pb_sum[r2] = pb_sum[r0] + pb_sum[r1]

    order, _ = greedy_merge_order(
        rag, pb, policy="mean", fcond=fcond, track_sizes=True,
        on_merge=on_merge)
    return apply_merge_order(labels, order)


@dataclass
class HmtModel:
    """Trained boundary classifier + feature configuration knobs
    (glia_tpu's HmtModel).

    kind: "rf" (``forest``), "rf_ensemble" (three forests routed by the
    region areas, main_merge_order_bc.cxx's ensemble path; ``extra`` =
    {ensemble: a ThresholdEnsemble with ``.forests``}), "mlp" (MLP2 with
    min-max rescale, pred_mlp semantics; ``extra`` = {w, minmax, n1, n2})
    or "logsig" (SSHMT Logsig; ``extra`` = {w, minmax[, history]}).
    feature_set: "full" (the BC vector) or "simple" (selectFeatures).
    ``policy`` is the pb statistic
    the merge order of engines "host" and "device" follows: the one the
    classifier was trained with."""

    forest: Optional[ForestModel]
    n_bins: int = 16
    boundary_thresholds: tuple = (0.2, 0.5, 0.8)
    policy: str = "median"
    kind: str = "rf"
    extra: Optional[dict] = None
    feature_set: str = "full"

    def predict_merge_prob(self, feats, backend="np",
                           device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None):
        """Merge probability per row of ``feats``.  Forests: vote fraction
        for label -1 (BC_LABEL_MERGE), ``backend`` as in
        predict_label_fraction (an ensemble's members each score the rows
        routed to them).  MLP2 and Logsig run on ``device`` (the CUDA card
        by default) in ``dtype``."""
        if self.kind == "rf":
            return predict_label_fraction(self.forest, feats, label=-1,
                                          backend=backend, device=device)
        m = self.extra
        if self.kind == "rf_ensemble":
            return m["ensemble"](feats, backend=backend, device=device)
        if self.kind == "mlp":
            return predict_mlp2(m["w"], feats, m["minmax"], m["n1"],
                                m["n2"], device=device, dtype=dtype)
        if self.kind == "logsig":
            if m.get("minmax") is not None:
                feats = rescale_features(feats, m["minmax"])
            return predict_logsig(m["w"], feats, device=device, dtype=dtype)
        raise ValueError(f"model kind {self.kind!r} ({'|'.join(KINDS)})")


def hmt_model_from_arrays(feature=None, threshold=None, left=None,
                          right=None, leaf_class=None, n_classes=None,
                          max_depth=None, classes=None, n_bins=16,
                          boundary_thresholds=(0.2, 0.5, 0.8),
                          policy="median", kind="rf", feature_set="full",
                          w=None, minmax=None, n1=None, n2=None,
                          forests=None, dim0=None, dim1=None,
                          ensemble_threshold=None,
                          n_features=None) -> HmtModel:
    """An HmtModel from the fields of glia_tpu's HmtModel passed as plain
    values and numpy arrays: for kind="rf" its forest's node arrays (the
    first eight arguments); for kind="rf_ensemble" its ensemble's three
    forests (``forests``: three mappings of those eight names to the
    member's arrays), the area columns ``dim0`` and ``dim1`` and the
    routing ``ensemble_threshold``; for kind="mlp" its extra's ``w``,
    ``minmax``, ``n1`` and ``n2``; for kind="logsig" ``w`` and
    ``minmax``.  Other kinds raise.  ``n_features`` (kind="rf", optional):
    the width the forest was trained on, which the walks then demand of
    their samples (glia_tpu's forests do not carry it)."""
    if kind not in KINDS:
        raise ValueError(f"model kind {kind!r} is not ported "
                         f"({'|'.join(KINDS)})")
    if feature_set not in FEATURE_SETS:
        raise ValueError(f"feature_set {feature_set!r} "
                         f"({'|'.join(FEATURE_SETS)})")
    tree_arrays = (feature, threshold, left, right, leaf_class, n_classes,
                   max_depth, classes)
    given = {"w": w, "minmax": minmax, "n1": n1, "n2": n2,
             "forests": forests, "dim0": dim0, "dim1": dim1,
             "ensemble_threshold": ensemble_threshold,
             "n_features": n_features,
             **dict(zip(FOREST_ARRAYS, tree_arrays))}
    takes = {"rf": FOREST_ARRAYS + ("n_features",),
             "mlp": ("w", "minmax", "n1", "n2"),
             "logsig": ("w", "minmax"),
             "rf_ensemble": ("forests", "dim0", "dim1",
                             "ensemble_threshold")}[kind]
    optional = {"logsig": ("minmax",), "rf": ("n_features",)}.get(kind, ())
    missing = [k for k in takes if given[k] is None and k not in optional]
    extra_args = [k for k, v in given.items()
                  if v is not None and k not in takes]
    if missing or extra_args:
        raise ValueError(f"kind={kind!r} takes {', '.join(takes)}"
                         f"{f' ({optional[0]} optional)' if optional else ''}"
                         "; "
                         f"missing {missing}, not taken {extra_args}")
    forest, extra = None, None
    if kind == "rf":
        forest = ForestModel.from_arrays(*tree_arrays, n_features=n_features)
    elif kind == "rf_ensemble":
        if len(forests) != 3:
            raise ValueError(f"an ensemble has 3 forests, got "
                             f"{len(forests)}")
        members = [ForestModel.from_arrays(*(f[k] for k in FOREST_ARRAYS))
                   for f in forests]
        extra = {"ensemble": forest_ensemble(
            members, int(dim0), int(dim1), float(ensemble_threshold))}
    else:
        extra = {"w": np.asarray(w, dtype=np.float64),
                 "minmax": (None if minmax is None
                            else np.asarray(minmax, dtype=np.float64))}
        if kind == "mlp":
            extra.update(n1=int(n1), n2=int(n2))
    return HmtModel(forest=forest, n_bins=int(n_bins),
                    boundary_thresholds=tuple(boundary_thresholds),
                    policy=policy, kind=kind, extra=extra,
                    feature_set=feature_set)


def _features_for(seg, pb, intensity, model_cfg, order, sals):
    cfg = FeatureConfig.standard(
        pb, intensity, n_bins=model_cfg.n_bins,
        boundary_thresholds=model_cfg.boundary_thresholds)
    rag = build_rag(seg, contour_only=False)
    tf = TreeFeatures(rag, order, cfg, saliencies=sals)
    if model_cfg.feature_set == "simple":
        return tf.simple_features()
    return tf.bc_features()


@contextlib.contextmanager
def _stage(st, key, name, add=False):
    """The block as span ``name``; its seconds go to ``st[key]`` (added to
    what is there with ``add``)."""
    with profiling.span(name) as sp:
        yield
    st[key] = (st.get(key, 0.0) if add else 0.0) + sp.seconds


def _training_slice(s, policy, watershed_level, pre_merge_size, cfg0, st):
    """One training slice's host stages: watershed -> pre_merge -> RAG ->
    serial merge order -> features.  Returns (seg, order, feats)."""
    with _stage(st, "t_segment", "train.segment", add=True):
        seg = watershed(s["pb"], watershed_level)
        if pre_merge_size:
            seg = pre_merge(seg, s["pb"], (pre_merge_size,))
        rag = build_rag(seg, contour_only=False)
        order, sals = greedy_merge_native(rag, s["pb"], policy=policy)
    with _stage(st, "t_features", "train.features", add=True):
        feats = _features_for(seg, s["pb"], s.get("intensity"), cfg0, order,
                              sals)
    return seg, order, feats


def _labels(seg, truth, order, rule, st):
    with _stage(st, "t_labels", "train.labels", add=True):
        labels, _, _ = bc_labels(seg, truth, order, rule=rule)
    return labels


def training_samples(slices, policy="median", rule="f1",
                     watershed_level=0.05, pre_merge_size=30, n_bins=16,
                     stats: Optional[dict] = None):
    """The (X [n, D], y [n]) that hmt_train trains on: per slice
    watershed -> pre_merge -> serial merge order -> BC features (with the
    saliency columns) + merge/split labels, pooled.  ``stats`` receives
    t_segment (everything up to the merge order), t_features and t_labels
    in seconds, summed over the slices."""
    st = stats if stats is not None else {}
    cfg0 = HmtModel(forest=None, n_bins=n_bins)
    X, y = [], []
    for s in slices:
        seg, order, feats = _training_slice(s, policy, watershed_level,
                                            pre_merge_size, cfg0, st)
        X.append(feats)
        y.append(_labels(seg, s["truth"], order, rule, st))
    return np.concatenate(X), np.concatenate(y)


def hmt_train(slices, policy="median", rule="f1", n_trees=100, seed=0,
              watershed_level=0.05, pre_merge_size=30,
              n_bins=16, classifier="rf",
              ensemble_threshold=None, mlp_hidden=(16, 8),
              device: DeviceLike = None,
              dtype: Optional[torch.dtype] = None,
              stats: Optional[dict] = None) -> HmtModel:
    """Train the boundary classifier over (pb, intensity, truth) slices.

    slices: sequence of dicts with keys pb, intensity, truth.
    Pipeline per slice: watershed -> pre_merge -> merge_order_pb ->
    bc_feat + bc_label (``training_samples``) -> pooled classifier
    training.  classifier: "rf" (a forest of ``n_trees`` trees,
    models.forest.train_forest) or "rf_ensemble" (three forests routed by
    the region areas at ``ensemble_threshold``, the median of the second
    area column when None), grown on the host on every core whatever
    ``device`` and ``dtype`` say; "mlp" (``mlp_hidden`` units, Adam) on
    ``device`` (the CUDA card by default) in ``dtype``.  ``stats`` receives the stage seconds of
    training_samples, of train_sshmt and, for forests, t_forest.
    """
    if classifier not in ("rf", "rf_ensemble", "mlp"):
        raise ValueError(f"classifier {classifier!r} (rf|rf_ensemble|mlp)")
    dev = resolve_device(device) if classifier == "mlp" else None
    st = stats if stats is not None else {}
    X, y = training_samples(slices, policy, rule, watershed_level,
                            pre_merge_size, n_bins, st)
    if classifier == "rf":
        with _stage(st, "t_forest", "train.forest"):
            forest = train_forest(X, y, n_trees=n_trees, seed=seed,
                                  n_jobs=-1)
        return HmtModel(forest=forest, n_bins=n_bins, policy=policy)
    if classifier == "rf_ensemble":
        cfg = FeatureConfig.standard(
            slices[0]["pb"], slices[0].get("intensity"), n_bins=n_bins)
        dim0, dim1 = bc_area_feature_indices(cfg)
        if ensemble_threshold is None:
            ensemble_threshold = float(np.median(X[:, dim1]))
        with _stage(st, "t_forest", "train.forest"):
            ens = train_forest_ensemble(X, y, dim0, dim1, ensemble_threshold,
                                        n_trees=n_trees, seed=seed,
                                        n_jobs=-1)
        return HmtModel(forest=None, n_bins=n_bins, policy=policy,
                        kind="rf_ensemble", extra={"ensemble": ens})
    m = train_mlp_supervised(X, y, hidden=mlp_hidden, seed=seed,
                             device=dev, dtype=dtype, stats=st)
    return HmtModel(forest=None, n_bins=n_bins, policy=policy,
                    kind="mlp", extra=m)


def sshmt_samples(labeled_slices, unlabeled_slices, policy="median",
                  rule="f1", watershed_level=0.05, pre_merge_size=30,
                  n_bins=16, label_fraction=1.0, seed=0,
                  stats: Optional[dict] = None) -> dict:
    """What hmt_train_sshmt trains on: the "simple" features of every
    slice's merges, min-max rescaled over all slices (``feats``, one array
    per slice, with ``orders``), and the labeled merges kept with
    probability ``label_fraction`` (``sup_X`` rescaled, ``sup_y``), and the
    ``minmax`` table.  ``stats`` as in training_samples."""
    st = stats if stats is not None else {}
    cfg0 = HmtModel(forest=None, n_bins=n_bins, feature_set="simple")
    sup_X, sup_y = [], []
    uns_feats, uns_orders = [], []
    rng = np.random.default_rng(seed)
    for s in labeled_slices:
        seg, order, feats = _training_slice(s, policy, watershed_level,
                                            pre_merge_size, cfg0, st)
        labels = _labels(seg, s["truth"], order, rule, st)
        keep = rng.random(len(labels)) < label_fraction
        sup_X.append(feats[keep])
        sup_y.append(labels[keep])
        uns_feats.append(feats)
        uns_orders.append(order)
    for s in unlabeled_slices:
        _, order, feats = _training_slice(s, policy, watershed_level,
                                          pre_merge_size, cfg0, st)
        uns_feats.append(feats)
        uns_orders.append(order)
    minmax = feature_minmax(np.concatenate(uns_feats))
    return {"feats": [rescale_features(f, minmax) for f in uns_feats],
            "orders": uns_orders,
            "sup_X": (rescale_features(np.concatenate(sup_X), minmax)
                      if sup_X else None),
            "sup_y": np.concatenate(sup_y) if sup_y else None,
            "minmax": minmax}


def hmt_train_sshmt(labeled_slices, unlabeled_slices, policy="median",
                    rule="f1", watershed_level=0.05, pre_merge_size=30,
                    n_bins=16, label_fraction=1.0, wr=1.0, wu=1.0, ws=1.0,
                    n_sigma_update=5, inner_steps=150, lr=0.2,
                    seed=0, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None,
                    stats: Optional[dict] = None) -> HmtModel:
    """Semi-supervised SSHMT training pipeline (BASELINE config #3).

    labeled_slices contribute (sparse) merge/split labels; unlabeled ones
    contribute root-path consistency constraints only.  The classifier is
    a Logsig over min-max rescaled selectFeatures "simple" features
    (the reference's SSHMT setup, main_train_sshmt_logsig.cxx), trained on
    ``device`` (the CUDA card by default) in ``dtype``.
    ``label_fraction`` subsamples the labeled merges to emulate sparse
    supervision.  ``stats`` receives the stage seconds of sshmt_samples
    and train_sshmt.
    """
    dev = resolve_device(device)
    st = stats if stats is not None else {}
    samples = sshmt_samples(labeled_slices, unlabeled_slices, policy, rule,
                            watershed_level, pre_merge_size, n_bins,
                            label_fraction, seed, st)
    out = train_sshmt(samples["feats"], samples["orders"], samples["sup_X"],
                      samples["sup_y"], classifier="logsig", wr=wr, wu=wu,
                      ws=ws, n_sigma_update=n_sigma_update,
                      inner_steps=inner_steps, lr=lr, seed=seed,
                      device=dev, dtype=dtype, stats=st)
    return HmtModel(forest=None, n_bins=n_bins, policy=policy,
                    kind="logsig", feature_set="simple",
                    extra={"w": out["w"], "minmax": samples["minmax"],
                           "history": out["history"]})


ENGINES = ("device_bc", "device", "host")


def hmt_segment(pb, intensity, model: HmtModel, watershed_level=0.05,
                pre_merge_size=30, mode="greedy", backend="np",
                engine="host", device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                stats: Optional[dict] = None):
    """Inference: watershed -> pre_merge -> merge order -> merge
    probabilities from the classifier -> tree resolution (``mode``:
    "greedy" or "ccm") -> final label image.

    engine="device_bc" (forest models on the full BC vector only): device
    feature assembly + forest scoring inside the merge loop, the
    counterpart of the reference's merge_order_bc
    (util/struct_merge_bc.hxx:10-58), which orders merges by classifier
    probability.  engine="device": the batched pb-policy merge order on
    the device (``model.policy``: mean, median or median_minsize) with
    exact merge-time saliencies, then host feature extraction over the
    merge tree and one batched scoring; its merge runs the multi-phase
    engine (mode="fused_ms").  engine="host" (the default): the same with
    the exact serial C++ merge order.  ``backend`` picks a forest's walk
    there, an ensemble's members' too ("np": host float64; "device": the
    device walk); MLP2 and Logsig models run on the device in ``dtype``.
    ``device`` defaults to the CUDA card and raises without one; pass
    device="cpu" for the plain PyTorch path.  A ``stats`` dict receives
    the wall seconds of each stage (t_watershed, t_pre_merge, t_rag,
    t_merge_loop, t_tree_resolve, t_segmentation; t_build_state for
    device_bc; t_features, t_predict for device and host; t_exact_saliency
    for device, whose mean policy, once its plan is known, runs merge and
    saliencies as one program timed as t_plan_program instead of the
    two) and the merge loop's counters.  The call is the span hmt.segment,
    each stage a span inside it (hmt.watershed ... hmt.segmentation; the
    device merge's own spans for engine="device").

    Returns (segmentation, info dict with seg0, order, probs, n_picks)."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} ({'|'.join(ENGINES)})")
    if mode not in ("greedy", "ccm"):
        raise ValueError(f"mode {mode!r} (greedy|ccm)")
    if engine == "device_bc":
        if model.kind != "rf":
            raise ValueError(
                "engine='device_bc' needs a forest model (kind='rf'); "
                f"got kind={model.kind!r}")
        if model.feature_set != "full":
            raise ValueError(
                "engine='device_bc' assembles the full BC feature vector "
                "on device; model.feature_set="
                f"{model.feature_set!r} is not supported -- use "
                "engine='host' or retrain with feature_set='full'")
    if engine == "device" and model.policy not in (
            "mean", "median", "median_minsize"):
        raise ValueError(
            f"device merge engine supports policies "
            f"'mean'|'median'|'median_minsize'; "
            f"model.policy={model.policy!r}")
    dev = resolve_device(device)
    st = stats if stats is not None else {}
    with profiling.span("hmt.segment"):
        with _stage(st, "t_watershed", "hmt.watershed"):
            seg = watershed(pb, watershed_level)
        with _stage(st, "t_pre_merge", "hmt.pre_merge"):
            if pre_merge_size:
                seg = pre_merge(seg, pb, (pre_merge_size,))
        with _stage(st, "t_rag", "hmt.rag"):
            rag = build_rag(seg, contour_only=False)

        if engine == "device_bc":
            cfg = FeatureConfig.standard(
                pb, intensity, n_bins=model.n_bins,
                boundary_thresholds=model.boundary_thresholds)
            scorer = make_label_scorer(model.forest, label=-1, device=dev)
            order, probs = merge_order_bc_device(rag, cfg, scorer, stats=st,
                                                 device=dev, dtype=dtype)
        else:
            if engine == "device":
                order, sals = greedy_merge_device(rag, pb, policy=model.policy,
                                                  stats=stats, device=dev,
                                                  dtype=dtype)
            else:
                with _stage(st, "t_merge_loop", "hmt.merge_loop"):
                    order, sals = greedy_merge_native(rag, pb,
                                                      policy=model.policy)
            with _stage(st, "t_features", "hmt.features"):
                feats = _features_for(seg, pb, intensity, model, order, sals)
            with _stage(st, "t_predict", "hmt.predict"):
                probs = model.predict_merge_prob(feats, backend=backend,
                                                 device=dev, dtype=dtype)
        with _stage(st, "t_tree_resolve", "hmt.tree_resolve"):
            tree = build_tree(order)
            if mode == "greedy":
                picks = resolve_tree_greedy(tree, node_potentials(tree, probs))
            else:
                picks = segment_ccm_picks(tree, probs)
        with _stage(st, "t_segmentation", "hmt.segmentation"):
            out = final_segmentation(seg, tree, picks)
        return out, {"seg0": seg, "order": order, "probs": probs,
                     "n_picks": len(picks)}


def evaluate(seg, truth):
    fs, fm, vi = eval_vi(seg, truth)
    prec, rec, err = eval_ri(seg, truth)
    return {"vi_split": fs, "vi_merge": fm, "vi": vi,
            "rand_precision": prec, "rand_recall": rec, "rand_error": err}
