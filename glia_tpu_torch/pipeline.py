"""High-level HMT inference pipeline (PyTorch port).

The ported slices of glia_tpu.pipeline, both ending in greedy tree
resolution -> final segmentation -> eval (VI / adapted Rand):

  engine="device_bc": watershed -> pre_merge -> RAG -> classifier-in-the-
  loop merge order on the device (BC features + forest scores every
  superstep)

  engine="device": watershed -> pre_merge -> RAG -> pb-policy merge order
  on the device with exact saliencies -> host BC features of the merge
  tree -> forest probabilities

The other engines and modes of glia_tpu's ``hmt_segment`` are not ported
yet; asking for them raises NotImplementedError naming the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .features.config import FeatureConfig
from .features.hierarchical import TreeFeatures
from .graph.merge import apply_merge_order
from .graph.merge_bc_device import merge_order_bc_device
from .graph.merge_device import greedy_merge_device
from .graph.rag import build_rag
from .graph.tree import build_tree, node_potentials
from .infer.greedy import resolve_tree_greedy
from .infer.segment import final_segmentation
from .metrics import eval_ri, eval_vi
from .models.forest import (ForestModel, make_label_scorer,
                            predict_label_fraction)
from .native import pre_merge_native, watershed_native

_NOT_PORTED = {
    "host": "engine='host' (serial C++ BC engine, glia_bc.cc) is not "
            "ported yet: ROADMAP.md, modules to port, item 4",
    "ccm": "mode='ccm' (CCM tree resolution) is not ported yet: "
           "ROADMAP.md, modules to port, item 3",
}


def watershed(pb, level=0.0):
    """gadget/main_watershed.cxx equivalent (C++ priority flood)."""
    return watershed_native(np.asarray(pb, dtype=np.float32), level)


def pre_merge(labels, pb, size_thresholds=(50,), rpb_threshold=0.5):
    """gadget/main_pre_merge.cxx: greedily merge regions that are small
    (< thresholds[0]) or medium (< thresholds[1]) with high mean pb, using
    pooled-mean saliency (C++ serial loop).  Returns the relabeled image."""
    labels = np.asarray(labels)
    rag = build_rag(labels, contour_only=False)
    order, _ = pre_merge_native(rag, pb, size_thresholds, rpb_threshold)
    return apply_merge_order(labels, order)


@dataclass
class HmtModel:
    """Trained boundary forest + feature configuration knobs (glia_tpu's
    HmtModel with kind="rf" and the full BC feature set, the only kind
    ported).  ``policy`` is the pb statistic the merge order of
    engine="device" follows: the one the forest was trained with."""

    forest: ForestModel
    n_bins: int = 16
    boundary_thresholds: tuple = (0.2, 0.5, 0.8)
    policy: str = "median"

    def predict_merge_prob(self, feats, backend="np",
                           device: DeviceLike = None):
        """Merge probability = vote fraction for label -1
        (BC_LABEL_MERGE); ``backend`` as in predict_label_fraction."""
        return predict_label_fraction(self.forest, feats, label=-1,
                                      backend=backend, device=device)


def hmt_model_from_arrays(feature, threshold, left, right, leaf_class,
                          n_classes, max_depth, classes, n_bins=16,
                          boundary_thresholds=(0.2, 0.5, 0.8),
                          policy="median", kind="rf",
                          feature_set="full") -> HmtModel:
    """An HmtModel from the fields of glia_tpu's HmtModel passed as plain
    values and numpy arrays (its forest's node arrays first).  Only
    kind="rf" with feature_set="full" is ported; anything else raises."""
    if kind != "rf":
        raise ValueError(f"model kind {kind!r} is not ported (rf)")
    if feature_set != "full":
        raise ValueError(f"feature_set {feature_set!r} is not ported (full)")
    forest = ForestModel.from_arrays(feature, threshold, left, right,
                                     leaf_class, n_classes, max_depth,
                                     classes)
    return HmtModel(forest=forest, n_bins=int(n_bins),
                    boundary_thresholds=tuple(boundary_thresholds),
                    policy=policy)


def _features_for(seg, pb, intensity, model_cfg, order, sals):
    cfg = FeatureConfig.standard(
        pb, intensity, n_bins=model_cfg.n_bins,
        boundary_thresholds=model_cfg.boundary_thresholds)
    rag = build_rag(seg, contour_only=False)
    return TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()


def hmt_segment(pb, intensity, model: HmtModel, watershed_level=0.05,
                pre_merge_size=30, mode="greedy", backend="np",
                engine="device_bc", device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                stats: Optional[dict] = None):
    """Inference: watershed -> pre_merge -> merge order -> merge
    probabilities from the forest -> tree resolution -> final label image.

    engine="device_bc": device feature assembly + forest scoring inside
    the merge loop, the counterpart of the reference's merge_order_bc
    (util/struct_merge_bc.hxx:10-58), which orders merges by classifier
    probability.  engine="device": the batched pb-policy merge order on
    the device (``model.policy``: mean, median or median_minsize) with
    exact merge-time saliencies, then host feature extraction over the
    merge tree and one batched forest scoring; ``backend`` picks the
    forest walk there ("np": host float64; "device": the device walk).
    ``device`` defaults to the CUDA card and raises without one; pass
    device="cpu" for the plain PyTorch path.  A ``stats`` dict receives
    the wall seconds of each stage (t_watershed, t_pre_merge, t_rag,
    t_merge_loop, t_tree_resolve, t_segmentation; t_build_state for
    device_bc; t_exact_saliency, t_features, t_predict for device) and the
    merge loop's counters.

    Returns (segmentation, info dict with seg0, order, probs, n_picks)."""
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if engine not in ("device_bc", "device"):
        raise ValueError(engine)
    if mode == "ccm":
        raise NotImplementedError(_NOT_PORTED["ccm"])
    if mode != "greedy":
        raise ValueError(mode)
    if engine == "device" and model.policy not in (
            "mean", "median", "median_minsize"):
        raise ValueError(
            f"device merge engine supports policies "
            f"'mean'|'median'|'median_minsize'; "
            f"model.policy={model.policy!r}")
    dev = resolve_device(device)
    st = stats if stats is not None else {}

    t = time.perf_counter()
    seg = watershed(pb, watershed_level)
    st["t_watershed"] = time.perf_counter() - t
    t = time.perf_counter()
    if pre_merge_size:
        seg = pre_merge(seg, pb, (pre_merge_size,))
    st["t_pre_merge"] = time.perf_counter() - t
    t = time.perf_counter()
    rag = build_rag(seg, contour_only=False)
    st["t_rag"] = time.perf_counter() - t

    if engine == "device_bc":
        cfg = FeatureConfig.standard(
            pb, intensity, n_bins=model.n_bins,
            boundary_thresholds=model.boundary_thresholds)
        scorer = make_label_scorer(model.forest, label=-1, device=dev)
        order, probs = merge_order_bc_device(rag, cfg, scorer, stats=st,
                                             device=dev, dtype=dtype)
    else:
        order, sals = greedy_merge_device(rag, pb, policy=model.policy,
                                          stats=st, device=dev, dtype=dtype)
        t = time.perf_counter()
        feats = _features_for(seg, pb, intensity, model, order, sals)
        st["t_features"] = time.perf_counter() - t
        t = time.perf_counter()
        probs = model.predict_merge_prob(feats, backend=backend, device=dev)
        st["t_predict"] = time.perf_counter() - t
    t = time.perf_counter()
    tree = build_tree(order)
    picks = resolve_tree_greedy(tree, node_potentials(tree, probs))
    st["t_tree_resolve"] = time.perf_counter() - t
    t = time.perf_counter()
    out = final_segmentation(seg, tree, picks)
    st["t_segmentation"] = time.perf_counter() - t
    return out, {"seg0": seg, "order": order, "probs": probs,
                 "n_picks": len(picks)}


def evaluate(seg, truth):
    fs, fm, vi = eval_vi(seg, truth)
    prec, rec, err = eval_ri(seg, truth)
    return {"vi_split": fs, "vi_merge": fm, "vi": vi,
            "rand_precision": prec, "rand_recall": rec, "rand_error": err}
