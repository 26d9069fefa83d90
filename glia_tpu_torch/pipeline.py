"""High-level HMT inference pipeline (PyTorch port).

The ported slice of glia_tpu.pipeline:

  watershed -> pre_merge -> RAG -> classifier-in-the-loop merge order on
  the device (BC features + forest scores every superstep) -> greedy tree
  resolution -> final segmentation -> eval (VI / adapted Rand)

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
from .graph.merge import apply_merge_order
from .graph.merge_bc_device import merge_order_bc_device
from .graph.rag import build_rag
from .graph.tree import build_tree, node_potentials
from .infer.greedy import resolve_tree_greedy
from .infer.segment import final_segmentation
from .metrics import eval_ri, eval_vi
from .models.forest import ForestModel, make_label_scorer
from .native import pre_merge_native, watershed_native

_NOT_PORTED = {
    "host": "engine='host' (serial C++ BC engine, glia_bc.cc) is not "
            "ported yet: ROADMAP.md, modules to port, item 4",
    "device": "engine='device' (pb-policy device merge, merge_device.py) "
              "is not ported yet: ROADMAP.md, modules to port, item 1",
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
    the device_bc engine scores)."""

    forest: ForestModel
    n_bins: int = 16
    boundary_thresholds: tuple = (0.2, 0.5, 0.8)


def hmt_segment(pb, intensity, model: HmtModel, watershed_level=0.05,
                pre_merge_size=30, mode="greedy", engine="device_bc",
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                stats: Optional[dict] = None):
    """Inference: watershed -> pre_merge -> classifier-in-the-loop merge
    order on the device -> tree resolution -> final label image.

    engine="device_bc" (the only engine ported): device feature assembly
    + forest scoring inside the merge loop, the counterpart of the
    reference's merge_order_bc (util/struct_merge_bc.hxx:10-58).
    ``device`` defaults to the CUDA card and raises without one; pass
    device="cpu" for the plain PyTorch path.  A ``stats`` dict receives
    the wall seconds of each stage (t_watershed, t_pre_merge, t_rag,
    t_build_state, t_merge_loop, t_tree_resolve, t_segmentation) and the
    merge loop's counters.

    Returns (segmentation, info dict with seg0, order, probs, n_picks)."""
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if engine != "device_bc":
        raise ValueError(engine)
    if mode == "ccm":
        raise NotImplementedError(_NOT_PORTED["ccm"])
    if mode != "greedy":
        raise ValueError(mode)
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

    cfg = FeatureConfig.standard(
        pb, intensity, n_bins=model.n_bins,
        boundary_thresholds=model.boundary_thresholds)
    scorer = make_label_scorer(model.forest, label=-1, device=dev)
    order, probs = merge_order_bc_device(rag, cfg, scorer, stats=st,
                                         device=dev, dtype=dtype)
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
