"""Stack pipelines (PyTorch port of glia_tpu.pipeline3d): 3D HMT
(supervoxels) and LINK3D (per-slice 2D + linking).

Reference configs (BASELINE.json):
  - "3D HMT": one watershed/RAG/merge-tree over the whole volume
    (6-connectivity supervoxels);
  - "LINK3D": per-slice 2D HMT segmentations, cross-section region pairs
    scored by a link classifier, thresholded links grouped into 3D neurons.

A volume's feature vectors are wider than a section's
(``FeatureConfig.region_feat_dim(ndim)``), so the classifier of
``hmt3d_segment`` is trained on volumes: a forest trained on sections is
refused by its width.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike
from .features.config import FeatureConfig
from .link3d.link import (
    gen_region_pairs,
    group_region_profiles,
    link_by_threshold,
    sc_features,
    sc_labels,
)
from .models.forest import predict_label_fraction, train_forest
from .pipeline import HmtModel, hmt_segment


def hmt3d_segment(pb_volume, intensity_volume, model: HmtModel,
                  watershed_level=0.05, pre_merge_size=30, mode="greedy",
                  engine="host", backend="device", device: DeviceLike = None,
                  dtype: Optional[torch.dtype] = None,
                  stats: Optional[dict] = None):
    """3D HMT: the 2D pipeline applied to a volume (dimension is runtime).
    ``engine``, ``backend``, ``device``, ``dtype`` and ``stats`` as in
    pipeline.hmt_segment, except that a forest is walked on ``device`` by
    default (``backend="np"`` walks it on the host in float64)."""
    return hmt_segment(pb_volume, intensity_volume, model,
                       watershed_level=watershed_level,
                       pre_merge_size=pre_merge_size, mode=mode,
                       backend=backend, engine=engine, device=device,
                       dtype=dtype, stats=stats)


def _section_pairs(slices, seg_slices, z, n_bins):
    """Candidate pairs of sections z and z + 1 with their features."""
    s0, s1 = seg_slices[z], seg_slices[z + 1]
    cfg = FeatureConfig.standard(slices[z]["pb"], slices[z].get("intensity"),
                                 n_bins=n_bins)
    pairs, _ = gen_region_pairs(s0, s1, z, z + 1)
    if not pairs:
        return pairs, None
    return pairs, sc_features(s0, s1, cfg, pairs)


def link3d_train(slices, seg_slices, n_trees=100, seed=0, n_bins=8):
    """Train the section-link classifier from consecutive slice pairs.

    slices: dicts with pb / intensity / truth; seg_slices: 2D segmentations
    (e.g. hmt_segment outputs) aligned with them.  The forest is grown on
    the host on every core (it does not depend on the thread count).
    """
    X, y = [], []
    for z in range(len(slices) - 1):
        pairs, feats = _section_pairs(slices, seg_slices, z, n_bins)
        if not pairs:
            continue
        X.append(feats)
        labels, _, _ = sc_labels(seg_slices[z], slices[z]["truth"],
                                 seg_slices[z + 1], slices[z + 1]["truth"],
                                 pairs)
        y.append(labels)
    return train_forest(np.concatenate(X), np.concatenate(y),
                        n_trees=n_trees, seed=seed, n_jobs=-1)


def link3d_segment(slices, seg_slices, link_model, min_score=0.5,
                   force_link=True, n_bins=8, backend="device",
                   device: DeviceLike = None, stats: Optional[dict] = None):
    """Score consecutive-slice pairs, link, group into a 3D volume.
    ``backend`` picks the forest walk as in predict_label_fraction
    ("device", the default: the device walk on ``device``, the CUDA card
    by default; "np": host float64), one walk over every section pair's
    rows.  A ``stats``
    dict receives the number of pairs and links and the wall seconds of
    each stage (t_pairs_features, t_predict, t_link, t_group)."""
    st = stats if stats is not None else {}
    t = time.perf_counter()
    all_pairs, all_feats = [], []
    for z in range(len(slices) - 1):
        pairs, feats = _section_pairs(slices, seg_slices, z, n_bins)
        if not pairs:
            continue
        all_pairs += pairs
        all_feats.append(feats)
    st["t_pairs_features"] = time.perf_counter() - t
    t = time.perf_counter()
    scores = (predict_label_fraction(link_model, np.concatenate(all_feats),
                                     label=1, backend=backend, device=device)
              if all_feats else np.zeros(0))
    st["t_predict"] = time.perf_counter() - t
    t = time.perf_counter()
    links = link_by_threshold(all_pairs, scores, min_score, force_link)
    st["t_link"] = time.perf_counter() - t
    t = time.perf_counter()
    vol = group_region_profiles(seg_slices, list(range(len(slices))), links)
    st["t_group"] = time.perf_counter() - t
    st.update(pairs=len(all_pairs), links=len(links))
    return vol
