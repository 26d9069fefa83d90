"""Supervised classifier training (the port of
glia_tpu.models.train_ensemble): the area-threshold forest ensemble and
the supervised MLP2.

Reference flow (SURVEY.md section 2.7): distribute_samples splits training
rows three ways by the two region-area features vs a threshold
(code/gadget/main_distribute_samples.cxx:20-37), one RF/MLP trains per
group, and inference routes through ThresholdModelDistributor
(code/type/function.hxx:72-85).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..learn.predict import feature_minmax, rescale_features
from ..learn.sshmt import train_sshmt
from ..tools import distribute_samples
from .ensemble import ThresholdEnsemble
from .forest import predict_label_fraction, train_forest


def bc_area_feature_indices(cfg, ndim=2, with_saliency=True):
    """Column indices of region0/region1 area inside a BC feature vector
    (boundary block first, then region0 and region1 blocks; area is each
    region block's first element).  ``with_saliency`` must reflect how the
    features were built."""
    db = cfg.boundary_feat_dim(with_saliency=with_saliency)
    dr = cfg.region_feat_dim(ndim=ndim, with_saliency=with_saliency)
    return db, db + dr


def forest_ensemble(forests, dim0, dim1, threshold) -> ThresholdEnsemble:
    """A ThresholdEnsemble whose members are ``forests``' merge-vote
    fractions (label -1); a call's keyword arguments (``backend``,
    ``device``) go to predict_label_fraction.  The forests stay in
    ``.forests``."""
    def wrap(m):
        return lambda Z, **kw: predict_label_fraction(m, Z, label=-1, **kw)

    ens = ThresholdEnsemble([wrap(m) for m in forests], dim0, dim1,
                            threshold)
    ens.forests = list(forests)
    return ens


def train_forest_ensemble(X, y, dim0, dim1, threshold, n_trees=255,
                          seed=0, **kw):
    """Three forests split by area features; returns a ThresholdEnsemble
    whose members output merge-vote fractions."""
    groups = distribute_samples(X, y, dim0, dim1, threshold)
    models = []
    for gi, (gx, gy) in enumerate(groups):
        if len(gx) < 2 or len(np.unique(gy)) < 2:
            # degenerate group: fall back to a forest on all data
            m = train_forest(X, y, n_trees=n_trees, seed=seed + gi, **kw)
        else:
            m = train_forest(gx, gy, n_trees=n_trees, seed=seed + gi, **kw)
        models.append(m)
    return forest_ensemble(models, dim0, dim1, threshold)


def train_mlp_supervised(X, y, hidden=(10, 5), steps=500, lr=0.05,
                         seed=0, device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None,
                         stats: Optional[dict] = None):
    """Supervised MLP2 training on merge/split labels.

    The reference trains MLPs through the SSHMT machinery with the
    unsupervised weight off (wu=0); same here: quadratic loss against the
    label-target map, Adam.  Features are min-max rescaled to [-1,1]
    and bias-appended exactly as pred_mlp expects
    (main_pred_mlp.cxx:40-43).  Runs on ``device`` (the CUDA card by
    default) in ``dtype``; ``stats`` as in train_sshmt.

    Returns dict(w, minmax, n1, n2) compatible with learn.predict.predict_mlp2.
    """
    X = np.asarray(X, dtype=np.float64)
    minmax = feature_minmax(X)
    Xr = rescale_features(X, minmax)
    out = train_sshmt(
        [], [], Xr, y, classifier="mlp2", mlp_hidden=hidden, wu=0.0,
        n_sigma_update=3, inner_steps=steps, optimizer="adam", lr=lr,
        seed=seed, device=device, dtype=dtype, stats=stats)
    return {"w": out["w"], "minmax": minmax, "n1": hidden[0],
            "n2": hidden[1]}
