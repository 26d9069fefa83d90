"""Supervised classifier training (the port of
glia_tpu.models.train_ensemble, its MLP part).

The forest ensemble (``train_forest_ensemble``) waits for a forest trainer
of the port's own: ROADMAP.md, modules to port, item 11.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..learn.predict import feature_minmax, rescale_features
from ..learn.sshmt import train_sshmt


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
