"""Merge-probability prediction (pred_logsig / pred_mlp / pred_rf), the
port of glia_tpu.learn.predict.

Reference semantics:
  - pred_logsig (code/sshmt/main_pred_logsig.cxx:23): append bias 1.0, then
    sigmoid(w . x);
  - pred_mlp (code/sshmt/main_pred_mlp.cxx:40-43): min-max rescale features
    to [-1, 1] using the training min/max table (stats::rescale,
    code/util/stats.hxx:264-283: (x-min)/(max-min+FEPS)), append bias;
  - pred_rf (code/ml/rf/main_pred_rf.cxx): vote fraction for the merge
    label (-1).

Rescaling runs on the host in float64; the classifiers run on ``device``
(the CUDA card by default) in ``dtype`` (float32 on CUDA, float64 on the
CPU unless given).  Each returns a numpy array [B].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import FEPS
from ..device import DeviceLike, default_dtype, resolve_device
from ..models.forest import ForestModel, predict_label_fraction
from ..models.mlp import append_bias, logsig_forward, mlp2_forward


def rescale_features(feats, minmax, out_min=-1.0, out_max=1.0):
    """stats::rescale (stats.hxx:264-283): out = (x-min)*(oMax-oMin)/
    (max-min+FEPS) + oMin.  minmax: [2, D] (row 0 min, row 1 max)."""
    feats = np.asarray(feats, dtype=np.float64)
    mn = np.asarray(minmax[0], dtype=np.float64)
    mx = np.asarray(minmax[1], dtype=np.float64)
    return (out_max - out_min) * (feats - mn) / (mx - mn + FEPS) + out_min


def feature_minmax(feats):
    feats = np.asarray(feats, dtype=np.float64)
    return np.stack([feats.min(axis=0), feats.max(axis=0)])


def _on(a, device: DeviceLike, dtype: Optional[torch.dtype]):
    dev = resolve_device(device)
    return torch.tensor(np.asarray(a), device=dev).to(
        default_dtype(dev, dtype))


def predict_logsig(w, feats, device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> np.ndarray:
    X = append_bias(_on(np.atleast_2d(feats), device, dtype))
    return logsig_forward(_on(w, device, dtype), X).cpu().numpy()


def predict_mlp2(w, feats, minmax, N1, N2, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None) -> np.ndarray:
    Xr = rescale_features(np.atleast_2d(feats), minmax)
    X = append_bias(_on(Xr, device, dtype))
    return mlp2_forward(_on(w, device, dtype), X, X.shape[1], N1,
                        N2).cpu().numpy()


def predict_rf(model: ForestModel, feats, merge_label=-1, backend="np",
               device: DeviceLike = None) -> np.ndarray:
    return predict_label_fraction(model, np.atleast_2d(feats),
                                  label=merge_label, backend=backend,
                                  device=device)
