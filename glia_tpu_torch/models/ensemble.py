"""Ensemble routing by feature threshold (the port of
glia_tpu.models.ensemble).

Reference: ThresholdModelDistributor (code/type/function.hxx:72-85), used to
route samples to one of three models by comparing the two region-area
features against a threshold (EnsembleRandomForest, code/alg/rf.hxx:63-123;
EnsembleMLP2v, code/alg/nn.hxx:191-255):

    x[dim1] < t -> model 0   (both regions small, since area0 <= area1)
    x[dim0] < t -> model 1   (mixed)
    else        -> model 2   (both large)
"""

from __future__ import annotations

import numpy as np


def distribute(X, dim0: int, dim1: int, threshold: float) -> np.ndarray:
    """Model index per sample (function.hxx:79-84)."""
    X = np.asarray(X)
    out = np.full(X.shape[0], 2, dtype=np.int64)
    out[X[:, dim0] < threshold] = 1
    out[X[:, dim1] < threshold] = 0
    return out


class ThresholdEnsemble:
    """Route each sample to one of N models' predict functions.  Keyword
    arguments of a call go to every model called (a forest member's
    ``backend`` and ``device``)."""

    def __init__(self, models, dim0, dim1, threshold):
        self.models = list(models)
        self.dim0, self.dim1, self.threshold = dim0, dim1, threshold

    def __call__(self, X, **kw):
        X = np.atleast_2d(np.asarray(X))
        idx = distribute(X, self.dim0, self.dim1, self.threshold)
        out = np.zeros(X.shape[0], dtype=np.float64)
        for mi, m in enumerate(self.models):
            sel = idx == mi
            if sel.any():
                out[sel] = np.asarray(m(X[sel], **kw))
        return out
