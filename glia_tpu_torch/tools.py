"""Sample tools (the port of glia_tpu.tools, trimmed to what the forest
ensemble calls)."""

from __future__ import annotations

import numpy as np

from .models.ensemble import distribute


def distribute_samples(feats, labels, dim0, dim1, threshold):
    """3-way split by area-feature thresholds for ensemble training
    (main_distribute_samples.cxx:20-37): group 0 if f[dim1] < t, 1 if
    f[dim0] < t, else 2."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    idx = distribute(feats, dim0, dim1, threshold)
    return [(feats[idx == k], labels[idx == k]) for k in range(3)]
