"""Per-group pixel statistics.

Copy of glia_tpu.features.hierarchical.group_stats: the leaf-region and
directed-boundary records of the device BC engine start from it.
"""

from __future__ import annotations

import numpy as np

from .._histutil import hist_bin_index as _hist_bin_index  # shared binning

NEG_INF = -np.inf
POS_INF = np.inf


def group_stats(values, group_ids, n_groups, n_bins=0, hist_range=(0.0, 1.0)):
    """Per-group (count, sum, sumsq, min, max[, hist]) via scatter ops."""
    values = np.asarray(values, dtype=np.float64)
    group_ids = np.asarray(group_ids, dtype=np.int64)
    cnt = np.bincount(group_ids, minlength=n_groups).astype(np.float64)
    s = np.bincount(group_ids, weights=values, minlength=n_groups)
    ss = np.bincount(group_ids, weights=values * values, minlength=n_groups)
    mn = np.full(n_groups, POS_INF)
    mx = np.full(n_groups, NEG_INF)
    np.minimum.at(mn, group_ids, values)
    np.maximum.at(mx, group_ids, values)
    out = {"cnt": cnt, "sum": s, "sumsq": ss, "min": mn, "max": mx}
    if n_bins:
        bins = _hist_bin_index(values, n_bins, hist_range)
        keep = bins >= 0
        h = np.zeros((n_groups, n_bins))
        np.add.at(h, (group_ids[keep], bins[keep]), 1.0)
        out["hist"] = h
    return out
