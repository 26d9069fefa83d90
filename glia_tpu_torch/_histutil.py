"""Shared histogram binning with the reference's exact semantics.

Reference histc (code/util/image_stats.hxx:13-37): bin bounds are
``interval*(i+1)`` WITHOUT adding range.first (a reference quirk kept for
parity); values <= lo -> bin 0, >= hi -> last bin, values inside (lo,hi)
above all bounds are dropped (only possible when lo > 0).
"""

from __future__ import annotations

import numpy as np


def hist_bin_index(values, n_bins, hist_range):
    lo, hi = hist_range
    interval = (hi - lo) / n_bins
    v = np.asarray(values, dtype=np.float64)
    idx = np.full(v.shape, -1, dtype=np.int64)
    inside = (v > lo) & (v < hi)
    with np.errstate(invalid="ignore"):
        b = np.floor_divide(v, interval).astype(np.int64)
    b = np.clip(b, 0, n_bins - 1)
    valid_inside = inside & (v < interval * n_bins)
    idx = np.where(valid_inside, b, idx)
    idx = np.where(v <= lo, 0, idx)
    idx = np.where(v >= hi, n_bins - 1, idx)
    return idx



def hist_counts(values, n_bins, hist_range):
    idx = hist_bin_index(values, n_bins, hist_range)
    keep = idx >= 0
    return np.bincount(idx[keep], minlength=n_bins).astype(np.float64)
