"""Segment primitives for CSR graph data (PyTorch).

Counterpart of glia_tpu.ops.segment: data lives in flat value tensors with
segment ids, and statistics are segment reductions.  Ragged segments are
padded with an out-of-range segment id (>= num_segments, or negative),
whose contributions are dropped.
"""

from __future__ import annotations

import torch


def _in_range(seg_ids, num_segments):
    seg_ids = seg_ids.long()
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    return keep, torch.where(keep, seg_ids, num_segments)


def _rows(mask, values):
    return mask.reshape((-1,) + (1,) * (values.ndim - 1))


def segment_sum(values, seg_ids, num_segments):
    keep, ids = _in_range(seg_ids, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    out.index_add_(0, ids, torch.where(_rows(keep, values), values, 0))
    return out[:num_segments]


def segment_mean(values, seg_ids, num_segments, eps=0.0):
    s = segment_sum(values, seg_ids, num_segments)
    c = segment_sum(torch.ones_like(values), seg_ids, num_segments)
    return s / torch.clamp(c, min=1.0), c


def _segment_extreme(values, seg_ids, num_segments, how, fill):
    _, ids = _in_range(seg_ids, num_segments)
    out = values.new_full((num_segments + 1,) + tuple(values.shape[1:]), fill)
    idx = _rows(ids, values).expand_as(values)
    # include_self keeps the fill, which is the reduction's identity: an
    # empty segment reads +inf (min) or -inf (max), as jax.ops.segment_min
    # and segment_max give
    out.scatter_reduce_(0, idx, values, how, include_self=True)
    return out[:num_segments]


def segment_min(values, seg_ids, num_segments):
    return _segment_extreme(values, seg_ids, num_segments, "amin",
                            float("inf"))


def segment_max(values, seg_ids, num_segments):
    return _segment_extreme(values, seg_ids, num_segments, "amax",
                            float("-inf"))


def segment_stats(values, seg_ids, num_segments):
    """(count, sum, sumsq, min, max) in one pass; min and max of an empty
    segment are 0."""
    cnt = segment_sum(torch.ones_like(values), seg_ids, num_segments)
    s = segment_sum(values, seg_ids, num_segments)
    ss = segment_sum(values * values, seg_ids, num_segments)
    mn = segment_min(values, seg_ids, num_segments)
    mx = segment_max(values, seg_ids, num_segments)
    ok = cnt > 0
    return cnt, s, ss, torch.where(ok, mn, 0.0), torch.where(ok, mx, 0.0)


def segment_histogram(values, seg_ids, num_segments, n_bins,
                      lo=0.0, hi=1.0):
    """Per-segment histogram with the reference's binning semantics
    (see _histutil.hist_bin_index): bin bounds are ``interval * (i + 1)``
    without the range's lower end; values <= lo go to bin 0, values >= hi
    to the last bin, values inside (lo, hi) above all bounds are dropped."""
    interval = (hi - lo) / n_bins
    b = torch.floor(values / interval).long().clamp(0, n_bins - 1)
    in_bounds = values < interval * n_bins
    inside = (values > lo) & (values < hi)
    b = torch.where(inside & in_bounds, b,
                    torch.where(values <= lo, 0, n_bins - 1))
    dropped = inside & ~in_bounds
    onehot = torch.nn.functional.one_hot(b, n_bins).to(values.dtype)
    onehot = torch.where(dropped[:, None], 0.0, onehot)
    return segment_sum(onehot, seg_ids, num_segments)


def segment_median_sorted(values_sorted_by_segment, seg_ptr):
    """Upper median per segment from segment-sorted values + CSR offsets.

    seg_ptr: [S+1].  Returns sorted[ptr + len//2] per segment -- exactly
    stats::amedian (code/util/stats.hxx:83-91).  Empty segments -> -1."""
    lens = seg_ptr[1:] - seg_ptr[:-1]
    idx = seg_ptr[:-1] + lens // 2
    idx = idx.clamp(0, values_sorted_by_segment.shape[0] - 1)
    med = values_sorted_by_segment[idx.long()]
    return torch.where(lens > 0, med, -1.0)
