"""Exact contingency tables between two label images.

The reference accumulates per-(label0,label1) pixel counts in hash maps
(reference: code/util/image_stats.hxx:248-273, code/util/stats.hxx:189-229).
Here the same counts are produced vectorized: pairs of labels are fused into
64-bit codes and counted with ``np.unique`` (host, exact) or with segment sums
(device).  All downstream metric math operates on these exact integer counts,
using Python big integers where the reference uses Boost int512
(code/type/big_num.hxx:10) so SNEMI-scale pair counts never overflow.
"""

from __future__ import annotations

import numpy as np

from ..constants import BG_VAL, MASK_OUT_VAL


def _flatten_masked(seg, truth, mask=None):
    seg = np.asarray(seg).ravel()
    truth = np.asarray(truth).ravel()
    if seg.shape != truth.shape:
        raise ValueError(f"shape mismatch: {seg.shape} vs {truth.shape}")
    if mask is not None:
        keep = np.asarray(mask).ravel() != MASK_OUT_VAL
        seg = seg[keep]
        truth = truth[keep]
    return seg, truth


def contingency_table(seg, truth, mask=None, exclude_seg=(), exclude_truth=()):
    """Exact (seg,truth) co-occurrence counts.

    Pixels are dropped when masked out, or when their seg/truth label is in
    the corresponding excluded set -- matching the image-pair pairStats
    (code/util/image_stats.hxx:248-273) and centropy (:122-147) filters.

    Returns (seg_labels[int64 K], truth_labels[int64 K], counts[int64 K])
    for the K non-empty cells of the contingency table.
    """
    seg, truth = _flatten_masked(seg, truth, mask)
    keep = np.ones(seg.shape, dtype=bool)
    for v in exclude_seg:
        keep &= seg != v
    for v in exclude_truth:
        keep &= truth != v
    seg = seg.astype(np.int64)[keep]
    truth = truth.astype(np.int64)[keep]
    if seg.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    # Fuse into single code.  Labels are < 2^31 so (s << 32) | t is unique.
    code = (seg << 32) | truth
    uniq, counts = np.unique(code, return_counts=True)
    return uniq >> 32, uniq & 0xFFFFFFFF, counts.astype(np.int64)


def pair_stats_from_counts(seg_labels, truth_labels, counts):
    """(TP, TN, FP, FN) pixel-pair counts from a contingency table.

    Exact big-integer arithmetic; semantics of code/util/stats.hxx:189-229
    ("0 as res and 1 as ref"):
      TP      = sum over cells of C(c,2)
      pairs0  = sum over seg rows   of C(row_sum,2)  (same seg label)
      pairs1  = sum over truth cols of C(col_sum,2)  (same truth label)
      nPair   = C(n,2)
      TN = nPair - pairs1 + TP - pairs0
      FP = pairs0 - TP;  FN = pairs1 - TP
    """

    def choose2(x):
        return x * (x - 1) // 2

    counts = [int(c) for c in counts]
    n = sum(counts)
    tp = sum(choose2(c) for c in counts)
    row = {}
    col = {}
    for s, t, c in zip(seg_labels, truth_labels, counts):
        s, t, c = int(s), int(t), int(c)
        row[s] = row.get(s, 0) + c
        col[t] = col.get(t, 0) + c
    pairs0 = sum(choose2(c) for c in row.values())
    pairs1 = sum(choose2(c) for c in col.values())
    npair = choose2(n)
    tn = npair - pairs1 + tp - pairs0
    fp = pairs0 - tp
    fn = pairs1 - tp
    return tp, tn, fp, fn


def pair_stats(seg, truth, mask=None, exclude_seg=(), exclude_truth=(BG_VAL,)):
    """Image-pair TP/TN/FP/FN (code/util/image_stats.hxx:248-273).

    Default exclusion matches ``eval_ri`` (code/gadget/main_eval_ri.cxx:38-40):
    pixels with background *truth* label are ignored entirely.
    """
    s, t, c = contingency_table(
        seg, truth, mask, exclude_seg=exclude_seg, exclude_truth=exclude_truth
    )
    return pair_stats_from_counts(s, t, c)
