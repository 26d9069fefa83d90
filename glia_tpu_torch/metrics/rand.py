"""Rand-index family metrics on exact pair counts.

Reference semantics: code/util/stats.hxx:232-261 (randIndex / precision /
recall / f1 on big-int pair counts) and code/gadget/main_eval_ri.cxx:9-62
(accumulation of counts across slices before computing the score).
"""

from __future__ import annotations

from fractions import Fraction

from ..constants import BG_VAL, FEPS
from .contingency import pair_stats


def _ratio(num, den):
    # Mirrors the reference's FEPS-guarded division (stats.hxx:244-258).
    if den == 0:
        return float(num) / FEPS if num else 0.0
    return float(Fraction(num, den))


def rand_index_from_pairs(tp, tn, fp, fn):
    """Traditional Rand index (stats.hxx:232-240)."""
    return _ratio(tp + tn, tp + tn + fp + fn)


def adapted_rand_from_pairs(tp, tn, fp, fn):
    """(precision, recall, error=1-F) as printed by eval_ri (main_eval_ri.cxx:50-55)."""
    prec = _ratio(tp, tp + fp)
    rec = _ratio(tp, tp + fn)
    f = 2.0 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return prec, rec, 1.0 - f


def pair_f1_from_pairs(tp, tn, fp, fn):
    """(f1, precision, recall) as used for merge/split labels (image_stats.hxx:222-245)."""
    prec = _ratio(tp, tp + fp)
    rec = _ratio(tp, tp + fn)
    f = 2.0 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return f, prec, rec


def eval_ri(seg_slices, truth_slices, masks=None, adapted=True):
    """Reimplementation of the ``eval_ri`` binary (main_eval_ri.cxx:9-62).

    Accepts single images or lists of per-slice images; pair counts are
    accumulated exactly across slices (Python big ints stand in for the
    reference's Boost int512, code/type/big_num.hxx:10) before the final
    score.  Background *truth* pixels are excluded.

    Returns (precision, recall, error) when ``adapted`` else the Rand index.
    """
    if not isinstance(seg_slices, (list, tuple)):
        seg_slices = [seg_slices]
        truth_slices = [truth_slices]
        masks = [masks] if masks is not None else None
    tp = tn = fp = fn = 0
    for i, (seg, truth) in enumerate(zip(seg_slices, truth_slices)):
        mask = masks[i] if masks is not None else None
        a, b, c, d = pair_stats(seg, truth, mask, exclude_truth=(BG_VAL,))
        tp += a
        tn += b
        fp += c
        fn += d
    if adapted:
        return adapted_rand_from_pairs(tp, tn, fp, fn)
    return rand_index_from_pairs(tp, tn, fp, fn)
