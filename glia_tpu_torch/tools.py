"""Evaluation / matching / sample-wrangling utilities (a copy of
glia_tpu.tools).

Array equivalents of the reference's remaining gadget binaries
(SURVEY.md section 2.7): eval_init_seg, eval_ri_threshold,
match_seg_to_truth / match_truth_to_seg, seg_stats, normalize_sample,
unique_sample, distribute_samples, select_hard_samples,
remove_single_profile_regions.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .constants import BG_VAL, MASK_OUT_VAL
from .metrics.contingency import contingency_table, pair_stats
from .metrics.rand import adapted_rand_from_pairs, rand_index_from_pairs
from .learn.predict import feature_minmax, rescale_features
from .models.ensemble import distribute


def eval_init_seg(seg, truth, mask=None):
    """Upper bound of an initial segmentation: map each region to its
    dominant non-BG truth label, then adapted-Rand against truth
    (gadget/main_eval_init_seg.cxx:10-62).

    Returns (precision, recall, error, mapped_seg).
    """
    s, t, c = contingency_table(seg, truth, mask, exclude_truth=(BG_VAL,))
    # per seg label: argmax truth count
    best: Dict[int, Tuple[int, int]] = {}
    for si, ti, ci in zip(s, t, c):
        si, ti, ci = int(si), int(ti), int(ci)
        if si not in best or ci > best[si][1]:
            best[si] = (ti, ci)
    seg = np.asarray(seg)
    lut = np.full(int(seg.max()) + 1, BG_VAL, dtype=np.int64)
    for si, (ti, _) in best.items():
        lut[si] = ti
    mapped = lut[seg]
    if mask is not None:
        mapped = np.where(np.asarray(mask) != MASK_OUT_VAL, mapped, BG_VAL)
    tp, tn, fp, fn = pair_stats(mapped, truth, mask,
                                exclude_truth=(BG_VAL,))
    prec, rec, err = adapted_rand_from_pairs(tp, tn, fp, fn)
    return prec, rec, err, mapped.astype(np.int32)


def eval_ri_threshold(pb_images, truth_images, masks=None, lower=0.0,
                      upper=1.0, n_thresholds=10, adapted=True,
                      use_watershed=False):
    """Sweep pb thresholds -> binary/CC (or watershed) segmentations ->
    accumulated pair stats per threshold (main_eval_ri_threshold.cxx).

    Returns list of (threshold, *scores)."""
    from .native import connected_components_native, watershed_native
    from .ops.image import threshold_image

    if not isinstance(pb_images, (list, tuple)):
        pb_images = [pb_images]
        truth_images = [truth_images]
        masks = [masks] if masks is not None else None
    step = (upper - lower) / n_thresholds
    thresholds = [lower + i * step for i in range(n_thresholds)]
    totals = [[0, 0, 0, 0] for _ in thresholds]
    for i, (pb, truth) in enumerate(zip(pb_images, truth_images)):
        mask = masks[i] if masks is not None else None
        for j, th in enumerate(thresholds):
            if use_watershed:
                canvas = watershed_native(
                    np.asarray(pb, np.float32), th)
            else:
                canvas = threshold_image(pb, lower, th, 1, 0)
                canvas = connected_components_native(
                    canvas.astype(np.int32))
            st = pair_stats(canvas, truth, mask, exclude_truth=(BG_VAL,))
            for k in range(4):
                totals[j][k] += st[k]
    out = []
    for th, tot in zip(thresholds, totals):
        if adapted:
            out.append((th,) + adapted_rand_from_pairs(*tot))
        else:
            out.append((th, rand_index_from_pairs(*tot)))
    return out


def match_seg_to_truth(seg, truth, mask=None):
    """Best-Jaccard seg label per truth region
    (main_match_seg_to_truth.cxx:11-47).
    Returns {truth_label: (seg_label, jaccard)}."""
    s, t, c = contingency_table(seg, truth, mask)
    seg_sizes: Dict[int, int] = {}
    for si, ci in zip(s, c):
        seg_sizes[int(si)] = seg_sizes.get(int(si), 0) + int(ci)
    truth_sizes: Dict[int, int] = {}
    for ti, ci in zip(t, c):
        truth_sizes[int(ti)] = truth_sizes.get(int(ti), 0) + int(ci)
    out: Dict[int, Tuple[int, float]] = {}
    for si, ti, ci in zip(s, t, c):
        si, ti, ci = int(si), int(ti), int(ci)
        if ti == BG_VAL:
            continue
        ji = ci / (seg_sizes[si] + truth_sizes[ti] - ci)
        if ti not in out or ji > out[ti][1]:
            out[ti] = (si, ji)
    return out


def match_truth_to_seg(seg, truth, mask=None):
    """Best-Jaccard truth label per seg region."""
    inv = match_seg_to_truth(truth, seg, mask)
    return inv


def seg_stats(seg, mask=None, include_bg=False):
    """Region label -> pixel count (main_seg_stats.cxx:11-20)."""
    seg = np.asarray(seg)
    if mask is not None:
        seg = seg[np.asarray(mask) != MASK_OUT_VAL]
    uniq, counts = np.unique(seg, return_counts=True)
    out = dict(zip(uniq.tolist(), counts.tolist()))
    if not include_bg:
        out.pop(BG_VAL, None)
    return out


def normalize_samples(feature_sets: Sequence[np.ndarray], minmax=None,
                      out_min=-1.0, out_max=1.0):
    """Min-max rescale feature matrices; compute minmax over all sets if
    not provided (main_normalize_sample.cxx + stats::rescale).

    Returns (rescaled sets, minmax)."""
    if minmax is None:
        allf = np.concatenate([np.asarray(f) for f in feature_sets])
        minmax = feature_minmax(allf)
    out = [rescale_features(f, minmax, out_min, out_max)
           for f in feature_sets]
    return out, minmax


def unique_samples(feats, labels):
    """Drop duplicate feature rows (main_unique_sample.cxx)."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    _, idx = np.unique(feats, axis=0, return_index=True)
    idx = np.sort(idx)
    return feats[idx], labels[idx]


def distribute_samples(feats, labels, dim0, dim1, threshold):
    """3-way split by area-feature thresholds for ensemble training
    (main_distribute_samples.cxx:20-37): group 0 if f[dim1] < t, 1 if
    f[dim0] < t, else 2."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    idx = distribute(feats, dim0, dim1, threshold)
    return [(feats[idx == k], labels[idx == k]) for k in range(3)]


def select_hard_samples(feats, labels, preds, label0=1, label1=-1,
                        threshold0=0.5, threshold1=0.5):
    """Keep misclassified samples (main_select_hard_samples.cxx:28-41)."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    keep = ((labels == label0) & (preds > threshold0)) | (
        (labels == label1) & (preds < threshold1))
    return feats[keep], labels[keep]


def remove_single_profile_regions(slices, image_ids, links):
    """Drop regions participating in no cross-section link
    (main_remove_single_profile_regions.cxx): returns slices with
    single-profile regions set to BG."""
    linked = set()
    for a, b in links:
        linked.add(a)
        linked.add(b)
    out = []
    for i, seg in enumerate(slices):
        seg = np.asarray(seg).copy()
        keys = np.unique(seg)
        for k in keys:
            if k != BG_VAL and (int(image_ids[i]), int(k)) not in linked:
                seg[seg == k] = BG_VAL
        out.append(seg)
    return out


def label_image_stats(labels, mask=None, n_bins=20):
    """Region-size summary of a label image
    (gadget/main_label_image_stats.cxx:6-37): BG-excluded unique label
    count, min/max region size, and a normalized size histogram with
    ``n_bins`` bins over (0, imageSize/10) using stats::hist semantics
    (stats.hxx:94-142, incl. the bounds-without-range.first quirk).

    Returns dict(unique_labels, min_size, max_size, size_hist).
    """
    from ._histutil import hist_counts

    labels = np.asarray(labels)
    image_size = int(np.prod(labels.shape))
    sizes = seg_stats(labels, mask=mask, include_bg=False)
    vals = np.asarray(list(sizes.values()), dtype=np.float64)
    if len(vals) == 0:
        return {"unique_labels": 0, "min_size": 0, "max_size": 0,
                "size_hist": np.zeros(n_bins)}
    hc = hist_counts(vals, n_bins, (0.0, image_size / 10.0))
    return {
        "unique_labels": int(len(vals)),
        "min_size": int(vals.min()),
        "max_size": int(vals.max()),
        "size_hist": hc / len(vals),
    }


def distribute_label_images(label_images, n_output, area_threshold,
                            include_bg=False, rng=None):
    """Pick/duplicate label images for ensemble training sets
    (gadget/main_distribute_label_images.cxx:100-170, live code path):

    - sort images by #regions larger than ``area_threshold``; ties
      re-compare at threshold/2, /4, ... (cascading comparator);
    - n_input == n_output: keep all (sorted);
    - n_input >  n_output: keep first/last, sample the middle;
    - n_input <  n_output: keep all, duplicate the last (most regions).

    Returns the list of selected input indices (length n_output).
    """
    rng = np.random.default_rng(rng)
    n_input = len(label_images)
    n_must_keep = 1
    sizes = []
    for i, img in enumerate(label_images):
        cm = seg_stats(img, include_bg=include_bg)
        sizes.append((i, np.asarray(list(cm.values()), dtype=np.int64)))

    import functools

    def cmp(lhs, rhs):
        t = int(area_threshold)
        while t > 0:
            nl = int((lhs[1] > t).sum())
            nr = int((rhs[1] > t).sum())
            if nl < nr:
                return -1
            if nl > nr:
                return 1
            t //= 2
        return -1  # reference comparator returns true on full tie

    sizes.sort(key=functools.cmp_to_key(cmp))
    if n_input == n_output:
        return [sizes[i][0] for i in range(n_output)]
    out = [-1] * n_output
    if n_input > n_output:
        for i in range(n_must_keep):
            out[i] = sizes[i][0]
            out[n_output - 1 - i] = sizes[n_input - 1 - i][0]
        middle = list(range(n_must_keep, n_input - n_must_keep))
        n_left = n_output - n_must_keep * 2
        # bug-for-bug with the reference: it shuffles+samples middleIndices
        # but then never uses them -- the write loop takes the first nLeft
        # middle entries in sort order (main_distribute_label_images.cxx:
        # 156-162).  The shuffle is kept only for RNG-stream fidelity.
        rng.shuffle(middle)
        middle = sorted(middle[:n_left])
        for i in range(n_left):
            out[i + n_must_keep] = sizes[i + n_must_keep][0]
        return out
    for i in range(n_input):
        out[i] = sizes[i][0]
    for i in range(n_input, n_output):
        out[i] = sizes[-1][0]
    return out
