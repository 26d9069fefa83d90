"""Variation of Information metrics.

Reference semantics:
  - conditional entropy between two label images: code/util/image_stats.hxx:122-158
  - image-vs-image VI:                            code/util/image_stats.hxx:162-170
  - region-set-vs-truth VI (training labels):     code/util/image_stats.hxx:69-118
  - the eval_vi printer:                          code/gadget/main_eval_vi.cxx:7-30

NOTE (reference quirk): centropy in the reference computes
``log2(count0 / count01)`` with *unsigned integer division* (uint/uint,
image_stats.hxx:152) which floors the ratio.  ``itk_quirk=True`` (default for
``eval_vi`` parity) reproduces this bit-for-bit; ``itk_quirk=False`` computes
the mathematically correct conditional entropy.
"""

from __future__ import annotations

import numpy as np

from ..constants import BG_VAL, FEPS
from .contingency import contingency_table


def centropy(image0, image1, mask=None, excluded0=(), excluded1=(),
             itk_quirk=True):
    """H(image1 | image0), natural VI building block.

    Pixels are skipped when masked out or when their image0/image1 label is
    in excluded0/excluded1 (image_stats.hxx:133-143).
    """
    l0, l1, c = contingency_table(
        image0, image1, mask, exclude_seg=excluded0, exclude_truth=excluded1
    )
    if c.size == 0:
        return 0.0
    n = int(c.sum())
    # row sums: counts per image0 label
    uniq0, inv0 = np.unique(l0, return_inverse=True)
    row = np.zeros(uniq0.size, dtype=np.int64)
    np.add.at(row, inv0, c)
    c0 = row[inv0]
    if itk_quirk:
        ratio = (c0 // c).astype(np.float64)  # uint division (image_stats.hxx:152)
    else:
        ratio = c0.astype(np.float64) / c.astype(np.float64)
    return float(np.sum(c.astype(np.float64) * np.log2(ratio)) / n)


def vi_image(image0, image1, mask=None, excluded0=(), excluded1=(),
             itk_quirk=True):
    """VI(image0, image1) = H(1|0) + H(0|1) (image_stats.hxx:162-170)."""
    return (
        centropy(image0, image1, mask, excluded0, excluded1, itk_quirk)
        + centropy(image1, image0, mask, excluded1, excluded0, itk_quirk)
    )


def eval_vi(seg_slices, truth_slices, masks=None, itk_quirk=True):
    """Reimplementation of the ``eval_vi`` binary (main_eval_vi.cxx:7-30).

    Returns (false_split, false_merge, total), each averaged over slices:
      false_split = H(seg | truth) with truth-BG pixels excluded
      false_merge = H(truth | seg) with truth-BG pixels excluded
    """
    if not isinstance(seg_slices, (list, tuple)):
        seg_slices = [seg_slices]
        truth_slices = [truth_slices]
        masks = [masks] if masks is not None else None
    fss, fms = [], []
    for i, (seg, truth) in enumerate(zip(seg_slices, truth_slices)):
        mask = masks[i] if masks is not None else None
        fss.append(centropy(truth, seg, mask, (BG_VAL,), (), itk_quirk))
        fms.append(centropy(seg, truth, mask, (), (BG_VAL,), itk_quirk))
    fs = float(np.mean(fss))
    fm = float(np.mean(fms))
    return fs, fm, fs + fm


def vi_region_sets(region_sizes, region_truth_counts, n_points=None):
    """Region-set-vs-truth VI (image_stats.hxx:69-118).

    Used to decide merge-vs-split training labels (code/hmt/bc_label.hxx:17-39).

    Parameters
    ----------
    region_sizes : total pixel count per region *including* excluded pixels
        (the reference's nPoint sums full region sizes, image_stats.hxx:79).
    region_truth_counts : list (len = #regions) of {truth_label: count}
        with excluded truth labels already dropped.
    n_points : optionally override the nPoint normalizer.

    Returns sum over cells  c * (log2(col_truth) + log2(row_region) - 2 log2(c))
    divided by nPoint.
    """
    n_point = int(n_points if n_points is not None else sum(region_sizes))
    if n_point == 0:
        return 0.0
    # counts per region (non-excluded only): log2
    region_tot = [sum(d.values()) for d in region_truth_counts]
    truth_tot = {}
    for d in region_truth_counts:
        for t, c in d.items():
            truth_tot[t] = truth_tot.get(t, 0) + c
    ret = 0.0
    for ri, d in enumerate(region_truth_counts):
        if region_tot[ri] < FEPS:
            continue
        log_r = np.log2(float(region_tot[ri]))
        for t, c in d.items():
            if c >= FEPS and truth_tot[t] >= FEPS:
                ret += c * (np.log2(float(truth_tot[t])) + log_r
                            - 2.0 * np.log2(float(c)))
    return ret / n_point
