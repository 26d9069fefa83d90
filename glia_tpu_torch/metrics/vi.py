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

from ..constants import BG_VAL
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
