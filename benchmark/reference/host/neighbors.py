# Frozen copy of glia_tpu_torch/ops/neighbors.py at commit 28cc36d, with its
# imports pointed at this package.  The benchmark's reference runs it;
# nothing here may import the program, so a later change to the
# program's copy does not move the yardstick.
"""Vectorized 4/6-connectivity contour classification.

Reference semantics (code/type/neighbor.hxx:74-131): for each pixel, visit
neighbors along each ITK index dimension in order (-dim, +dim); ITK dimension
0 is the fastest-varying axis ("x"), which is the LAST numpy axis.  A pixel is

  - a *boundary* pixel of ordered pair ``(own, other)`` where ``other`` is the
    value of the FIRST differing in-bounds unmasked neighbor in that order
    (getContourTraits, neighbor.hxx:111-131); pixels adjacent to several other
    regions belong only to that first pair;
  - a *border* pixel if no neighbor differs but fewer than 2*D neighbors are
    in-bounds/unmasked (image frame / mask frontier);
  - an interior pixel otherwise.

numpy only (the port's copy of glia_tpu.ops.neighbors).
"""

from __future__ import annotations

import numpy as np

from .constants import MASK_OUT_VAL, OOB_LABEL


def _neighbor_axes(ndim):
    """Numpy axes in ITK dimension order: ITK dim i == numpy axis ndim-1-i."""
    return [ndim - 1 - i for i in range(ndim)]


def shifted_labels(labels, mask=None):
    """Neighbor label values for each pixel in ITK traversal order.

    Returns array [2*D, *shape]; entry d is the label of the d-th neighbor
    (order: -x, +x, -y, +y[, -z, +z]), or OOB_LABEL (-1) when the neighbor is
    outside the image or masked out.
    """
    labels = np.asarray(labels)
    if mask is not None:
        labels_eff = np.where(np.asarray(mask) != MASK_OUT_VAL, labels,
                              OOB_LABEL)
    else:
        labels_eff = labels
    outs = []
    for ax in _neighbor_axes(labels.ndim):
        for sign in (-1, 1):
            shifted = np.roll(labels_eff, -sign, axis=ax)
            # roll wraps; overwrite the wrapped edge slice with OOB
            idx = [slice(None)] * labels.ndim
            idx[ax] = -1 if sign == 1 else 0
            shifted[tuple(idx)] = OOB_LABEL
            outs.append(shifted)
    return np.stack(outs, axis=0)


def contour_traits(labels, mask=None):
    """Classify every pixel.

    Returns (other, is_boundary, is_border):
      - other[*shape]: label of first differing neighbor (own label if none)
      - is_boundary[*shape] bool
      - is_border[*shape] bool
    Masked-out pixels are classified as neither (caller should drop them).
    """
    labels = np.asarray(labels)
    nbr = shifted_labels(labels, mask)
    valid = nbr != OOB_LABEL
    n_valid = valid.sum(axis=0)
    differs = valid & (nbr != labels[None])
    # first differing neighbor in order: argmax returns first True
    any_diff = differs.any(axis=0)
    first = np.argmax(differs, axis=0)
    other = np.where(
        any_diff,
        np.take_along_axis(nbr, first[None], axis=0)[0],
        labels,
    )
    is_boundary = any_diff
    is_border = (~any_diff) & (n_valid < 2 * labels.ndim)
    if mask is not None:
        inside = np.asarray(mask) != MASK_OUT_VAL
        is_boundary = is_boundary & inside
        is_border = is_border & inside
    return other, is_boundary, is_border
