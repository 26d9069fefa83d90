"""Merge-order replay onto a label image.

Copy of glia_tpu.graph.merge.apply_merge_order (the pre-merge stage
relabels its watershed through it).
"""

from __future__ import annotations

import numpy as np


def apply_merge_order(labels, order):
    """Replay a merge order onto a label image (transformKeys semantics,
    code/util/struct_merge.hxx:189-210 + gadget/main_apply_merges.cxx).
    Returns the relabeled image (labels merged to final keys)."""
    order = np.asarray(order)
    omap = {}
    for r0, r1, r2 in order:
        omap[int(r0)] = int(r2)
        omap[int(r1)] = int(r2)
    # path-compress to final labels
    final = {}
    for k in list(omap):
        dst = omap[k]
        while dst in omap:
            dst = omap[dst]
        final[k] = dst
    labels = np.asarray(labels)
    out = labels.copy()
    if final:
        keys = np.array(list(final.keys()), dtype=labels.dtype)
        vals = np.array(list(final.values()), dtype=labels.dtype)
        lut_size = int(max(labels.max(), keys.max())) + 1
        lut = np.arange(lut_size, dtype=labels.dtype)
        lut[keys] = vals
        out = lut[labels]
    return out
