"""Final segmentation from tree picks.

Reference: code/hmt/tree_segment.hxx:11-65 (genLabelTransform +
genFinalSegmentation) -- every picked node maps its leaf labels to a fresh
consecutive key (starting at 1, per main_segment_greedy.cxx:85 /
main_segment_ccm.cxx:96); labels not covered by any pick become BG_VAL when
``ignore_missing`` (the mains' default).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..constants import BG_VAL, MASK_OUT_VAL
from ..graph.tree import MergeTree


def label_transform_single(tree: MergeTree, picks: Sequence[int],
                           key_to_assign: int = 1) -> dict:
    lmap = {}
    k = key_to_assign
    for p in picks:
        for leaf in tree.leaves_under(int(p)):
            lmap[int(tree.keys[leaf])] = k
        k += 1
    return lmap


def label_transform_multi(trees: Sequence[MergeTree],
                          picks: Sequence[Tuple[int, int]],
                          key_to_assign: int = 1) -> dict:
    lmap = {}
    k = key_to_assign
    for ti, ni in picks:
        for leaf in trees[ti].leaves_under(int(ni)):
            lmap[int(trees[ti].keys[leaf])] = k
        k += 1
    return lmap


def transform_image(labels, lmap: dict, mask=None, ignore_missing=True,
                    bg_val=BG_VAL):
    """Relabel via lmap (util/image.hxx transformImage semantics).

    ignore_missing=True: labels without a mapping -> bg_val
    ignore_missing=False: labels without a mapping raise (exact mode).
    Masked-out pixels keep bg_val.
    """
    labels = np.asarray(labels)
    present = np.unique(labels)
    missing = [int(v) for v in present if int(v) not in lmap]
    if not ignore_missing and missing:
        raise KeyError(f"labels missing from transform: {missing[:10]}")
    max_lab = int(present.max()) if present.size else 0
    lut = np.full(max_lab + 1, bg_val, dtype=np.int64)
    for src, dst in lmap.items():
        if 0 <= src <= max_lab:
            lut[src] = dst
    out = lut[labels]
    if mask is not None:
        out = np.where(np.asarray(mask) != MASK_OUT_VAL, out, bg_val)
    return out.astype(np.int32)


def final_segmentation(labels, trees, picks, mask=None, key_to_assign=1,
                       ignore_missing=True):
    """genFinalSegmentation for one tree (picks: [int]) or several
    (picks: [(tree, node)])."""
    if isinstance(trees, MergeTree):
        lmap = label_transform_single(trees, picks, key_to_assign)
    else:
        lmap = label_transform_multi(trees, picks, key_to_assign)
    return transform_image(labels, lmap, mask, ignore_missing)


def relabel_image(labels, start=0):
    """Consecutively relabel by decreasing region size (util/image.hxx:991-1024
    relabelImage): labels sorted by size get start, start+1, ...; background
    (BG_VAL) is preserved when start > 0."""
    labels = np.asarray(labels)
    uniq, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    lut = {}
    k = start
    for i in order:
        lut[int(uniq[i])] = k
        k += 1
    out = np.vectorize(lut.get, otypes=[np.int64])(labels)
    return out.astype(np.int32)
