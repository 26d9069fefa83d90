"""Merge-vs-split training labels for the boundary classifier.

Reference: code/hmt/bc_label.hxx.  For every merge (r0, r1 -> r2) the truth
image decides whether merging improves the segmentation:

  - VI rule   (bc_label.hxx:17-39):  merge iff VI({r2}) <  VI({r0, r1})
  - F1 rule   (bc_label.hxx:44-85):  merge iff pairF1({r2}) > pairF1({r0,r1}),
    with the "tweak" special cases and a max-precision-drop guard
  - RI rule   (bc_label.hxx:89-122): merge iff RI({r2}) > RI({r0, r1})

Labels: MERGE = -1, SPLIT = +1, UNKNOWN = 0 (bc_label.hxx:9-14).

All rules need per-region truth-overlap counts; those compose up the merge
tree (disjoint unions), so one segment-count pass + one tree scan covers all
2N-1 regions -- no per-region pixel re-traversals.  Pair counts use exact
Python integers (reference uses BigInt, code/type/big_num.hxx).

The port's copy of glia_tpu.features.labels, without its per-merge loop
``bc_labels_loop`` (glia_tpu's own oracle for the vectorised rules).
"""

from __future__ import annotations

import numpy as np

from ..constants import BG_VAL, FEPS
from ..graph.tree import build_tree

BC_LABEL_UNKNOWN = 0
BC_LABEL_SPLIT = 1
BC_LABEL_MERGE = -1


def node_truth_counts(labels, truth, order, exclude_truth=(BG_VAL,)):
    """Per-tree-node truth-label histogram + full sizes.

    Returns (tree, node_sizes [M], counts [M, T] int64, truth_values [T]).
    counts excludes ``exclude_truth`` pixels; node_sizes does NOT (the
    region-set VI normalizer uses full sizes, image_stats.hxx:79).
    """
    labels = np.asarray(labels).ravel().astype(np.int64)
    truth = np.asarray(truth).ravel().astype(np.int64)
    tree = build_tree(order)
    M = tree.n_nodes

    # leaf node per pixel via LUT over label values
    leaf_mask = tree.is_leaf
    lut = np.full(int(labels.max()) + 1, -1, dtype=np.int64)
    leaf_nodes = np.nonzero(leaf_mask)[0]
    leaf_keys = tree.keys[leaf_nodes]
    in_range = leaf_keys <= labels.max()
    lut[leaf_keys[in_range]] = leaf_nodes[in_range]
    node_of_pixel = lut[labels]
    sizes = np.zeros(M, dtype=np.int64)
    np.add.at(sizes, node_of_pixel[node_of_pixel >= 0], 1)
    keep = node_of_pixel >= 0
    for v in exclude_truth:
        keep &= truth != v
    tv, tinv = np.unique(truth[keep], return_inverse=True)
    T = len(tv)
    counts = np.zeros((M, T), dtype=np.int64)
    np.add.at(counts, (node_of_pixel[keep], tinv), 1)

    # bottom-up accumulation
    left = tree.left
    right = tree.right
    for i in np.nonzero(~leaf_mask)[0]:
        sizes[i] += sizes[left[i]] + sizes[right[i]]
        counts[i] += counts[left[i]] + counts[right[i]]
    return tree, sizes, counts, tv


def bc_labels(labels, truth, order, rule="f1", tweak=False,
              max_prec_drop=1.0, exclude_truth=(BG_VAL,)):
    """Labels for every merge in ``order``: -1 merge / +1 split.

    Vectorized over all merges (int64 exact: per-image pair counts stay
    below 2^63 for volumes up to ~10^9 voxels; cross-volume accumulation,
    which needs big ints, does not occur here).

    rule: "vi" | "f1" | "ri"; ``tweak``/``max_prec_drop`` apply to "f1"
    (main_bc_label_ri.cxx uses the F1 rule with tweak).
    Returns (labels [n_merges] int, merge_scores, split_scores).
    """
    tree, sizes, counts, tv = node_truth_counts(
        labels, truth, order, exclude_truth)
    internal = np.nonzero(~tree.is_leaf)[0]
    li = tree.left[internal].astype(np.int64)
    ri = tree.right[internal].astype(np.int64)
    ni = internal.astype(np.int64)

    def c2(x):
        x = x.astype(np.int64)
        return x * (x - 1) // 2

    # counts is sparse in practice (each node overlaps few truth labels);
    # compute sum-of-C(c,2) per row over nonzeros only, exactly in int64
    nz_r, nz_c = np.nonzero(counts)
    nz_v = counts[nz_r, nz_c].astype(np.int64)
    tp_node = np.zeros(counts.shape[0], dtype=np.int64)
    np.add.at(tp_node, nz_r, nz_v * (nz_v - 1) // 2)
    tot = counts.sum(axis=1).astype(np.int64)  # [M] non-excluded sizes

    # split set {l, r}: columns sum to the merged node's counts
    s_tp = tp_node[li] + tp_node[ri]
    s_pairs0 = c2(tot[li]) + c2(tot[ri])
    s_pairs1 = tp_node[ni]
    s_fp = s_pairs0 - s_tp
    s_fn = s_pairs1 - s_tp
    # merged set {n}: single region -> FN = 0
    m_tp = tp_node[ni]
    m_fp = c2(tot[ni]) - m_tp
    m_fn = np.zeros_like(m_tp)

    def prf(tp, fp, fn):
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
            rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
            f = np.where(prec + rec > 0,
                         2.0 * prec * rec / np.maximum(prec + rec, 1e-300),
                         0.0)
        return f, prec, rec

    if rule == "f1":
        sf, sprec, srec = prf(s_tp, s_fp, s_fn)
        mf, mprec, mrec = prf(m_tp, m_fp, m_fn)
        merge = mf > sf
        if tweak:
            all_zero = ((sprec < FEPS) & (srec < FEPS)
                        & (mprec < FEPS) & (mrec < FEPS))
            tie_hi = (sf == mf) & (sprec > 0.9) & (mprec > 0.9)
            merge = merge | all_zero | tie_hi
        if max_prec_drop < 1.0:
            merge = merge & ~(sprec - mprec > max_prec_drop)
        out = np.where(merge, BC_LABEL_MERGE, BC_LABEL_SPLIT)
        return out.astype(np.int64), mf, sf
    if rule == "ri":
        n_l = tot[li]
        n_r = tot[ri]
        n_all = tot[ni]
        npair_s = c2(n_l + n_r)
        s_tn = npair_s - s_pairs1 + s_tp - s_pairs0
        # single-region set: pairs0 = C(tot,2), pairs1 = tp -> TN = 0
        m_tn = np.zeros_like(m_tp)
        del n_all, npair_s
        with np.errstate(invalid="ignore"):
            s_den = (s_tp + s_tn + s_fp + s_fn).astype(np.float64)
            m_den = (m_tp + m_tn + m_fp + m_fn).astype(np.float64)
            s_ri = np.where(s_den > 0, (s_tp + s_tn) / np.maximum(s_den, 1),
                            0.0)
            m_ri = np.where(m_den > 0, (m_tp + m_tn) / np.maximum(m_den, 1),
                            0.0)
        out = np.where(m_ri > s_ri, BC_LABEL_MERGE, BC_LABEL_SPLIT)
        return out.astype(np.int64), m_ri, s_ri
    if rule == "vi":
        with np.errstate(divide="ignore", invalid="ignore"):
            lc = np.where(counts > 0,
                          np.log2(np.maximum(counts, 1)), 0.0)  # [M,T]
            ltot = np.where(tot > 0, np.log2(np.maximum(tot, 1)), 0.0)
            # merge VI over set {n}: col totals == row counts
            cn = counts[ni].astype(np.float64)
            m_vi = (cn * (ltot[ni][:, None] - lc[ni])).sum(axis=1)
            m_vi = m_vi / np.maximum(sizes[ni], 1)
            # split VI over {l, r}: cols are the merged counts
            col_log = lc[ni]  # log2 of col totals
            sv = np.zeros(len(ni))
            for child in (li, ri):
                cc = counts[child].astype(np.float64)
                term = cc * (col_log + ltot[child][:, None] - 2.0 * lc[child])
                sv += np.where(counts[child] > 0, term, 0.0).sum(axis=1)
            s_vi = sv / np.maximum(sizes[li] + sizes[ri], 1)
        out = np.where(m_vi < s_vi, BC_LABEL_MERGE, BC_LABEL_SPLIT)
        return out.astype(np.int64), m_vi, s_vi
    raise ValueError(rule)
