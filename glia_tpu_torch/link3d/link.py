"""LINK3D: section-to-section 2D segment linking into 3D neurons (a copy
of glia_tpu.link3d.link).

Reference pipeline (SURVEY.md section 2.7):
  gen_region_pairs (code/gadget/main_gen_region_pairs.cxx:16-57)
  -> sc_feat (code/hmt/sc_feat.hxx) + sc_label (code/hmt/sc_label.hxx)
  -> train/pred RF -> link_by_threshold
  (code/gadget/main_link_by_threshold.cxx:12-50)
  -> group_region_profiles (code/gadget/main_group_region_profiles.cxx:17-73).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import BG_VAL, MASK_OUT_VAL, sdivide, slog
from ..features.adv_shape import adv_shape_2d, region_centroids
from ..features.config import FeatureConfig
from ..features.hierarchical import TreeFeatures
from ..graph.rag import build_rag
from ..metrics.contingency import contingency_table, pair_stats_from_counts
from ..metrics.rand import pair_f1_from_pairs

SC_LABEL_TRUE = 1
SC_LABEL_FALSE = -1

SRKey = Tuple[int, int]  # (image id, region label)


def gen_region_pairs(seg0, seg1, id0=0, id1=1, mask0=None, mask1=None,
                     max_centroid_dist=-1.0):
    """Candidate cross-section pairs: overlapping regions, or centroids
    within max_centroid_dist (main_gen_region_pairs.cxx:29-55).

    Returns (pairs [(SRKey, SRKey)], overlaps {(l0,l1): count}).
    """
    s0, s1, c = contingency_table(seg0, seg1, None,
                                  exclude_seg=(BG_VAL,),
                                  exclude_truth=(BG_VAL,))
    if mask0 is not None or mask1 is not None:
        m = np.ones(np.asarray(seg0).shape, dtype=bool)
        if mask0 is not None:
            m &= np.asarray(mask0) != MASK_OUT_VAL
        if mask1 is not None:
            m &= np.asarray(mask1) != MASK_OUT_VAL
        s0, s1, c = contingency_table(
            np.where(m, seg0, BG_VAL), np.where(m, seg1, BG_VAL), None,
            exclude_seg=(BG_VAL,), exclude_truth=(BG_VAL,))
    overlaps = {(int(a), int(b)): int(n) for a, b, n in zip(s0, s1, c)}

    rag0 = build_rag(np.asarray(seg0), mask0, contour_only=False)
    rag1 = build_rag(np.asarray(seg1), mask1, contour_only=False)
    c0 = region_centroids(seg0, rag0.keys, rag0.region_ptr,
                          rag0.region_pixels, rag0.shape)
    c1 = region_centroids(seg1, rag1.keys, rag1.region_ptr,
                          rag1.region_pixels, rag1.shape)
    pairs = []
    for i, k0 in enumerate(rag0.keys):
        for j, k1 in enumerate(rag1.keys):
            if (int(k0), int(k1)) in overlaps or (
                    max_centroid_dist >= 0.0
                    and np.linalg.norm(c0[i] - c1[j]) <= max_centroid_dist):
                pairs.append(((id0, int(k0)), (id1, int(k1))))
    return pairs, overlaps


def region_feats_with_location(seg, cfg: FeatureConfig, mask=None):
    """Per-region RegionFeatsWithLocation (sc_feat.hxx:10-60): RegionFeats
    (no saliency) ++ 2D adv shape; centroids returned separately (they are
    not serialized, sc_feat.hxx:23,29)."""
    rag = build_rag(np.asarray(seg), mask, contour_only=False)
    tf = TreeFeatures(rag, np.zeros((0, 3), dtype=np.int64), cfg)
    rf = tf.region_features()
    cents = region_centroids(seg, rag.keys, rag.region_ptr,
                             rag.region_pixels, rag.shape,
                             cfg.normalizing_length)
    ashape = adv_shape_2d(rag.shape, rag.keys, rag.region_ptr,
                          rag.region_pixels, cents,
                          cfg.normalizing_length)
    feats = np.concatenate([rf, ashape], axis=1)
    key_row = {int(k): i for i, k in enumerate(tf.node_keys)}
    return rag, tf, feats, cents, key_row


def sc_features(seg0, seg1, cfg: FeatureConfig, pairs,
                use_log_shape=False):
    """SectionClassificationFeats rows [n_pairs, D]
    (sc_feat.hxx:63-172): RegionPairFeats ++ rf0 ++ rf1.

    NOTE reference quirk kept (sc_feat.hxx:139-147): the "label image"
    diff block iterates labelRegion.size() times but diffs the *region*
    image stats (full 7-dim ImageDiffFeats from rf.region[i]).
    """
    rag0, tf0, f0, c0, kr0 = region_feats_with_location(seg0, cfg)
    rag1, tf1, f1, c1, kr1 = region_feats_with_location(seg1, cfg)
    s0l, s1l, cc = contingency_table(seg0, seg1)
    ov = {(int(a), int(b)): int(n) for a, b, n in zip(s0l, s1l, cc)}

    nA = cfg.normalizing_area
    rows = []
    for (id0, k0), (id1, k1) in pairs:
        i0, i1 = kr0[k0], kr1[k1]
        st0, st1 = tf0.stats, tf1.stats
        area0 = st0.area[i0] / nA
        area1 = st1.area[i1] / nA
        perim0 = (st0.bd + st0.border)[i0] / cfg.normalizing_length
        perim1 = (st1.bd + st1.border)[i1] / cfg.normalizing_length
        # RegionShapeDiffFeats (feat.hxx:124-133)
        ad = abs(area0 - area1)
        pd = abs(perim0 - perim1)
        shape_diff = [ad, sdivide(ad, area0, 0.0), sdivide(ad, area1, 0.0),
                      pd, sdivide(pd, perim0, 0.0), sdivide(pd, perim1, 0.0)]
        if use_log_shape:
            shape_diff[0] = slog(shape_diff[0], 0.0)
            shape_diff[3] = slog(shape_diff[3], 0.0)
        # RegionLocationDiffFeats (feat.hxx:363-371)
        loc = [float(np.sqrt(np.sum((c0[i0] - c1[i1]) ** 2)))]
        if use_log_shape:
            loc = [max(0.0, slog(loc[0], 0.0))]
        # RegionSetDiffFeats (feat.hxx:412-423); areas are the (normalized)
        # shape areas, overlap is raw pixel count
        o = float(ov.get((k0, k1), 0))
        sd0 = area0 - o
        sd1 = area1 - o
        set_diff = [o, sd0, sd1, sd0 + sd1, o / area0, o / area1,
                    sd0 / area0, sd1 / area1]
        if use_log_shape:
            set_diff[0] = slog(set_diff[0], 0.0)
            set_diff[1] = slog(set_diff[1], 0.0)
            set_diff[2] = slog(set_diff[2], 0.0)
            set_diff[3] = slog(set_diff[3], 0.0)
        # adv shape diff (feat.hxx:278-287)
        a0 = f0[i0, -15:]
        a1 = f1[i1, -15:]
        ashape_diff = list(np.abs(a0 - a1))
        # image diff blocks from raw stats
        img_diff = []
        for ri, img in enumerate(cfg.r_images):
            d0 = _img_block(st0.r_stats[ri], i0, cfg)
            d1 = _img_block(st1.r_stats[ri], i1, cfg)
            img_diff += _image_diff(d0, d1)
        for li in range(len(cfg.rl_images)):
            # reference bug kept: uses region[li] stats, full 7-dim diff
            d0 = _img_block(st0.r_stats[li], i0, cfg)
            d1 = _img_block(st1.r_stats[li], i1, cfg)
            img_diff += _image_diff(d0, d1)
        row = (shape_diff + loc + set_diff + ashape_diff + img_diff
               + list(f0[i0]) + list(f1[i1]))
        rows.append(row)
    return np.asarray(rows, dtype=np.float64)


def _img_block(st, i, cfg):
    cnt = st["cnt"][i]
    ok = cnt > 0
    mean = st["sum"][i] / cnt if ok else 0.0
    var = st["sumsq"][i] / cnt - mean * mean if ok else 0.0
    std = np.sqrt(max(var, 0.0))
    h = st["hist"][i] / cnt if ok else st["hist"][i] * 0.0
    from ..constants import FEPS

    mask = h > FEPS
    ent = float(-(h[mask] * np.log2(h[mask])).sum()) if mask.any() else 0.0
    return {"hist": h, "entropy": ent, "mean": mean, "std": std,
            "min": st["min"][i] if ok else 0.0,
            "max": st["max"][i] if ok else 0.0}


def _image_diff(d0, d1):
    from ..constants import FEPS

    l1 = float(np.abs(d0["hist"] - d1["hist"]).sum())
    x2 = float((np.square(d0["hist"] - d1["hist"])
                / (d0["hist"] + d1["hist"] + FEPS)).sum())
    return [l1, x2, abs(d0["entropy"] - d1["entropy"]),
            abs(d0["mean"] - d1["mean"]), abs(d0["std"] - d1["std"]),
            abs(d0["min"] - d1["min"]), abs(d0["max"] - d1["max"])]


def sc_labels(seg0, truth0, seg1, truth1, pairs):
    """Same-neuron labels via joint pair-F1 (sc_label.hxx:13-64).

    trueF1: both regions share key (joint segment); falseF1: separate keys.
    Returns labels [+1 same / -1 different] and the two F1 scores.
    """
    t0 = np.asarray(truth0).ravel()
    t1 = np.asarray(truth1).ravel()
    s0 = np.asarray(seg0).ravel()
    s1 = np.asarray(seg1).ravel()

    def truth_counts(seg, truth, key):
        m = (seg == key) & (truth != BG_VAL)
        tv, c = np.unique(truth[m], return_counts=True)
        return dict(zip(tv.tolist(), c.tolist()))

    labels = np.zeros(len(pairs), dtype=np.int64)
    tf1s = np.zeros(len(pairs))
    ff1s = np.zeros(len(pairs))
    cache0: Dict[int, dict] = {}
    cache1: Dict[int, dict] = {}
    for pi, ((_, k0), (_, k1)) in enumerate(pairs):
        if k0 not in cache0:
            cache0[k0] = truth_counts(s0, t0, k0)
        if k1 not in cache1:
            cache1[k1] = truth_counts(s1, t1, k1)
        r0, r1 = cache0[k0], cache1[k1]

        def stats_of(rows):
            s, t, c = [], [], []
            for i, row in enumerate(rows):
                for tv, cc in row.items():
                    s.append(i)
                    t.append(tv)
                    c.append(cc)
            return pair_stats_from_counts(
                np.asarray(s), np.asarray(t), np.asarray(c))

        joint: Dict[int, int] = dict(r0)
        for tv, cc in r1.items():
            joint[tv] = joint.get(tv, 0) + cc
        tf1, _, _ = pair_f1_from_pairs(*stats_of([joint]))
        ff1, _, _ = pair_f1_from_pairs(*stats_of([r0, r1]))
        labels[pi] = SC_LABEL_TRUE if tf1 >= ff1 else SC_LABEL_FALSE
        tf1s[pi] = tf1
        ff1s[pi] = ff1
    return labels, tf1s, ff1s


def _group_regions(regions, links):
    """Union-find grouping (util/struct.hxx groupRegions semantics)."""
    parent = {r: r for r in regions}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in links:
        if a in parent and b in parent:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
    groups: Dict[SRKey, List[SRKey]] = {}
    for r in regions:
        groups.setdefault(find(r), []).append(r)
    return list(groups.values())


def link_by_threshold(pairs, scores, min_score, force_link=True):
    """Keep links scoring >= min_score; optionally force-link regions left
    single to their best weak link (main_link_by_threshold.cxx:24-48)."""
    scores = np.asarray(scores, dtype=np.float64)
    links = []
    weak: Dict[SRKey, List] = {}
    regions = set()
    for i, (a, b) in enumerate(pairs):
        regions.add(a)
        regions.add(b)
        if scores[i] >= min_score:
            links.append((a, b))
        elif force_link:
            heapq.heappush(weak.setdefault(a, []), (-scores[i], i, (a, b)))
            heapq.heappush(weak.setdefault(b, []), (-scores[i], i, (a, b)))
    if force_link:
        for group in _group_regions(regions, links):
            if len(group) == 1 and group[0] in weak:
                links.append(weak[group[0]][0][2])
    return links


def group_region_profiles(segs: Sequence[np.ndarray], image_ids, links,
                          masks=None, relabel=False):
    """Connected link groups -> consistent global labels; returns relabeled
    slices stacked into a 3D volume (main_group_region_profiles.cxx:17-73).
    Unlinked/missing regions get BG."""
    regions = set()
    per_slice_keys = []
    for i, seg in enumerate(segs):
        mask = masks[i] if masks is not None else None
        seg = np.asarray(seg)
        keys = np.unique(seg if mask is None
                         else seg[np.asarray(mask) != MASK_OUT_VAL])
        per_slice_keys.append(keys)
        for k in keys:
            regions.add((int(image_ids[i]), int(k)))
    groups = _group_regions(regions, links)
    lmaps: Dict[int, Dict[int, int]] = {int(i): {} for i in image_ids}
    for gi, group in enumerate(groups, start=1):
        for (img, key) in group:
            lmaps[img][key] = gi
    out = []
    from ..infer.segment import transform_image

    for i, seg in enumerate(segs):
        mask = masks[i] if masks is not None else None
        out.append(transform_image(seg, lmaps[int(image_ids[i])], mask))
    vol = np.stack(out)
    if relabel:
        from ..infer.segment import relabel_image

        vol = relabel_image(vol, 0)
    return vol
