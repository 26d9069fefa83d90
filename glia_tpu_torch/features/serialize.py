"""Single-candidate feature vector assembly (a copy of
glia_tpu.features.serialize).

Shared by the classifier-in-the-loop merge engine (graph/merge_bc.py):
given plain scalar stat records for two regions and their shared boundary,
produce the exact serialized RegionFeats / BoundaryFeats /
BoundaryClassificationFeats vectors (code/hmt/bc_feat.hxx:71-243), matching
features/hierarchical.TreeFeatures's vectorized layout element-for-element
(cross-checked in tests).

A "region record" dict:
  area, border, bbox_lo[D], bbox_hi[D]       (raw)
  bd, vp[nT]                                  one-sided boundary counts
  r[i] = (cnt, sum, sumsq, min, max, hist)    per r_image
  rl[i] = hist                                per rl_image
  b[i] = (cnt, sum, sumsq, min, max, hist)    per b_image over boundary
  saliency (optional)

A "pair-boundary record": cnt, vp[nT], b[i] stats over the shared boundary.
"""

from __future__ import annotations

import numpy as np

from ..constants import FEPS, sdivide, slog


def _median_from_chunks(st):
    """stats::amedian upper median (stats.hxx:83-91) over a record's pixel
    value multiset (element 6: list of value-array chunks)."""
    chunks = st[6] if len(st) > 6 else None
    if not chunks:
        return 0.0
    v = np.concatenate([np.asarray(c, dtype=np.float64).ravel()
                        for c in chunks])
    if v.size == 0:
        return 0.0
    k = v.size // 2
    return float(np.partition(v, k)[k])


def _img_feats(st, cfg, n_bins):
    """[hist?] entropy, [median?] mean, std, min, max for one (cnt,sum,
    sumsq,min,max,hist[,vals]) record; zeros when empty (feat.hxx:703).
    Median slot per GLIA_HMT_MEDIAN_FEAT (feat.hxx:674-811, 846-855)."""
    cnt, s, ss, mn, mx, hist = st[:6]
    if cnt <= 0:
        base = [0.0] * (6 if cfg.median_as_feats else 5)
        if cfg.histogram_as_feats:
            return [0.0] * n_bins + base
        return base
    mean = s / cnt
    var = ss / cnt - mean * mean
    std = np.sqrt(max(var, 0.0))
    p = np.asarray(hist, dtype=np.float64) / cnt
    mask = p > FEPS
    ent = float(-(p[mask] * np.log2(p[mask])).sum()) if mask.any() else 0.0
    out = []
    if cfg.histogram_as_feats:
        out += list(p)
    out.append(ent)
    if cfg.median_as_feats:
        out.append(_median_from_chunks(st))
    out += [mean, std, mn, mx]
    return out


def _label_feats(hist, cnt, cfg):
    if cnt <= 0:
        return ([0.0] * len(hist) + [0.0]) if cfg.histogram_as_feats else [0.0]
    p = np.asarray(hist, dtype=np.float64) / cnt
    mask = p > FEPS
    ent = float(-(p[mask] * np.log2(p[mask])).sum()) if mask.any() else 0.0
    if cfg.histogram_as_feats:
        return list(p) + [ent]
    return [ent]


def region_vector(rec, cfg, ndim):
    """RegionFeats serialization (bc_feat.hxx:71-80)."""
    nA, nL = cfg.normalizing_area, cfg.normalizing_length
    area_raw = rec["area"]
    perim_raw = rec["bd"] + rec["border"]
    compact = sdivide(perim_raw ** (ndim / (ndim - 1.0)), area_raw, 0.0)
    area = area_raw / nA
    perim = perim_raw / nL
    bsz = np.maximum(rec["bbox_hi"] - rec["bbox_lo"], 0.0)
    bbox_area = float(np.prod(bsz)) / nA
    vp = np.asarray(rec["vp"], dtype=np.float64)
    out = [area, perim, compact, bbox_area]
    bsz_n = list(bsz / nL)
    vps = list(vp / nL)
    rvps = [sdivide(v, rec["bd"], 0.0) for v in vp]
    if cfg.use_log_shape:
        out = [slog(area, 0.0), slog(perim, 0.0), compact,
               slog(bbox_area, 0.0)]
        bsz_n = [slog(x, 0.0) for x in bsz_n]
        vps = [slog(x, 0.0) for x in vps]
    out += bsz_n + vps + rvps
    for i, img in enumerate(cfg.r_images):
        out += _img_feats(rec["r"][i], cfg, img.hist_bins)
    for i, img in enumerate(cfg.rl_images):
        out += _label_feats(rec["rl"][i], rec["area"], cfg)
    for i, img in enumerate(cfg.b_images):
        out += _img_feats(rec["b"][i], cfg, img.hist_bins)
    if rec.get("saliency") is not None:
        out.append(rec["saliency"])
    return np.asarray(out, dtype=np.float64)


def boundary_vector(rec0, rec1, rec2, pair, cfg, ndim):
    """BoundaryFeats serialization for an (area-ordered) candidate pair
    (bc_feat.hxx:183-215).  rec0.area <= rec1.area must hold already."""
    nA, nL = cfg.normalizing_area, cfg.normalizing_length
    area0 = rec0["area"] / nA
    area1 = rec1["area"] / nA
    perim0 = (rec0["bd"] + rec0["border"]) / nL
    perim1 = (rec1["bd"] + rec1["border"]) / nL
    area_diff = abs(area0 - area1)
    perim_diff = abs(perim0 - perim1)
    blen = np.ceil(pair["cnt"] / 2.0) / nL
    out = [
        area_diff, sdivide(area_diff, area0, 0.0),
        sdivide(area_diff, area1, 0.0),
        perim_diff, sdivide(perim_diff, perim0, 0.0),
        sdivide(perim_diff, perim1, 0.0),
        blen, sdivide(blen, area0, 0.0), sdivide(blen, area1, 0.0),
        sdivide(blen, perim0, 0.0), sdivide(blen, perim1, 0.0),
    ]
    vbl = [np.ceil(v / 2.0) / nL for v in pair["vp"]]
    if cfg.use_log_shape:
        out[0] = slog(out[0], 0.0)
        out[3] = slog(out[3], 0.0)
        out[6] = slog(out[6], 0.0)
        vbl_ser = [slog(v, 0.0) for v in vbl]
    else:
        vbl_ser = list(vbl)
    out += vbl_ser
    out += [sdivide(v, blen, 0.0) for v in vbl]
    out += [sdivide(v, perim0, 0.0) for v in vbl]
    out += [sdivide(v, perim1, 0.0) for v in vbl]
    for i, img in enumerate(cfg.r_images):
        f0 = _img_feats(rec0["r"][i], cfg, img.hist_bins)
        f1 = _img_feats(rec1["r"][i], cfg, img.hist_bins)
        c0 = max(rec0["r"][i][0], 1)
        c1 = max(rec1["r"][i][0], 1)
        h0 = np.asarray(rec0["r"][i][5], dtype=np.float64) / c0
        h1 = np.asarray(rec1["r"][i][5], dtype=np.float64) / c1
        l1 = float(np.abs(h0 - h1).sum())
        x2 = float((np.square(h0 - h1) / (h0 + h1 + FEPS)).sum())
        off = img.hist_bins if cfg.histogram_as_feats else 0
        # entropyDiff, [medianDiff?] meanDiff, stdDiff, minDiff, maxDiff
        # (feat.hxx:886-899 + 762-800)
        out += [l1, x2] + [abs(f0[off + j] - f1[off + j])
                           for j in range(len(f0) - off)]
    for i, img in enumerate(cfg.rl_images):
        c0 = max(rec0["area"], 1)
        c1 = max(rec1["area"], 1)
        h0 = np.asarray(rec0["rl"][i], dtype=np.float64) / c0
        h1 = np.asarray(rec1["rl"][i], dtype=np.float64) / c1
        l1 = float(np.abs(h0 - h1).sum())
        x2 = float((np.square(h0 - h1) / (h0 + h1 + FEPS)).sum())
        e0 = _label_feats(rec0["rl"][i], rec0["area"], cfg)[-1]
        e1 = _label_feats(rec1["rl"][i], rec1["area"], cfg)[-1]
        out += [l1, x2, abs(e0 - e1)]
    for i, img in enumerate(cfg.b_images):
        out += _img_feats(pair["b"][i], cfg, img.hist_bins)
    s0, s1, s2 = rec0.get("saliency"), rec1.get("saliency"), rec2.get("saliency")
    if s0 is not None and s1 is not None and s2 is not None:
        d02 = abs(s0 - s2)
        d12 = abs(s1 - s2)
        out += [min(d02, d12), max(d02, d12)]
    return np.asarray(out, dtype=np.float64)


def bc_vector(rec0, rec1, rec2, pair, cfg, ndim):
    """Full BCF vector with area ordering (bc_feat.hxx:219-243 +
    main_bc_feat.cxx:86-89)."""
    if rec0["area"] / cfg.normalizing_area > rec1["area"] / cfg.normalizing_area:
        rec0, rec1 = rec1, rec0
    bf = boundary_vector(rec0, rec1, rec2, pair, cfg, ndim)
    return np.concatenate([
        bf, region_vector(rec0, cfg, ndim), region_vector(rec1, cfg, ndim),
        region_vector(rec2, cfg, ndim)])
