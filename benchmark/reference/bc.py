"""Plain reference of the classifier-in-the-loop merge (GLIA's
merge_order_bc, util/struct_merge_bc.hxx:10-58), batched as the cell
states it, in float64 with plain PyTorch and NumPy.

Nothing here imports the program.  The features are GLIA's
BoundaryClassificationFeats (bc_feat.hxx:71-243, feat.hxx:594-811) as the
port's host code writes them (a frozen copy of the formulas of
glia_tpu_torch/features/serialize.py and of the record semantics of
graph/merge_bc.py's DynamicRagState at commit 95324b0), computed afresh
for any partition of the original regions: every statistic is a sum (or
a min or max) of the original regions' and directed boundaries'
pixel statistics, grouped by current component.  No record is carried
from one superstep to the next.

- A component's one-sided boundary is every directed base pair (a, b) it
  owns, less the mutual ones whose other side it owns too (they cancel,
  region.hxx:66-77); the pair boundary of (A, B) is every directed base
  pair between them, both ways; the would-be merge's boundary is A's and
  B's less the mutual base pairs between them.  Its min and max leave out
  A's entry towards B and B's towards A (an entry: the base pairs one
  component owns towards one other, mutual and not apart).
- The candidates of a partition are the pairs of components joined by at
  least one of the RAG's mutual edges (the boundary table,
  boundary_table.hxx:99-103), in ascending (lo, hi) of current ids.
- The forest walks all trees at once; a sample goes left iff
  ``x <= threshold``.  A candidate's probability is its merge votes times
  fl32(1/T) in float32 (the program's vote fraction, so two equal counts
  give the same bits).
- A superstep merges every candidate that is the strict maximum of both
  its endpoints, a tie going to the lowest position; the new components
  take ids from ``next_id`` in position order.

``check_call`` holds one call of the program to it superstep by
superstep, teacher-forced: the partition advances by the program's rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FEPS = 2.22e-16
# float32's unit roundoff
U32 = 2.0 ** -24
# A split is near for a candidate when its feature lies within
# NEAR_TOL * (1 + |threshold|) of the threshold: the float32 rounding of
# a feature assembled from float32 sums (the program's dtype) reaches
# 7.6e-7 relative over the merge's depth at 4096^2, outside the standard
# deviations (measured: PERF.md §4), and 1e-5 leaves 13 times the room.
NEAR_TOL = 1e-5
# A standard deviation is sqrt(sumsq / n - mean^2): in float32 the
# difference loses up to STD_K * U32 * (sumsq / n) of the variance (the
# rounding of both sums over the merge's depth and of the two terms),
# which the square root turns into more than NEAR_TOL where the deviation
# is small.  A split on a deviation is near when its threshold lies in
# the interval of the deviations that variance band gives.  Measured
# along one order at 4096^2: at most 171 U32 (sumsq / n), 27 at the
# 99.9th percentile (PERF.md §4); 512 leaves three times the room.
STD_K = 512.0


def hist_bin_index(values, n_bins, lo=0.0, hi=1.0):
    """GLIA's histc binning (image_stats.hxx:13-37), bounds interval *
    (i + 1) without lo; values outside the bins get -1."""
    interval = (hi - lo) / n_bins
    v = np.asarray(values, dtype=np.float64)
    idx = np.full(v.shape, -1, dtype=np.int64)
    inside = (v > lo) & (v < hi)
    with np.errstate(invalid="ignore"):
        b = np.floor_divide(v, interval).astype(np.int64)
    b = np.clip(b, 0, n_bins - 1)
    idx = np.where(inside & (v < interval * n_bins), b, idx)
    idx = np.where(v <= lo, 0, idx)
    return np.where(v >= hi, n_bins - 1, idx)


def _group_stats(values, starts, n_bins, group, n_groups):
    """(cnt, sum, sumsq, min, max, hist [n, n_bins]) of ``values`` in the
    contiguous groups that ``starts`` begin (every group non-empty)."""
    cnt = np.diff(np.append(starts, len(values))).astype(np.float64)
    s = np.add.reduceat(values, starts)
    ss = np.add.reduceat(values * values, starts)
    mn = np.minimum.reduceat(values, starts)
    mx = np.maximum.reduceat(values, starts)
    b = hist_bin_index(values, n_bins)
    keep = b >= 0
    h = np.bincount(group[keep] * n_bins + b[keep],
                    minlength=n_groups * n_bins).astype(np.float64)
    return cnt, s, ss, mn, mx, h.reshape(n_groups, n_bins)


class Leaves:
    """The original regions' and directed base pairs' statistics of one
    section, on ``device`` in float64.

    Regions (dense index = position in ``rag.keys``): ``r_add`` [R, 2 +
    3 I + I B] (area, border, then per image cnt, sum, sumsq, hist),
    ``r_min`` / ``r_max`` [R, 2 + I] (bbox corner x, y, then per image
    min / max).  Directed pairs: owner, other (dense), mutual, ``d_add``
    [Ed, 1 + nT + 3 I + I B] (cnt, vp per threshold, per image cnt, sum,
    sumsq, hist), ``d_min`` / ``d_max`` [Ed, I].  ``table``: the RAG's
    mutual edges as dense (u, v)."""

    def __init__(self, rag, images, thresholds, n_bins, device):
        self.R = R = rag.n_regions
        self.dev = device
        self.keys = np.asarray(rag.keys, np.int64)
        self.I, self.B, self.nT = len(images), int(n_bins), len(thresholds)
        imgs = [np.asarray(im, np.float64).ravel() for im in images]
        rptr = np.asarray(rag.region_ptr)
        pix = rag.region_pixels
        rid = np.repeat(np.arange(R), np.diff(rptr))
        ys, xs = np.unravel_index(pix, rag.shape)
        lo = np.stack([np.minimum.reduceat(xs, rptr[:-1]),
                       np.minimum.reduceat(ys, rptr[:-1])], 1)
        hi = np.stack([np.maximum.reduceat(xs, rptr[:-1]),
                       np.maximum.reduceat(ys, rptr[:-1])], 1)
        add = [np.diff(rptr).astype(np.float64)[:, None],
               np.diff(rag.border_ptr).astype(np.float64)[:, None]]
        cols, mins, maxs, hists = [], [], [], []
        for v in imgs:
            cnt, s, ss, mn, mx, h = _group_stats(v[pix], rptr[:-1], self.B,
                                                 rid, R)
            cols.append(np.stack([cnt, s, ss], 1))
            mins.append(mn)
            maxs.append(mx)
            hists.append(h)
        self.r_add = self._up(np.concatenate(
            add + [np.concatenate(cols, 1)] + hists, 1))
        self.r_min = self._up(np.concatenate(
            [lo.astype(np.float64), np.stack(mins, 1)], 1))
        self.r_max = self._up(np.concatenate(
            [hi.astype(np.float64), np.stack(maxs, 1)], 1))

        dptr = np.asarray(rag.dir_ptr)
        dpix = rag.dir_pixels
        Ed = len(rag.dir_pairs)
        did = np.repeat(np.arange(Ed), np.diff(dptr))
        pbv = imgs[0][dpix]
        vp = [np.bincount(did, weights=(pbv >= th).astype(np.float64),
                          minlength=Ed) for th in thresholds]
        dcols, dmins, dmaxs, dh = [], [], [], []
        for v in imgs:
            cnt, s, ss, mn, mx, h = _group_stats(v[dpix], dptr[:-1], self.B,
                                                 did, Ed)
            dcols.append(np.stack([cnt, s, ss], 1))
            dmins.append(mn)
            dmaxs.append(mx)
            dh.append(h)
        self.d_add = self._up(np.concatenate(
            [np.diff(dptr).astype(np.float64)[:, None], np.stack(vp, 1),
             np.concatenate(dcols, 1)] + dh, 1))
        self.d_min = self._up(np.stack(dmins, 1))
        self.d_max = self._up(np.stack(dmaxs, 1))
        code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
        rev = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
        sc = np.sort(code)
        pos = np.minimum(np.searchsorted(sc, rev), len(sc) - 1)
        self.mutual = torch.as_tensor(sc[pos] == rev, device=device)
        self.own = self._idx(np.searchsorted(self.keys, rag.dir_pairs[:, 0]))
        self.oth = self._idx(np.searchsorted(self.keys, rag.dir_pairs[:, 1]))
        e = np.asarray(rag.edges)
        self.table = (self._idx(np.searchsorted(self.keys, e[:, 0])),
                      self._idx(np.searchsorted(self.keys, e[:, 1])))

    def _up(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=self.dev)

    def _idx(self, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=self.dev)

    def region_record(self, add, mn, mx):
        """Named columns of region rows (additive, min, max blocks)."""
        I, B = self.I, self.B
        c = add[:, 2:2 + 3 * I].reshape(-1, I, 3)
        return {"area": add[:, 0], "border": add[:, 1],
                "r_cnt": c[..., 0], "r_sum": c[..., 1], "r_sumsq": c[..., 2],
                "r_hist": add[:, 2 + 3 * I:].reshape(-1, I, B),
                "bbox_lo": mn[:, :2], "bbox_hi": mx[:, :2],
                "r_min": mn[:, 2:], "r_max": mx[:, 2:]}

    def boundary_record(self, add, mn, mx):
        """Named columns of boundary rows."""
        I, B, nT = self.I, self.B, self.nT
        c = add[:, 1 + nT:1 + nT + 3 * I].reshape(-1, I, 3)
        return {"cnt": add[:, 0], "vp": add[:, 1:1 + nT],
                "b_cnt": c[..., 0], "b_sum": c[..., 1], "b_sumsq": c[..., 2],
                "b_hist": add[:, 1 + nT + 3 * I:].reshape(-1, I, B),
                "b_min": mn, "b_max": mx}


def _scatter(n, index, src, how):
    fill = {"sum": 0.0, "amin": float("inf"), "amax": -float("inf")}[how]
    out = torch.full((n,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    if how == "sum":
        return out.index_add_(0, index, src)
    idx = index.reshape((-1,) + (1,) * (src.ndim - 1)).expand_as(src)
    return out.scatter_reduce_(0, idx, src, how, include_self=True)


def _lookup(codes, sorted_codes):
    """Positions of ``codes`` in ``sorted_codes`` and whether present."""
    pos = torch.searchsorted(sorted_codes, codes)
    pos = pos.clamp(max=max(len(sorted_codes) - 1, 0))
    hit = (sorted_codes[pos] == codes) if len(sorted_codes) else (
        torch.zeros_like(codes, dtype=torch.bool))
    return pos, hit


def _excluded(entry_val, owner, K, excl_val, comp, how):
    """For each candidate side: the min (``how`` "amin") or max of the
    entries of component ``comp`` but the one whose value is
    ``excl_val`` (an absent entry: the fill).  Per component, the best
    entry value, how many entries reach it, and the best of the others."""
    fill = float("inf") if how == "amin" else -float("inf")
    worse = (lambda a, b: a > b) if how == "amin" else (lambda a, b: a < b)
    m1 = _scatter(K, owner, entry_val, how)
    at1 = entry_val == m1[owner]
    c1 = _scatter(K, owner, at1.to(torch.float64), "sum")
    m2 = _scatter(K, owner, torch.where(at1, fill, entry_val), how)
    keep1 = worse(excl_val, m1[comp]) | (c1[comp] >= 2)
    return torch.where(keep1, m1[comp], m2[comp])


@dataclass
class Partition:
    """Candidates of one partition, with their records."""

    ids: torch.Tensor        # current id of each dense component
    lo: torch.Tensor         # candidates (dense component index), ascending
    hi: torch.Tensor
    rec0: dict
    rec1: dict
    rec2: dict
    pair: dict


def partition(lv: Leaves, comp: torch.Tensor):
    """The candidates of the partition in which region r belongs to
    component ``comp[r]`` (current ids), and their records; None when no
    candidate is left."""
    ids, cidx = torch.unique(comp, return_inverse=True)
    K = len(ids)
    tu, tv = cidx[lv.table[0]], cidx[lv.table[1]]
    cross = tu != tv
    if not bool(cross.any()):
        return None
    cand = torch.unique(torch.minimum(tu, tv)[cross] * K
                        + torch.maximum(tu, tv)[cross])
    lo, hi = cand // K, cand % K

    c_add = _scatter(K, cidx, lv.r_add, "sum")
    c_min = _scatter(K, cidx, lv.r_min, "amin")
    c_max = _scatter(K, cidx, lv.r_max, "amax")

    a, b = cidx[lv.own], cidx[lv.oth]
    cancel = (a == b) & lv.mutual
    keep = ~cancel
    a_k, b_k, m_k = a[keep], b[keep], lv.mutual[keep]
    d_add, d_min, d_max = lv.d_add[keep], lv.d_min[keep], lv.d_max[keep]
    t_add = _scatter(K, a_k, d_add, "sum")
    t_min = _scatter(K, a_k, d_min, "amin")
    t_max = _scatter(K, a_k, d_max, "amax")

    # base pairs between two components, grouped by candidate
    between = a_k != b_k
    pcode = torch.minimum(a_k, b_k) * K + torch.maximum(a_k, b_k)
    ppos, phit = _lookup(pcode, cand)
    sel = between & phit
    N = len(cand)
    p_add = _scatter(N, ppos[sel], d_add[sel], "sum")
    p_min = _scatter(N, ppos[sel], d_min[sel], "amin")
    p_max = _scatter(N, ppos[sel], d_max[sel], "amax")
    mut = sel & m_k
    mut_add = _scatter(N, ppos[mut], d_add[mut], "sum")

    # entries (owner, other, mutual) and each one's min and max
    ecode = (a_k * K + b_k) * 2 + m_k.to(torch.int64)
    ekeys, einv = torch.unique(ecode, return_inverse=True)
    e_min = _scatter(len(ekeys), einv, d_min, "amin")
    e_max = _scatter(len(ekeys), einv, d_max, "amax")
    e_own = (ekeys // 2) // K

    def entry(src, dst, vals, fill):
        pos, hit = _lookup((src * K + dst) * 2 + 1, ekeys)
        return torch.where(hit[:, None], vals[pos], fill)

    inf = float("inf")
    ex_min = torch.minimum(
        _excluded(e_min, e_own, K, entry(lo, hi, e_min, inf), lo, "amin"),
        _excluded(e_min, e_own, K, entry(hi, lo, e_min, inf), hi, "amin"))
    ex_max = torch.maximum(
        _excluded(e_max, e_own, K, entry(lo, hi, e_max, -inf), lo, "amax"),
        _excluded(e_max, e_own, K, entry(hi, lo, e_max, -inf), hi, "amax"))

    def record(add, mn, mx, badd, bmn, bmx):
        rec = lv.region_record(add, mn, mx)
        bd = lv.boundary_record(badd, bmn, bmx)
        rec["bd"] = bd.pop("cnt")
        rec.update(bd)
        return rec

    rec0 = record(c_add[lo], c_min[lo], c_max[lo], t_add[lo], t_min[lo],
                  t_max[lo])
    rec1 = record(c_add[hi], c_min[hi], c_max[hi], t_add[hi], t_min[hi],
                  t_max[hi])
    rec2 = record(c_add[lo] + c_add[hi],
                  torch.minimum(c_min[lo], c_min[hi]),
                  torch.maximum(c_max[lo], c_max[hi]),
                  t_add[lo] + t_add[hi] - mut_add, ex_min, ex_max)
    pair = lv.boundary_record(p_add, p_min, p_max)
    return Partition(ids, lo, hi, rec0, rec1, rec2, pair)


# -- features (bc_feat.hxx:71-243; serialize.py's formulas) ---------------

def _sdivide(lhs, rhs):
    safe = rhs.abs() >= FEPS
    return torch.where(safe, lhs / torch.where(safe, rhs, 1.0), 0.0)


def _img_feats(cnt, s, ss, mn, mx, hist):
    """[entropy, mean, std, min, max] of one image's stats (zeros where
    empty), and the width of the std's float32 band."""
    ok = cnt > 0
    d = torch.where(ok, cnt, 1.0)
    mean = s / d
    m2 = ss / d
    var = m2 - mean * mean
    std = torch.sqrt(var.clamp(min=0.0))
    p = hist / d[:, None]
    lg = torch.where(p > FEPS, torch.log2(torch.where(p > FEPS, p, 1.0)),
                     0.0)
    ent = -(p * lg).sum(-1)
    band = STD_K * U32 * m2.abs()
    width = torch.maximum(std - torch.sqrt((var - band).clamp(min=0.0)),
                          torch.sqrt((var + band).clamp(min=0.0)) - std)
    f = torch.stack([ent, mean, std, mn, mx], -1)
    z = torch.zeros_like(f)
    w = torch.zeros_like(f)
    w[:, 2] = width
    return torch.where(ok[:, None], f, z), torch.where(ok[:, None], w, z)


def region_features(rec):
    """RegionFeats [N, 32] (bc_feat.hxx:71-80) and std widths."""
    perim = rec["bd"] + rec["border"]
    area = rec["area"]
    bsz = (rec["bbox_hi"] - rec["bbox_lo"]).clamp(min=0.0)
    vp = rec["vp"]
    cols = [torch.stack([area, perim, _sdivide(perim * perim, area),
                         bsz[:, 0] * bsz[:, 1]], -1),
            bsz, vp, _sdivide(vp, rec["bd"][:, None])]
    widths = [torch.zeros_like(c) for c in cols]
    for pre, cnt in (("r", "r_cnt"), ("b", "b_cnt")):
        for i in range(rec[cnt].shape[1]):
            f, w = _img_feats(rec[cnt][:, i], rec[pre + "_sum"][:, i],
                              rec[pre + "_sumsq"][:, i],
                              rec[pre + "_min"][:, i],
                              rec[pre + "_max"][:, i],
                              rec[pre + "_hist"][:, i])
            cols.append(f)
            widths.append(w)
    return torch.cat(cols, -1), torch.cat(widths, -1)


def boundary_features(rec0, rec1, pair):
    """BoundaryFeats [N, 47] (bc_feat.hxx:183-215), rec0 the smaller
    region, and std widths."""
    area0, area1 = rec0["area"], rec1["area"]
    perim0 = rec0["bd"] + rec0["border"]
    perim1 = rec1["bd"] + rec1["border"]
    ad = (area0 - area1).abs()
    pd = (perim0 - perim1).abs()
    blen = torch.ceil(pair["cnt"] / 2.0)
    head = torch.stack([ad, _sdivide(ad, area0), _sdivide(ad, area1),
                        pd, _sdivide(pd, perim0), _sdivide(pd, perim1),
                        blen, _sdivide(blen, area0), _sdivide(blen, area1),
                        _sdivide(blen, perim0), _sdivide(blen, perim1)], -1)
    vbl = torch.ceil(pair["vp"] / 2.0)
    cols = [head, vbl, _sdivide(vbl, blen[:, None]),
            _sdivide(vbl, perim0[:, None]), _sdivide(vbl, perim1[:, None])]
    widths = [torch.zeros_like(c) for c in cols]
    for i in range(rec0["r_cnt"].shape[1]):
        st0 = [rec0[k][:, i] for k in ("r_cnt", "r_sum", "r_sumsq", "r_min",
                                       "r_max", "r_hist")]
        st1 = [rec1[k][:, i] for k in ("r_cnt", "r_sum", "r_sumsq", "r_min",
                                       "r_max", "r_hist")]
        f0, w0 = _img_feats(*st0)
        f1, w1 = _img_feats(*st1)
        h0 = st0[5] / st0[0].clamp(min=1.0)[:, None]
        h1 = st1[5] / st1[0].clamp(min=1.0)[:, None]
        l1 = (h0 - h1).abs().sum(-1)
        x2 = ((h0 - h1) ** 2 / (h0 + h1 + FEPS)).sum(-1)
        cols.append(torch.cat([torch.stack([l1, x2], -1),
                               (f0 - f1).abs()], -1))
        widths.append(torch.cat([torch.zeros_like(f0[:, :2]), w0 + w1], -1))
    for i in range(pair["b_cnt"].shape[1]):
        f, w = _img_feats(*[pair[k][:, i] for k in (
            "b_cnt", "b_sum", "b_sumsq", "b_min", "b_max", "b_hist")])
        cols.append(f)
        widths.append(w)
    return torch.cat(cols, -1), torch.cat(widths, -1)


def features(part: Partition):
    """The candidates' BoundaryClassificationFeats [N, 143] (area
    ordering of bc_feat.hxx:219-243) and the std widths [N, 143]."""
    rec0, rec1 = part.rec0, part.rec1
    swap = rec0["area"] > rec1["area"]
    r0, r1 = {}, {}
    for k in rec0:
        m = swap.reshape((-1,) + (1,) * (rec0[k].ndim - 1))
        r0[k] = torch.where(m, rec1[k], rec0[k])
        r1[k] = torch.where(m, rec0[k], rec1[k])
    parts = [boundary_features(r0, r1, part.pair), region_features(r0),
             region_features(r1), region_features(part.rec2)]
    return (torch.cat([p[0] for p in parts], -1),
            torch.cat([p[1] for p in parts], -1))


# -- forest ----------------------------------------------------------------

class ForestWalk:
    """All trees of a forest at once over blocks of samples, in float64
    against the float32 thresholds."""

    def __init__(self, forest, merge_label, device, block=1 << 16):
        T, N = forest.feature.shape
        self.T, self.N, self.block = T, N, block
        up = lambda a, dt: torch.as_tensor(np.asarray(a).ravel(), dtype=dt,
                                           device=device)
        self.feature = up(forest.feature, torch.int64)
        self.threshold = up(forest.threshold.astype(np.float64),
                            torch.float64)
        self.left = up(forest.left, torch.int64)
        self.right = up(forest.right, torch.int64)
        self.leaf_class = up(forest.leaf_class, torch.int64)
        self.merge = int(np.nonzero(np.asarray(forest.classes)
                                    == merge_label)[0][0])
        self.depth = int(forest.max_depth)
        self.base = torch.arange(T, device=device) * N
        self.inv_t = np.float32(1.0) / np.float32(T)

    def votes(self, X, W=None):
        """(merge votes [n] int64, near [n] bool: the walk passed a split
        within NEAR_TOL * (1 + |threshold|) + the feature's width)."""
        counts, nears = [], []
        for a in range(0, len(X), self.block):
            c, n = self._walk(X[a:a + self.block],
                              None if W is None else W[a:a + self.block])
            counts.append(c)
            nears.append(n)
        if not counts:
            z = torch.zeros(0, dtype=torch.int64, device=X.device)
            return z, z.bool()
        return torch.cat(counts), torch.cat(nears)

    def _walk(self, X, W):
        n = len(X)
        node = self.base.expand(n, self.T).clone()
        near = torch.zeros(n, dtype=torch.bool, device=X.device)
        for _ in range(self.depth + 1):
            f = self.feature[node]
            inner = f >= 0
            if not bool(inner.any()):
                break
            fc = f.clamp(min=0)
            x = X.gather(1, fc)
            thr = self.threshold[node]
            gap = (x - thr).abs()
            tol = NEAR_TOL * (1.0 + thr.abs())
            if W is not None:
                tol = tol + W.gather(1, fc)
            near |= (inner & (gap <= tol)).any(1)
            nxt = torch.where(x <= thr, self.left[node], self.right[node])
            node = torch.where(inner, self.base + nxt, node)
        cls = self.leaf_class[node]
        return (cls == self.merge).sum(1), near

    def prob(self, counts):
        """The vote fraction count * fl32(1/T), rounded to float32."""
        c = counts.cpu().numpy().astype(np.float32)
        return (c * self.inv_t).astype(np.float32).astype(np.float64)


def select(counts, lo, hi, K):
    """Candidates that are the strict maximum of both endpoints, a tie
    going to the lowest position (``lo``, ``hi``: dense component
    indices, rows in position order)."""
    n = len(counts)
    idx = torch.arange(n, device=counts.device)
    best = torch.full((K,), -1, dtype=counts.dtype, device=counts.device)
    best = best.scatter_reduce(0, lo, counts, "amax")
    best = best.scatter_reduce(0, hi, counts, "amax")
    cand = (counts == best[lo]) & (counts == best[hi])
    ci = torch.where(cand, idx, n)
    low = torch.full((K,), n, dtype=idx.dtype, device=counts.device)
    low = low.scatter_reduce(0, lo, ci, "amin")
    low = low.scatter_reduce(0, hi, ci, "amin")
    return cand & (low[lo] == idx) & (low[hi] == idx)


def max_supersteps(R: int) -> int:
    """The loop's stated superstep cap for R regions."""
    return 4 * int(np.ceil(np.log2(max(R, 2)))) + 16


def step_rows(lv: Leaves, walk: ForestWalk, comp):
    """One superstep from the partition ``comp``: (Partition or None,
    merge votes, near, selected mask)."""
    part = partition(lv, comp)
    if part is None:
        return None, None, None, None
    X, W = features(part)
    counts, near = walk.votes(X, W)
    return part, counts, near, select(counts, part.lo, part.hi,
                                      len(part.ids))


def merge_order(lv: Leaves, walk: ForestWalk, cap=None):
    """The reference's own batched order: (rows [n, 3] dense ids,
    probabilities [n], merges of each superstep)."""
    R = lv.R
    cap = max_supersteps(R) if cap is None else cap
    comp = torch.arange(R, device=lv.dev)
    rows, probs, steps = [], [], []
    next_id = R
    while len(steps) < cap:
        part, counts, near, ok = step_rows(lv, walk, comp)
        if part is None:
            break
        u = part.ids[part.lo[ok]]
        v = part.ids[part.hi[ok]]
        new = torch.arange(next_id, next_id + len(u), device=lv.dev)
        rows.append(torch.stack([u, v, new], 1))
        probs.append(walk.prob(counts[ok]))
        steps.append(len(u))
        next_id += len(u)
        comp = _advance(comp, rows[-1], 2 * R)
    if not rows:
        return np.zeros((0, 3), np.int64), np.zeros(0), steps
    return (torch.cat(rows).cpu().numpy(), np.concatenate(probs), steps)


def _advance(comp, rows, n_ids):
    """The partition after merging ``rows`` (u, v, new id)."""
    lut = torch.arange(n_ids, device=comp.device)
    lut[rows[:, 0]] = rows[:, 2]
    lut[rows[:, 1]] = rows[:, 2]
    return lut[comp]


def dense_rows(lv: Leaves, key_rows):
    """Label-key rows (the program's output) as dense ids: a region's key
    is its index in ``keys``; merge i's key is max_key + 1 + i, its id
    R + i."""
    k = np.asarray(key_rows, np.int64).reshape(-1, 3)
    max_key = int(lv.keys.max())
    leaf = k <= max_key
    pos = np.searchsorted(lv.keys, np.where(leaf, k, 0))
    pos = np.minimum(pos, len(lv.keys) - 1)
    bad = leaf & (lv.keys[pos] != k)
    out = np.where(leaf, pos, lv.R + k - max_key - 1)
    return np.where(bad, -1, out)


def check_call(lv: Leaves, walk: ForestWalk, key_rows, probs, steps):
    """One call of the program held to the reference, teacher-forced.

    ``key_rows`` [n, 3] and ``probs`` [n]: the program's order (label
    keys) and probabilities; ``steps``: its merges of each superstep.  At
    every superstep the reference scores the partition the program's
    earlier rows left and compares its merge set with the program's rows
    of that superstep.  Returns a dict: ``checked`` (rows compared),
    ``mismatched`` (rows in one set only, or out of place, that no near
    candidate explains), ``explained`` (rows in one set only that one
    does), ``prob_gap`` (widest |program - reference| probability over
    matched rows whose own walk is not near).

    A near candidate changes the maxima at its endpoints, so the
    candidates there may stop or start being maxima of both ends, which
    moves the lowest-position choice at their other endpoints: a row is
    explained when a near candidate ends at one of its endpoints or at an
    endpoint of a candidate that shares one with it (two hops, the reach
    of the selection rule)."""
    R = lv.R
    rows = dense_rows(lv, key_rows)
    probs = np.asarray(probs, np.float64)
    steps = [int(s) for s in steps]
    out = {"checked": 0, "mismatched": 0, "explained": 0, "prob_gap": 0.0}
    if sum(steps) != len(rows) or len(probs) != len(rows):
        out["mismatched"] = max(len(rows), sum(steps), 1)
        return out
    comp = torch.arange(R, device=lv.dev)
    pos = 0
    done = len(steps) >= max_supersteps(R)
    for k in range(len(steps) + (0 if done else 1)):
        m = steps[k] if k < len(steps) else 0
        mine = rows[pos:pos + m]
        part, counts, near, ok = step_rows(lv, walk, comp)
        if part is None:
            out["mismatched"] += m
            out["checked"] += m
            break
        K = len(part.ids)
        ids = part.ids.cpu().numpy()
        lo, hi = part.lo.cpu().numpy(), part.hi.cpu().numpy()
        okn = ok.cpu().numpy()
        nearn = near.cpu().numpy()
        p_ref = walk.prob(counts)
        # reach of the near candidates (dense component indices)
        mark = np.zeros(K, bool)
        mark[lo[nearn]] = True
        mark[hi[nearn]] = True
        reach = mark.copy()
        inc = mark[lo] | mark[hi]
        reach[lo[inc]] = True
        reach[hi[inc]] = True
        # the program's rows as candidate positions
        cu = np.searchsorted(ids, mine[:, 0])
        cv = np.searchsorted(ids, mine[:, 1])
        cu = np.minimum(cu, K - 1)
        cv = np.minimum(cv, K - 1)
        valid = ((ids[cu] == mine[:, 0]) & (ids[cv] == mine[:, 1])
                 & (mine[:, 0] >= 0) & (mine[:, 1] >= 0))
        code = lo * K + hi
        mcode = np.minimum(cu, cv) * K + np.maximum(cu, cv)
        cpos = np.minimum(np.searchsorted(code, mcode), len(code) - 1)
        valid &= code[cpos] == mcode
        # in place: new ids R + position, rows in ascending candidate order
        placed = mine[:, 2] == R + pos + np.arange(m)
        placed &= np.r_[True, cpos[1:] > cpos[:-1]] if m else placed
        in_ref = valid & okn[cpos]
        ref_only = okn.copy()
        ref_only[cpos[valid]] = False
        expl_mine = valid & (reach[cu] | reach[cv])
        expl_ref = reach[lo[ref_only]] | reach[hi[ref_only]]
        bad_mine = ~(in_ref & placed)
        out["mismatched"] += int((bad_mine & ~expl_mine).sum()
                                 + (~expl_ref).sum())
        out["explained"] += int((bad_mine & expl_mine).sum()
                                + expl_ref.sum())
        out["checked"] += m
        match = in_ref & ~nearn[cpos]
        if match.any():
            gap = np.abs(probs[pos:pos + m][match] - p_ref[cpos[match]])
            out["prob_gap"] = max(out["prob_gap"], float(gap.max()))
        if k < len(steps):
            if not valid.all():
                # the partition cannot advance by rows that are not
                # candidates: the rest of the call is not comparable
                out["mismatched"] += sum(steps[k + 1:])
                break
            comp = _advance(comp, torch.as_tensor(mine, device=lv.dev),
                            2 * R)
        pos += m
    return out
