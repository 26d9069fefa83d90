"""Hierarchical (merge-tree) feature extraction.

Computes the reference's RegionFeats / BoundaryFeats /
BoundaryClassificationFeats (code/hmt/bc_feat.hxx, code/type/feat.hxx) for
ALL 2N-1 tree regions *incrementally* instead of re-traversing pixel sets
per region (the reference's parfor over regions, main_bc_feat.cxx:59-95):

  - region pixel sets are disjoint unions up the tree, so every region
    statistic (sum/sumsq/min/max/histogram/bbox) composes child->parent;
  - one-sided region boundaries are multisets of *base directed pairs*
    (TRegion::merge cancellation happens on base-pair keys,
    code/type/region.hxx:68-77): a mutual pair (a,b)/(b,a) dies at the merge
    node where a's and b's components join (the LCA of the corresponding
    leaves); non-mutual pairs never die.  Additive boundary stats therefore
    compose with subtraction of "dying" pair stats at each internal node;
    boundary min/max uses small-to-large mergeable heaps with lazy deletion.

The port's copy of glia_tpu.features.hierarchical: host code in numpy.
``group_stats`` also seeds the leaf records of the device BC engine.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import FEPS, sdivide, slog
from ..graph.rag import Rag
from ..graph.tree import build_tree, dfs_intervals, pairs_lca
from .config import FeatureConfig

NEG_INF = -np.inf
POS_INF = np.inf


# ---------------------------------------------------------------------------
# pixel-group statistics
# ---------------------------------------------------------------------------

from .._histutil import hist_bin_index as _hist_bin_index  # shared binning


def group_stats(values, group_ids, n_groups, n_bins=0, hist_range=(0.0, 1.0)):
    """Per-group (count, sum, sumsq, min, max[, hist]) via scatter ops."""
    values = np.asarray(values, dtype=np.float64)
    group_ids = np.asarray(group_ids, dtype=np.int64)
    cnt = np.bincount(group_ids, minlength=n_groups).astype(np.float64)
    s = np.bincount(group_ids, weights=values, minlength=n_groups)
    ss = np.bincount(group_ids, weights=values * values, minlength=n_groups)
    mn = np.full(n_groups, POS_INF)
    mx = np.full(n_groups, NEG_INF)
    np.minimum.at(mn, group_ids, values)
    np.maximum.at(mx, group_ids, values)
    out = {"cnt": cnt, "sum": s, "sumsq": ss, "min": mn, "max": mx}
    if n_bins:
        bins = _hist_bin_index(values, n_bins, hist_range)
        keep = bins >= 0
        h = np.zeros((n_groups, n_bins))
        np.add.at(h, (group_ids[keep], bins[keep]), 1.0)
        out["hist"] = h
    return out


def _entropy_rows(hist_counts, totals):
    """stats::entropy of per-row normalized histograms (stats.hxx:144-151).

    totals = group sizes (reference normalizes by points.size(), which may
    exceed the histogram mass when the lo>0 binning quirk drops values)."""
    t = np.asarray(totals, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = hist_counts / np.where(t > 0, t, 1.0)[:, None]
    p = np.where(t[:, None] > 0, p, 0.0)
    mask = p > FEPS
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.where(mask, np.log2(np.where(mask, p, 1.0)), 0.0)
    return -(p * lg).sum(axis=1)


def _np_interval_sums(leaf_vals, lo, hi):
    """Exclusive-prefix-sum interval sums: leaf_vals [L, ...] in DFS order,
    node intervals [lo, hi) -> [M, ...]."""
    P = np.concatenate([np.zeros((1,) + leaf_vals.shape[1:],
                                 leaf_vals.dtype),
                        np.cumsum(leaf_vals, axis=0)], axis=0)
    return P[hi] - P[lo]


def _np_interval_reduce(leaf_vals, lo, hi, kind="min"):
    """Sparse-table range min/max over DFS-ordered leaf values."""
    combine = np.minimum if kind == "min" else np.maximum
    fill = POS_INF if kind == "min" else NEG_INF
    L = leaf_vals.shape[0]
    out_shape = (len(lo),) + leaf_vals.shape[1:]
    if L == 0:
        return np.full(out_shape, fill)
    tables = [leaf_vals]
    k = 1
    while (1 << k) <= L:
        prev = tables[-1]
        half = 1 << (k - 1)
        tables.append(combine(prev[: L - (1 << k) + 1],
                              prev[half: L - half + 1]))
        k += 1
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    length = np.maximum(hi - lo, 1)
    ks = np.floor(np.log2(length)).astype(np.int64)
    out = np.full(out_shape, fill, dtype=np.float64)
    for ki, tab in enumerate(tables):
        sel = ks == ki
        if not sel.any():
            continue
        a = np.clip(lo[sel], 0, tab.shape[0] - 1)
        b = np.clip(hi[sel] - (1 << ki), 0, tab.shape[0] - 1)
        out[sel] = combine(tab[a], tab[b])
    empty = hi <= lo
    if empty.any():
        out[empty] = fill
    return out


class _LazyHeap:
    """Mergeable min-heap with lazy deletion over (value, id) pairs."""

    __slots__ = ("h",)

    def __init__(self):
        self.h: List[Tuple[float, int]] = []

    def push(self, val, pid):
        heapq.heappush(self.h, (val, pid))

    def absorb(self, other: "_LazyHeap"):
        if len(other.h) > len(self.h):
            self.h, other.h = other.h, self.h
        for item in other.h:
            heapq.heappush(self.h, item)
        other.h = []

    def peek_alive(self, dead):
        h = self.h
        while h and dead[h[0][1]]:
            heapq.heappop(h)
        return h[0][0] if h else None


# ---------------------------------------------------------------------------
# main extractor
# ---------------------------------------------------------------------------

@dataclass
class NodeStats:
    """Raw per-node accumulators (pre-serialization)."""

    area: np.ndarray
    border: np.ndarray
    bd: np.ndarray                  # one-sided boundary pixel count
    bbox_lo: np.ndarray             # [M, D] ITK coords (x fastest)
    bbox_hi: np.ndarray
    vp: np.ndarray                  # [M, nT] pb>=thresh boundary counts
    r_stats: List[Dict[str, np.ndarray]]    # per r_image region stats
    rl_hist: List[np.ndarray]               # per rl_image hist counts [M, bins]
    b_stats: List[Dict[str, np.ndarray]]    # per b_image boundary stats
    saliency: Optional[np.ndarray]          # [M] or None


class TreeFeatures:
    def __init__(self, rag: Rag, order, cfg: FeatureConfig,
                 saliencies=None):
        self.rag = rag
        self.cfg = cfg
        self.order = np.asarray(order, dtype=np.int64).reshape(-1, 3)
        self.tree = build_tree(self.order)
        # node universe: tree nodes + isolated RAG regions not in the order
        key2node = {int(k): i for i, k in enumerate(self.tree.keys)}
        extra = [int(k) for k in rag.keys if int(k) not in key2node]
        self.node_keys = np.concatenate(
            [self.tree.keys, np.asarray(extra, dtype=np.int64)])
        for j, k in enumerate(extra):
            key2node[k] = self.tree.n_nodes + j
        self.key2node = key2node
        self.M = len(self.node_keys)
        self.ndim = len(rag.shape)
        self._saliencies = saliencies
        self._compute()

    # -- setup helpers ---------------------------------------------------

    def _leaf_region_scatter(self):
        rag = self.rag
        if rag.region_ptr is None:
            raise ValueError("RAG must be built with contour_only=False "
                             "for feature extraction")
        rid = np.repeat(np.arange(rag.n_regions), np.diff(rag.region_ptr))
        node_of_region = np.array(
            [self.key2node[int(k)] for k in rag.keys], dtype=np.int64)
        return node_of_region[rid], rag.region_pixels

    def _pixel_coords(self, flat_idx):
        """ITK-order coords: coord[0]=x (last numpy axis), etc."""
        shape = self.rag.shape
        coords = np.unravel_index(flat_idx, shape)
        # numpy axis ndim-1 is ITK dim 0
        return np.stack([coords[self.ndim - 1 - d] for d in range(self.ndim)],
                        axis=1).astype(np.float64)

    def _compute(self):
        rag, cfg, tree = self.rag, self.cfg, self.tree
        M, D = self.M, self.ndim
        nT = len(cfg.boundary_thresholds)
        pb = np.asarray(cfg.pb_image, dtype=np.float64).ravel()

        # ---------- leaf region stats ----------
        nid, pix = self._leaf_region_scatter()
        area = np.zeros(M)
        np.add.at(area, nid, 1.0)
        coords = self._pixel_coords(pix)
        bbox_lo = np.full((M, D), POS_INF)
        bbox_hi = np.full((M, D), NEG_INF)
        for d in range(D):
            np.minimum.at(bbox_lo[:, d], nid, coords[:, d])
            np.maximum.at(bbox_hi[:, d], nid, coords[:, d])

        r_stats = []
        for img in cfg.r_images:
            vals = np.asarray(img.image, dtype=np.float64).ravel()[pix]
            r_stats.append(group_stats(vals, nid, M, img.hist_bins,
                                       img.hist_range))
        rl_hist = []
        for img in cfg.rl_images:
            vals = np.asarray(img.image, dtype=np.float64).ravel()[pix]
            st = group_stats(vals, nid, M, img.hist_bins, img.hist_range)
            rl_hist.append(st["hist"])

        # ---------- border ----------
        border = np.zeros(M)
        border_nid = np.array(
            [self.key2node[int(k)] for k in rag.keys], dtype=np.int64)
        np.add.at(border, border_nid, np.diff(rag.border_ptr).astype(np.float64))

        # ---------- directed pair stats ----------
        Ed = len(rag.dir_pairs)
        dpid = np.repeat(np.arange(Ed), np.diff(rag.dir_ptr))
        dp_pb = pb[rag.dir_pixels]
        dp_cnt = np.diff(rag.dir_ptr).astype(np.float64)
        dp_vp = np.zeros((Ed, nT))
        for t, th in enumerate(cfg.boundary_thresholds):
            np.add.at(dp_vp[:, t], dpid, (dp_pb >= th).astype(np.float64))
        dp_b = []
        for img in cfg.b_images:
            vals = np.asarray(img.image, dtype=np.float64).ravel()[rag.dir_pixels]
            dp_b.append(group_stats(vals, dpid, Ed, img.hist_bins,
                                    img.hist_range))

        # ---------- pair liveness: LCA of each directed pair ----------
        # classify directed pairs: mutual (edge exists both ways) vs not
        dir_code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
        rev_code = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
        sorted_codes = np.sort(dir_code)
        mutual = np.searchsorted(sorted_codes, rev_code) < len(sorted_codes)
        mutual &= sorted_codes[
            np.minimum(np.searchsorted(sorted_codes, rev_code),
                       len(sorted_codes) - 1)] == rev_code

        tree_n = tree.n_nodes
        na = np.array([self.key2node.get(int(a), -1)
                       for a in rag.dir_pairs[:, 0]], dtype=np.int64)
        nb = np.array([self.key2node.get(int(b), -1)
                       for b in rag.dir_pairs[:, 1]], dtype=np.int64)
        na = np.where((na >= 0) & (na < tree_n), na, -1)
        nb = np.where((nb >= 0) & (nb < tree_n), nb, -1)
        self.dp_lca = pairs_lca(tree, na, nb)
        self.dp_mutual = mutual

        # dying lists per internal node: mutual pairs die at their LCA
        dying: Dict[int, List[int]] = {}
        for e in range(Ed):
            if mutual[e] and self.dp_lca[e] >= 0:
                dying.setdefault(int(self.dp_lca[e]), []).append(e)
        self.dying = dying

        # leaf one-sided boundary init: every directed pair (a,b) belongs to
        # leaf node of a
        own_node = np.array(
            [self.key2node.get(int(a), -1) for a in rag.dir_pairs[:, 0]],
            dtype=np.int64)
        bd = np.zeros(M)
        vp = np.zeros((M, nT))
        b_stats = [
            {"cnt": np.zeros(M), "sum": np.zeros(M), "sumsq": np.zeros(M),
             "min": np.full(M, POS_INF), "max": np.full(M, NEG_INF),
             "hist": np.zeros((M, img.hist_bins))}
            for img in cfg.b_images
        ]
        valid_dp = own_node >= 0
        np.add.at(bd, own_node[valid_dp], dp_cnt[valid_dp])
        np.add.at(vp, own_node[valid_dp], dp_vp[valid_dp])
        for bi, st in enumerate(dp_b):
            np.add.at(b_stats[bi]["cnt"], own_node[valid_dp], st["cnt"][valid_dp])
            np.add.at(b_stats[bi]["sum"], own_node[valid_dp], st["sum"][valid_dp])
            np.add.at(b_stats[bi]["sumsq"], own_node[valid_dp],
                      st["sumsq"][valid_dp])
            np.add.at(b_stats[bi]["hist"], own_node[valid_dp],
                      st["hist"][valid_dp])
            np.minimum.at(b_stats[bi]["min"], own_node[valid_dp],
                          st["min"][valid_dp])
            np.maximum.at(b_stats[bi]["max"], own_node[valid_dp],
                          st["max"][valid_dp])

        # min/max heaps per component (small-to-large)
        n_b = len(cfg.b_images)
        dead = np.zeros(Ed, dtype=bool)
        heaps_min = [[_LazyHeap() for _ in range(M)] for _ in range(n_b)]
        heaps_max = [[_LazyHeap() for _ in range(M)] for _ in range(n_b)]
        for bi, st in enumerate(dp_b):
            for e in range(Ed):
                n = own_node[e]
                if n >= 0 and st["cnt"][e] > 0:
                    heaps_min[bi][n].push(st["min"][e], e)
                    heaps_max[bi][n].push(-st["max"][e], e)

        # ---------- vectorized bottom-up aggregation (DFS intervals) -----
        # children precede parents in creation order, but the fully
        # vectorized route uses the DFS-interval identity: each tree
        # node's leaves are one contiguous interval, so additive stats are
        # prefix-sum differences and min/max are sparse-table range
        # queries.  Dying-pair subtractions use the same identity over
        # pair LCAs sorted by pre-order position.
        leaf_pos, lo_iv, hi_iv, leaf_order = dfs_intervals(tree)
        tn = tree_n
        tidx = np.arange(tn)

        def leaf_sums(values):
            """values [M, ...] (leaf entries valid) -> tree-node sums."""
            lv = values[leaf_order]
            return _np_interval_sums(lv, lo_iv[:tn], hi_iv[:tn])

        def leaf_reduce(values, kind):
            lv = values[leaf_order]
            return _np_interval_reduce(lv, lo_iv[:tn], hi_iv[:tn], kind)

        area[:tn] = leaf_sums(area)
        border[:tn] = leaf_sums(border)
        bbox_lo[:tn] = leaf_reduce(bbox_lo, "min")
        bbox_hi[:tn] = leaf_reduce(bbox_hi, "max")
        for st in r_stats:
            for k in ("cnt", "sum", "sumsq", "hist"):
                st[k][:tn] = leaf_sums(st[k])
            st["min"][:tn] = leaf_reduce(st["min"], "min")
            st["max"][:tn] = leaf_reduce(st["max"], "max")
        for h in rl_hist:
            h[:tn] = leaf_sums(h)

        # dying-pair subtractions: pair dies at node n for all ancestors
        # of-or-equal n, i.e. nodes whose pre-order interval contains
        # pre_lo[lca].  Sort dying pairs by that position; per-node dying
        # totals are prefix-sum interval differences.
        pre_lo = np.zeros(tn, dtype=np.int64)
        pre_hi = np.zeros(tn, dtype=np.int64)
        counter = 0
        roots = [i for i in range(tn) if tree.parent[i] < 0]
        for root in roots:
            stack = [(root, False)]
            while stack:
                node, done = stack.pop()
                if done:
                    pre_hi[node] = counter
                    continue
                pre_lo[node] = counter
                counter += 1
                stack.append((node, True))
                if tree.left[node] >= 0:
                    stack.append((int(tree.right[node]), False))
                    stack.append((int(tree.left[node]), False))

        die_ids = np.asarray(
            [e for e in range(Ed)
             if mutual[e] and self.dp_lca[e] >= 0], dtype=np.int64)
        die_pos = pre_lo[self.dp_lca[die_ids]] if len(die_ids) else \
            np.zeros(0, np.int64)
        ds = np.argsort(die_pos, kind="stable")
        die_ids_s = die_ids[ds]
        die_pos_s = die_pos[ds]
        a_q = np.searchsorted(die_pos_s, pre_lo[:tn], side="left")
        b_q = np.searchsorted(die_pos_s, pre_hi[:tn], side="left")

        def dying_sums(values):
            """values [Ed, ...] -> per-tree-node sums over dying pairs in
            each node's subtree."""
            dv = values[die_ids_s]
            P = np.concatenate([np.zeros((1,) + dv.shape[1:], dv.dtype),
                                np.cumsum(dv, axis=0)], axis=0)
            return P[b_q] - P[a_q]

        bd[:tn] = leaf_sums(bd) - dying_sums(dp_cnt)
        vp[:tn] = leaf_sums(vp) - dying_sums(dp_vp)
        for bi in range(n_b):
            st, dst = dp_b[bi], b_stats[bi]
            for k in ("cnt", "sum", "sumsq", "hist"):
                dst[k][:tn] = leaf_sums(dst[k]) - dying_sums(st[k])

        # boundary min/max: sequential mergeable-heap pass (the only
        # non-interval-decomposable statistic); pairs turn dead exactly at
        # their LCA so ancestors' peeks skip them
        for i in range(tn):
            l, r = int(tree.left[i]), int(tree.right[i])
            if l < 0:
                continue
            for e in dying.get(i, []):
                dead[e] = True
            for bi in range(n_b):
                dst = b_stats[bi]
                hm = heaps_min[bi][i]
                hm.absorb(heaps_min[bi][l])
                hm.absorb(heaps_min[bi][r])
                hx = heaps_max[bi][i]
                hx.absorb(heaps_max[bi][l])
                hx.absorb(heaps_max[bi][r])
                mn = hm.peek_alive(dead)
                mx = hx.peek_alive(dead)
                dst["min"][i] = mn if mn is not None else POS_INF
                dst["max"][i] = -mx if mx is not None else NEG_INF

        # ---------- exact medians (median_as_feats) ----------
        self._r_median = None
        self._b_median = None
        if cfg.median_as_feats:
            self._compute_medians(own_node, dp_cnt)

        # saliency map (genSaliencyMap, bc_feat.hxx:13-26)
        sal = None
        if self._saliencies is not None:
            saliencies = np.asarray(self._saliencies, dtype=np.float64)
            sal = np.full(M, cfg.init_saliency)
            internal = np.nonzero(~tree.is_leaf)[0]
            sal[internal] = saliencies[: len(internal)] + cfg.saliency_bias

        self.stats = NodeStats(
            area=area, border=border, bd=bd, bbox_lo=bbox_lo,
            bbox_hi=bbox_hi, vp=vp, r_stats=r_stats, rl_hist=rl_hist,
            b_stats=b_stats, saliency=sal,
        )
        self._dp_cnt = dp_cnt
        self._dp_vp = dp_vp
        self._dp_b = dp_b
        self._own_node = own_node

    def _compute_medians(self, own_node, dp_cnt):
        """Exact per-node medians (stats::amedian upper median) for region
        and one-sided-boundary pixel sets.

        Regions: leaves in DFS order make every node's pixels a contiguous
        range of the leaf-ordered pixel array -> np.partition per range.
        Boundaries: a pair is alive at n iff its owner leaf is under n and
        (for mutual pairs) its LCA is not; gather alive pairs per node.
        O(total region/boundary footprint) -- a parity mode, not the fast
        path (reference flag GLIA_HMT_MEDIAN_FEAT default OFF).
        """
        rag, cfg, tree = self.rag, self.cfg, self.tree
        M = self.M

        leaf_pos, lo, hi, leaf_order = dfs_intervals(tree)
        # extra (isolated) nodes: give them their own slots after tree leaves
        extra_nodes = np.arange(tree.n_nodes, M)
        # region pixel array ordered by leaf DFS (then extras)
        key_of_node = self.node_keys
        region_row = {int(k): i for i, k in enumerate(rag.keys)}
        ordered_nodes = [int(n) for n in leaf_order] + list(extra_nodes)
        pix_chunks = []
        node_plo = np.zeros(M, dtype=np.int64)
        node_phi = np.zeros(M, dtype=np.int64)
        # leaf pixel ranges in concat order
        starts = {}
        off = 0
        for n in ordered_nodes:
            ri = region_row.get(int(key_of_node[n]))
            if ri is None:
                starts[n] = (off, off)
                continue
            s, e = int(rag.region_ptr[ri]), int(rag.region_ptr[ri + 1])
            pix_chunks.append(rag.region_pixels[s:e])
            starts[n] = (off, off + (e - s))
            off += e - s
        pix_order = np.concatenate(pix_chunks) if pix_chunks else \
            np.zeros(0, np.int64)
        # prefix offsets per leaf DFS slot -> node intervals
        leaf_off = np.zeros(len(leaf_order) + 1, dtype=np.int64)
        for i, n in enumerate(leaf_order):
            leaf_off[i + 1] = leaf_off[i] + (starts[int(n)][1]
                                             - starts[int(n)][0])
        for n in range(tree.n_nodes):
            node_plo[n] = leaf_off[lo[n]]
            node_phi[n] = leaf_off[hi[n]]
        for n in extra_nodes:
            node_plo[n], node_phi[n] = starts[int(n)]

        def upper_median_ranges(vals):
            out = np.zeros(M)
            for n in range(M):
                a, b = node_plo[n], node_phi[n]
                if b > a:
                    seg = vals[a:b]
                    out[n] = np.partition(seg, (b - a) // 2)[(b - a) // 2]
                else:
                    out[n] = -1.0  # DUMMY
            return out

        self._r_median = []
        for img in cfg.r_images:
            vals = np.asarray(img.image, np.float64).ravel()[pix_order]
            self._r_median.append(upper_median_ranges(vals))

        # boundary medians: alive pairs per node
        Ed = len(rag.dir_pairs)
        # node pre-order positions for "lca under n" tests
        pre = np.zeros(tree.n_nodes, dtype=np.int64)
        counter = 0
        roots = [i for i in range(tree.n_nodes) if tree.parent[i] < 0]
        pre_lo = np.zeros(tree.n_nodes, dtype=np.int64)
        pre_hi = np.zeros(tree.n_nodes, dtype=np.int64)
        for root in roots:
            stack = [(root, False)]
            while stack:
                node, done = stack.pop()
                if done:
                    pre_hi[node] = counter
                    continue
                pre_lo[node] = counter
                counter += 1
                stack.append((node, True))
                if tree.left[node] >= 0:
                    stack.append((int(tree.right[node]), False))
                    stack.append((int(tree.left[node]), False))
        pair_vals = []
        pb_cache = [np.asarray(img.image, np.float64).ravel()
                    for img in cfg.b_images]
        for e in range(Ed):
            s, t = int(rag.dir_ptr[e]), int(rag.dir_ptr[e + 1])
            pair_vals.append([c[rag.dir_pixels[s:t]] for c in pb_cache])
        leafpos_of_pair = np.full(Ed, -1, dtype=np.int64)
        for e in range(Ed):
            n = own_node[e]
            if 0 <= n < tree.n_nodes:
                leafpos_of_pair[e] = leaf_pos[n]
        self._b_median = [np.full(M, -1.0) for _ in cfg.b_images]
        pair_ids_by_node = [[] for _ in range(M)]
        for e in range(Ed):
            n = own_node[e]
            if n < 0:
                continue
            if n >= tree.n_nodes:
                pair_ids_by_node[n].append(e)
                continue
            i = int(n)
            stop = int(self.dp_lca[e]) if (self.dp_mutual[e]
                                           and self.dp_lca[e] >= 0) else -1
            while i >= 0 and i != stop:
                pair_ids_by_node[i].append(e)
                i = int(tree.parent[i])
        for bi in range(len(cfg.b_images)):
            for n in range(M):
                ids = pair_ids_by_node[n]
                if not ids:
                    continue
                vals = np.concatenate([pair_vals[e][bi] for e in ids])
                if len(vals):
                    k = len(vals) // 2
                    self._b_median[bi][n] = np.partition(vals, k)[k]
        # pair-boundary medians per merge (dying pairs at each lca)
        n_merges = len(self.order)
        node_of_merge = np.nonzero(~tree.is_leaf)[0]
        merge_of_node = {int(nd): mi for mi, nd in enumerate(node_of_merge)}
        self._pair_median = [np.full(n_merges, -1.0)
                             for _ in cfg.b_images]
        by_merge = [[] for _ in range(n_merges)]
        for e in range(Ed):
            mi = merge_of_node.get(int(self.dp_lca[e]), -1)
            if mi >= 0:
                by_merge[mi].append(e)
        for bi in range(len(cfg.b_images)):
            for mi in range(n_merges):
                if not by_merge[mi]:
                    continue
                vals = np.concatenate(
                    [pair_vals[e][bi] for e in by_merge[mi]])
                if len(vals):
                    k = len(vals) // 2
                    self._pair_median[bi][mi] = np.partition(vals, k)[k]

    # -- serialization ---------------------------------------------------

    def _image_feats_block(self, st, idx, n_bins, median=None):
        """ImageFeats serialize (feat.hxx:846-855): [hist?] entropy,
        [median?] mean, stddev, min, max.  Empty sets -> zeros
        (ImageRealFeats early-return, feat.hxx:703)."""
        cfg = self.cfg
        cnt = st["cnt"][idx]
        ok = cnt > 0
        mean = np.where(ok, st["sum"][idx] / np.where(ok, cnt, 1), 0.0)
        var = np.where(ok, st["sumsq"][idx] / np.where(ok, cnt, 1)
                       - mean * mean, 0.0)
        std = np.sqrt(np.maximum(var, 0.0))
        mn = np.where(ok, st["min"][idx], 0.0)
        mx = np.where(ok, st["max"][idx], 0.0)
        ent = _entropy_rows(st["hist"][idx], cnt)
        ent = np.where(ok, ent, 0.0)
        cols = []
        if cfg.histogram_as_feats:
            h = st["hist"][idx] / np.where(ok, cnt, 1)[:, None]
            h = np.where(ok[:, None], h, 0.0)
            cols.append(h)
        cols.append(ent[:, None])
        if cfg.median_as_feats:
            if median is None:
                raise ValueError("median arrays not computed")
            med = np.where(ok, np.asarray(median)[idx], 0.0)
            cols.append(med[:, None])
        cols += [mean[:, None], std[:, None], mn[:, None], mx[:, None]]
        return np.concatenate(cols, axis=1)

    def _label_feats_block(self, hist, idx, totals):
        cfg = self.cfg
        cnt = totals[idx]
        ok = cnt > 0
        ent = np.where(ok, _entropy_rows(hist[idx], cnt), 0.0)
        if cfg.histogram_as_feats:
            h = hist[idx] / np.where(ok, cnt, 1)[:, None]
            h = np.where(ok[:, None], h, 0.0)
            return np.concatenate([h, ent[:, None]], axis=1)
        return ent[:, None]

    def region_features(self, with_saliency=None) -> np.ndarray:
        """RegionFeats matrix [M, Dr] in reference serialize order
        (bc_feat.hxx:71-80)."""
        cfg, st = self.cfg, self.stats
        M, D = self.M, self.ndim
        idx = np.arange(M)
        nA, nL = cfg.normalizing_area, cfg.normalizing_length

        area_raw = st.area
        perim_raw = st.bd + st.border
        with np.errstate(divide="ignore", invalid="ignore"):
            compact = np.where(
                np.abs(area_raw) >= FEPS,
                np.power(perim_raw, D / (D - 1.0)) / np.where(
                    np.abs(area_raw) >= FEPS, area_raw, 1.0),
                0.0)
        area = area_raw / nA
        perim = perim_raw / nL
        # bbox size = hi - lo (reference quirk: no +1, alg/geometry.hxx:36-39)
        bsz = st.bbox_hi - st.bbox_lo
        bsz = np.where(np.isfinite(bsz), bsz, 0.0)
        bbox_area = np.prod(bsz, axis=1) / nA
        bsz_n = bsz / nL
        vp = st.vp / nL
        rvp = sdivide(st.vp, st.bd[:, None], 0.0)
        cols = [area[:, None], perim[:, None], compact[:, None],
                bbox_area[:, None], bsz_n, vp, rvp]
        if cfg.use_log_shape:
            # RegionShapeFeats::log + ImageRegionShapeFeats::log
            # (feat.hxx:46-52, 544-548): log area/perim/bboxArea/bboxSize/
            # validPerims; compactness and rValidPerims stay linear.
            cols[0] = slog(cols[0], 0.0)
            cols[1] = slog(cols[1], 0.0)
            cols[3] = slog(cols[3], 0.0)
            cols[4] = slog(cols[4], 0.0)
            cols[5] = slog(cols[5], 0.0)
        for i, img in enumerate(cfg.r_images):
            cols.append(self._image_feats_block(
                st.r_stats[i], idx, img.hist_bins,
                median=self._r_median[i] if cfg.median_as_feats else None))
        for i, img in enumerate(cfg.rl_images):
            cols.append(self._label_feats_block(st.rl_hist[i], idx, st.area))
        for i, img in enumerate(cfg.b_images):
            cols.append(self._image_feats_block(
                st.b_stats[i], idx, img.hist_bins,
                median=self._b_median[i] if cfg.median_as_feats else None))
        if st.saliency is not None and with_saliency is not False:
            cols.append(st.saliency[:, None])
        return np.concatenate(cols, axis=1)

    # ---- pair-boundary (per-merge) stats -------------------------------

    def _merge_boundary_stats(self):
        """Per-merge pair boundary = all directed pairs whose LCA is that
        merge's node (getBoundary over both sides, util/struct.hxx:11-16)."""
        cfg = self.cfg
        n = len(self.order)
        nT = len(cfg.boundary_thresholds)
        tree = self.tree
        node_of_merge = np.nonzero(~tree.is_leaf)[0]
        cnt = np.zeros(n)
        vp = np.zeros((n, nT))
        b = [
            {"cnt": np.zeros(n), "sum": np.zeros(n), "sumsq": np.zeros(n),
             "min": np.full(n, POS_INF), "max": np.full(n, NEG_INF),
             "hist": np.zeros((n, img.hist_bins))}
            for img in cfg.b_images
        ]
        # vectorized: map pair LCAs -> merge indices, scatter-accumulate
        node_to_merge = np.full(tree.n_nodes, -1, dtype=np.int64)
        node_to_merge[node_of_merge] = np.arange(n)
        lca = np.asarray(self.dp_lca)
        mi = np.where(lca >= 0, node_to_merge[np.maximum(lca, 0)], -1)
        ok = mi >= 0
        mio = mi[ok]
        np.add.at(cnt, mio, self._dp_cnt[ok])
        np.add.at(vp, mio, self._dp_vp[ok])
        for bi, st in enumerate(self._dp_b):
            np.add.at(b[bi]["cnt"], mio, st["cnt"][ok])
            np.add.at(b[bi]["sum"], mio, st["sum"][ok])
            np.add.at(b[bi]["sumsq"], mio, st["sumsq"][ok])
            np.add.at(b[bi]["hist"], mio, st["hist"][ok])
            nz = ok & (st["cnt"] > 0)
            np.minimum.at(b[bi]["min"], mi[nz], st["min"][nz])
            np.maximum.at(b[bi]["max"], mi[nz], st["max"][nz])
        return cnt, vp, b

    def boundary_features(self) -> np.ndarray:
        """BoundaryFeats matrix [n_merges, Db] (bc_feat.hxx:183-215), with
        the r0/r1 area-ordering applied (main_bc_feat.cxx:86-89)."""
        cfg, st = self.cfg, self.stats
        tree = self.tree
        n = len(self.order)
        nL = cfg.normalizing_length
        node_of_merge = np.nonzero(~tree.is_leaf)[0]
        n0 = tree.left[node_of_merge].astype(np.int64)
        n1 = tree.right[node_of_merge].astype(np.int64)
        n2 = node_of_merge.astype(np.int64)

        # area ordering: region 0 = smaller area (main_bc_feat.cxx:86-89);
        # note comparison uses *normalized* shape areas
        a0 = st.area[n0] / cfg.normalizing_area
        a1 = st.area[n1] / cfg.normalizing_area
        swap = a0 > a1
        n0s = np.where(swap, n1, n0)
        n1s = np.where(swap, n0, n1)
        self._bc_n0, self._bc_n1, self._bc_n2 = n0s, n1s, n2

        area0 = st.area[n0s] / cfg.normalizing_area
        area1 = st.area[n1s] / cfg.normalizing_area
        perim0 = (st.bd + st.border)[n0s] / nL
        perim1 = (st.bd + st.border)[n1s] / nL

        bcnt, bvp, bst = self._merge_boundary_stats()

        area_diff = np.abs(area0 - area1)
        r_area0 = sdivide(area_diff, area0, 0.0)
        r_area1 = sdivide(area_diff, area1, 0.0)
        perim_diff = np.abs(perim0 - perim1)
        r_perim0 = sdivide(perim_diff, perim0, 0.0)
        r_perim1 = sdivide(perim_diff, perim1, 0.0)
        blen = np.ceil(bcnt / 2.0) / nL
        r_bl_a0 = sdivide(blen, area0, 0.0)
        r_bl_a1 = sdivide(blen, area1, 0.0)
        r_bl_p0 = sdivide(blen, perim0, 0.0)
        r_bl_p1 = sdivide(blen, perim1, 0.0)
        cols = [area_diff, r_area0, r_area1, perim_diff, r_perim0, r_perim1,
                blen, r_bl_a0, r_bl_a1, r_bl_p0, r_bl_p1]
        cols = [c[:, None] for c in cols]
        vbl = np.ceil(bvp / 2.0) / nL
        cols.append(vbl)
        cols.append(sdivide(vbl, blen[:, None], 0.0))
        cols.append(sdivide(vbl, perim0[:, None], 0.0))
        cols.append(sdivide(vbl, perim1[:, None], 0.0))
        if cfg.use_log_shape:
            # RegionShapeIntraDiffFeats::log (feat.hxx:150-153,531-535):
            # log areaDiff, perimDiff, boundaryLength, validBoundaryLengths
            cols[0] = slog(cols[0], 0.0)
            cols[3] = slog(cols[3], 0.0)
            cols[6] = slog(cols[6], 0.0)
            cols[11] = slog(cols[11], 0.0)

        # per r_image ImageDiffFeats (feat.hxx:886-899 + 762-800):
        # [histL1, histX2, entropyDiff, (medianDiff), meanDiff, stdDiff,
        #  minDiff, maxDiff]
        for i, img in enumerate(cfg.r_images):
            rst = st.r_stats[i]
            med = self._r_median[i] if cfg.median_as_feats else None
            f0 = self._image_feats_block(rst, n0s, img.hist_bins, med)
            f1 = self._image_feats_block(rst, n1s, img.hist_bins, med)
            h0 = rst["hist"][n0s] / np.maximum(rst["cnt"][n0s], 1)[:, None]
            h1 = rst["hist"][n1s] / np.maximum(rst["cnt"][n1s], 1)[:, None]
            l1 = np.abs(h0 - h1).sum(axis=1)
            x2 = (np.square(h0 - h1) / (h0 + h1 + FEPS)).sum(axis=1)
            off = img.hist_bins if cfg.histogram_as_feats else 0
            # block layout: [hist?] entropy, [median], mean, std, min, max
            d = np.abs(f0[:, off:] - f1[:, off:])
            cols.append(np.concatenate(
                [np.stack([l1, x2], axis=1), d], axis=1))
        # per rl_image ImageLabelDiffFeats (feat.hxx:645-658)
        for i, img in enumerate(cfg.rl_images):
            h = st.rl_hist[i]
            c0 = np.maximum(st.area[n0s], 1)[:, None]
            c1 = np.maximum(st.area[n1s], 1)[:, None]
            h0 = h[n0s] / c0
            h1 = h[n1s] / c1
            l1 = np.abs(h0 - h1).sum(axis=1)
            x2 = (np.square(h0 - h1) / (h0 + h1 + FEPS)).sum(axis=1)
            e0 = _entropy_rows(h[n0s], st.area[n0s])
            e1 = _entropy_rows(h[n1s], st.area[n1s])
            cols.append(np.stack([l1, x2, np.abs(e0 - e1)], axis=1))
        # per b_image ImageFeats over the pair boundary
        for bi, img in enumerate(cfg.b_images):
            cols.append(self._image_feats_block(
                bst[bi], np.arange(n), img.hist_bins,
                median=self._pair_median[bi] if cfg.median_as_feats
                else None))
        # saliency pair
        if st.saliency is not None:
            d02 = np.abs(st.saliency[n0s] - st.saliency[n2])
            d12 = np.abs(st.saliency[n1s] - st.saliency[n2])
            cols.append(np.minimum(d02, d12)[:, None])
            cols.append(np.maximum(d02, d12)[:, None])
        return np.concatenate(cols, axis=1)

    def bc_features(self) -> np.ndarray:
        """BoundaryClassificationFeats [n_merges, Db + 3*Dr]
        (bc_feat.hxx:219-243): boundary ++ region0 ++ region1 ++ merged."""
        bf = self.boundary_features()
        rf = self.region_features()
        return np.concatenate(
            [bf, rf[self._bc_n0], rf[self._bc_n1], rf[self._bc_n2]], axis=1)

    def simple_features(self) -> np.ndarray:
        """selectFeatures "arXiv paper" subset (bc_feat.hxx:247-279)."""
        cfg, st = self.cfg, self.stats
        bf = self.boundary_features()  # also sets _bc_n*
        n0, n1, n2 = self._bc_n0, self._bc_n1, self._bc_n2
        nT = len(cfg.boundary_thresholds)
        area0 = st.area[n0] / cfg.normalizing_area
        area1 = st.area[n1] / cfg.normalizing_area
        perim0 = (st.bd + st.border)[n0] / cfg.normalizing_length
        perim1 = (st.bd + st.border)[n1] / cfg.normalizing_length
        if cfg.use_log_shape:
            area0 = slog(area0, 0.0)
            area1 = slog(area1, 0.0)
            perim0 = slog(perim0, 0.0)
            perim1 = slog(perim1, 0.0)
        blen = bf[:, 6]
        cols = [area0, area1, perim0, perim1, blen]
        # per b_image boundary mean: locate in bf layout
        shape_dim = 11 + 4 * nT
        per_r = 7 + (1 if cfg.median_as_feats else 0)
        off = shape_dim + per_r * len(cfg.r_images) + 3 * len(cfg.rl_images)
        for bi, img in enumerate(cfg.b_images):
            base = off + sum(cfg.image_feats_dim(cfg.b_images[j])
                             for j in range(bi))
            med_off = 1 if cfg.median_as_feats else 0
            mean_col = base + cfg.label_feats_dim(img) + med_off
            cols.append(bf[:, mean_col])
            if cfg.median_as_feats:
                # selectFeatures pushes bf->median after mean
                # (bc_feat.hxx:265-268)
                cols.append(bf[:, base + cfg.label_feats_dim(img)])
        # per r_image: meanDiff, histL1, histX2, entropyDiff
        for ri in range(len(cfg.r_images)):
            base = shape_dim + per_r * ri
            cols.append(bf[:, base + 3])  # meanDiff
            cols.append(bf[:, base + 0])  # histDistL1
            cols.append(bf[:, base + 1])  # histDistX2
            cols.append(bf[:, base + 2])  # entropyDiff
        for li in range(len(cfg.rl_images)):
            base = shape_dim + per_r * len(cfg.r_images) + 3 * li
            cols.append(bf[:, base + 0])
            cols.append(bf[:, base + 1])
        return np.stack(cols, axis=1)
