"""Sharded full-width BC feature extraction and forest scoring over a
merge tree (counterpart of glia_tpu.parallel.bc_tree_shard; reference:
code/hmt/main_bc_feat.cxx:27-109).

The single-process extractors (features/hierarchical.py on the host,
ops/tree_scan.py on the device) compute per-node records from each
node's leaf set.  Here leaves and directed boundary pairs are
partitioned over the ranks, and node records are assembled with the same
ragged-halo routing as parallel/halo.py:

  - the node universe at tree level ``l`` is the nodes alive at l
    (level(n) <= l < level(parent)); every leaf / pair contribution is
    keyed by its alive ancestor through a host-computed lut;
  - each rank segment-reduces its leaves and directed pairs into
    per-component partial rows (additive fields summed in a fixed order,
    kernel B2's sorted entry on the card; min / max fields by
    scatter-min / max), sends the partial rows of components another rank
    owns to their owner with one ragged ``all_to_all`` per combine kind,
    and owners combine them;
  - one more ``all_to_all`` fetches the authoritative child-node rows a
    merge's owner needs for assembly;
  - the owner assembles the full-width BoundaryClassificationFeats row
    (features/device.py ``bc_features_dev``) and scores it with the
    forest (``models.forest.make_label_scorer``: kernel B1 on the card).

The host planning (``TreeShardPlan``, the routing tables) is glia_tpu's,
the same on every rank; every rank returns the same full result.

Semantics: node record = the reference's RegionFeats inputs over the
node's pixel set (code/hmt/bc_feat.hxx:46-128); pair record = all
directed boundary pairs whose merge-tree LCA is the merge's node
(code/util/struct.hxx:11-16 getBoundary both sides).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import default_dtype
from ..features.config import FeatureConfig
from ..features.device import DeviceFeatureSpec, bc_features_dev
from ..features.hierarchical import group_stats
from ..graph.rag import Rag
from ..graph.tree import build_tree, pairs_lca
from ..ops.segment_csr import segment_order, segment_sum_ordered
from .halo import fold_order, owner_fold
from .mesh import Mesh, to_device

POS_INF = np.inf
NEG_INF = -np.inf


class FieldPack:
    """Flatten named [N, ...] stat fields into one [N, F] matrix."""

    def __init__(self):
        self.slices: Dict[str, tuple] = {}
        self.width = 0

    def add(self, name, shape):
        k = int(np.prod(shape)) if shape else 1
        self.slices[name] = (self.width, self.width + k, tuple(shape))
        self.width += k

    def pack(self, n_rows, fields):
        out = np.zeros((n_rows, self.width))
        for name, arr in fields.items():
            a, b, shape = self.slices[name]
            out[:, a:b] = np.asarray(arr).reshape(n_rows, b - a)
        return out

    def unpack(self, mat, name):
        a, b, shape = self.slices[name]
        col = mat[..., a:b]
        return col.reshape(col.shape[:-1] + shape) if shape else col[..., 0]


def _ragged_routes(n, contrib_s, contrib_c, owner, universe_size):
    """Send routing for (source shard, comp) partial rows -> owners.

    Returns (send_ids [n, n, H] global comp ids or -1,
             recv_local [n, n, H] owner-local rows or -1,
             own_ids [n, C_own_max], local_of_global [universe]).
    Owner-local numbering: owned comps sorted by global id.
    """
    owner = np.asarray(owner, np.int64)
    # owner-local numbering (deterministic: sorted by comp id)
    local_of_global = np.full(universe_size, -1, np.int64)
    own_lists = []
    for s in range(n):
        mine = np.nonzero(owner == s)[0]
        local_of_global[mine] = np.arange(len(mine))
        own_lists.append(mine)
    C_own = max(max((len(m) for m in own_lists), default=1), 1)
    own_ids = np.full((n, C_own), -1, np.int32)
    for s, mine in enumerate(own_lists):
        own_ids[s, : len(mine)] = mine

    cs = np.asarray(contrib_s, np.int64)
    cc = np.asarray(contrib_c, np.int64)
    keep = (cc >= 0) & (cc < universe_size)
    keep &= owner[np.where(keep, cc, 0)] >= 0
    cs, cc = cs[keep], cc[keep]
    codes = np.unique(cs * universe_size + cc)
    ts = codes // universe_size
    tc = codes % universe_size
    to = owner[tc]
    foreign = to != ts
    fs, fc, ft = ts[foreign], tc[foreign], to[foreign]
    grp = fs * n + ft
    order = np.argsort(grp * np.int64(universe_size) + fc, kind="stable")
    fs, fc, ft, grp = fs[order], fc[order], ft[order], grp[order]
    if len(grp):
        first = np.concatenate([[True], grp[1:] != grp[:-1]])
        gidx = np.cumsum(first) - 1
        starts = np.nonzero(first)[0]
        slot = np.arange(len(grp)) - starts[gidx]
        H = int(slot.max()) + 1
    else:
        slot = np.zeros(0, np.int64)
        H = 1
    send_ids = np.full((n, n, H), -1, np.int32)
    send_ids[fs, ft, slot] = fc
    recv_local = np.full((n, n, H), -1, np.int32)
    recv_local[ft, fs, slot] = local_of_global[fc]
    return send_ids, recv_local, own_ids, local_of_global


def _fetch_routes(n, need_s, need_c, owner, local_of_global, universe_size):
    """Fetch routing: shard s needs comp c's authoritative row.

    Returns (fetch_local [n(owner t), n(requester s), Hf] owner rows,
             slot_of [n, universe] halo slot per (s, c) or -1).
    """
    owner = np.asarray(owner, np.int64)
    ns = np.asarray(need_s, np.int64)
    nc = np.asarray(need_c, np.int64)
    keep = (nc >= 0) & (owner[np.maximum(nc, 0)] >= 0)
    ns, nc = ns[keep], nc[keep]
    to = owner[nc]
    foreign = to != ns
    fs, fc, ft = ns[foreign], nc[foreign], to[foreign]
    codes = np.unique(fs * universe_size + fc)
    fs = codes // universe_size
    fc = codes % universe_size
    ft = owner[fc]
    grp = fs * n + ft
    order = np.argsort(grp * np.int64(universe_size) + fc, kind="stable")
    fs, fc, ft, grp = fs[order], fc[order], ft[order], grp[order]
    if len(grp):
        first = np.concatenate([[True], grp[1:] != grp[:-1]])
        gidx = np.cumsum(first) - 1
        starts = np.nonzero(first)[0]
        slot = np.arange(len(grp)) - starts[gidx]
        Hf = int(slot.max()) + 1
    else:
        slot = np.zeros(0, np.int64)
        Hf = 1
    fetch_local = np.full((n, n, Hf), -1, np.int32)
    fetch_local[ft, fs, slot] = local_of_global[fc].astype(np.int32)
    slot_of = np.full((n, universe_size), -1, np.int64)
    slot_of[fs, fc] = ft * Hf + slot
    return fetch_local, slot_of, Hf


def _alive_lut(tree, level, l):
    """[n_nodes] -> alive ancestor at tree level ``l`` (nodes with
    level(n) <= l < level(parent); roots stay themselves)."""
    M = tree.n_nodes
    anc = np.arange(M, dtype=np.int64)
    par = tree.parent.astype(np.int64)
    for _ in range(int(level.max()) + 1):
        p = par[anc]
        step = (p >= 0) & (level[np.maximum(p, 0)] <= l)
        if not step.any():
            break
        anc = np.where(step, np.maximum(p, 0), anc)
    return anc


@dataclass
class _Pass:
    send_ids: np.ndarray
    recv_local: np.ndarray
    own_ids: np.ndarray
    local_of_global: np.ndarray
    leaf_comp: np.ndarray      # [n, Rl]
    dp_comp: np.ndarray        # [n, El] one-sided owner comp (or M)


class TreeShardPlan:
    """Host-side planning for the sharded tree feature pipeline."""

    def __init__(self, rag: Rag, order, cfg: FeatureConfig, part):
        self.rag = rag
        self.cfg = cfg
        self.part = part
        self.n = part.n_shards
        tree = build_tree(order)
        self.tree = tree
        M = tree.n_nodes
        self.M = M
        key2node = {int(k): i for i, k in enumerate(tree.keys)}
        # isolated regions never mentioned by the order contribute nowhere
        self.leaf_node = np.array(
            [key2node.get(int(k), -1) for k in rag.keys], np.int64)

        # node tree levels (children are created before parents)
        level = np.zeros(M, np.int64)
        for i in range(M):
            if tree.left[i] >= 0:
                level[i] = 1 + max(level[tree.left[i]],
                                   level[tree.right[i]])
        self.level = level

        # merge list: internal node i is merge (left, right -> i)
        internal = np.nonzero(~tree.is_leaf)[0]
        self.merge_node = internal.astype(np.int64)          # order index
        self.merge_level = level[internal]

        # node owner: majority leaf shard
        leaf_shard = part.region_shard.astype(np.int64)
        counts = np.zeros((M, self.n), np.int64)
        # propagate leaf counts up by creation order
        counts[self.leaf_node, leaf_shard] += 1
        for i in range(M):
            if tree.left[i] >= 0:
                counts[i] += counts[tree.left[i]] + counts[tree.right[i]]
        self.node_owner = np.argmax(counts, axis=1).astype(np.int64)

        # ---- per-shard leaf stat rows ----
        ndim = len(rag.shape)
        self.spec = DeviceFeatureSpec.from_config(cfg, ndim)
        spec = self.spec
        R = rag.n_regions
        rid = np.repeat(np.arange(R), np.diff(rag.region_ptr))
        pix = rag.region_pixels
        pb = np.asarray(cfg.pb_image, np.float64).ravel()

        la = FieldPack()
        la.add("area", ())
        la.add("border", ())
        la.add("r_cnt", (spec.n_r,))
        la.add("r_sum", (spec.n_r,))
        la.add("r_sumsq", (spec.n_r,))
        la.add("r_hist", (spec.n_r, max(spec.r_bins_max, 1)))
        la.add("rl_hist", (spec.n_rl, max(spec.rl_bins_max, 1)))
        if spec.median_as_feats:
            la.add("r_medh", (spec.n_r, spec.r_med_v))
        self.leaf_add_pack = la
        lm = FieldPack()
        lm.add("bbox_lo", (ndim,))
        lm.add("r_min", (spec.n_r,))
        self.leaf_min_pack = lm
        lx = FieldPack()
        lx.add("bbox_hi", (ndim,))
        lx.add("r_max", (spec.n_r,))
        self.leaf_max_pack = lx

        area = np.bincount(rid, minlength=R).astype(np.float64)
        border = np.diff(rag.border_ptr).astype(np.float64)
        coords_all = np.unravel_index(pix, rag.shape)
        coords = np.stack(
            [coords_all[ndim - 1 - d] for d in range(ndim)], 1).astype(
                np.float64)
        bbox_lo = np.full((R, ndim), POS_INF)
        bbox_hi = np.full((R, ndim), NEG_INF)
        for d in range(ndim):
            np.minimum.at(bbox_lo[:, d], rid, coords[:, d])
            np.maximum.at(bbox_hi[:, d], rid, coords[:, d])
        r_st = [group_stats(
            np.asarray(img.image, np.float64).ravel()[pix], rid, R,
            img.hist_bins, img.hist_range) for img in cfg.r_images]
        rl_h = [group_stats(
            np.asarray(img.image, np.float64).ravel()[pix], rid, R,
            img.hist_bins, img.hist_range)["hist"] for img in cfg.rl_images]

        def _pad_hists(hists, k, width):
            out = np.zeros((R, k, width))
            for i, h in enumerate(hists):
                out[:, i, : h.shape[1]] = h
            return out

        leaf_fields = {
            "area": area, "border": border,
            "r_cnt": np.stack([s["cnt"] for s in r_st], 1) if r_st else
            np.zeros((R, 0)),
            "r_sum": np.stack([s["sum"] for s in r_st], 1) if r_st else
            np.zeros((R, 0)),
            "r_sumsq": np.stack([s["sumsq"] for s in r_st], 1) if r_st else
            np.zeros((R, 0)),
            "r_hist": _pad_hists([s["hist"] for s in r_st], spec.n_r,
                                 max(spec.r_bins_max, 1)),
            "rl_hist": _pad_hists(rl_h, spec.n_rl,
                                  max(spec.rl_bins_max, 1)),
        }
        if spec.median_as_feats:
            from ..features.device import counting_hist

            r_medh = np.zeros((R, spec.n_r, spec.r_med_v))
            for i, img in enumerate(cfg.r_images):
                v = np.asarray(img.image, np.float64).ravel()[pix]
                r_medh[:, i, : len(spec.r_med_vals[i])] = counting_hist(
                    v, rid, R, spec.r_med_vals[i], len(spec.r_med_vals[i]))
            leaf_fields["r_medh"] = r_medh
        leaf_add = la.pack(R, leaf_fields)
        leaf_min = lm.pack(R, {
            "bbox_lo": bbox_lo,
            "r_min": np.stack([s["min"] for s in r_st], 1) if r_st else
            np.zeros((R, 0)),
        })
        leaf_max = lx.pack(R, {
            "bbox_hi": bbox_hi,
            "r_max": np.stack([s["max"] for s in r_st], 1) if r_st else
            np.zeros((R, 0)),
        })

        # ---- per-shard directed-pair stat rows ----
        Ed = len(rag.dir_pairs)
        dpid = np.repeat(np.arange(Ed), np.diff(rag.dir_ptr))
        dp_cnt = np.diff(rag.dir_ptr).astype(np.float64)
        dp_pb = pb[rag.dir_pixels]
        nT = spec.n_thresh
        dp_vp = np.zeros((Ed, nT))
        for t, th in enumerate(cfg.boundary_thresholds):
            np.add.at(dp_vp[:, t], dpid, (dp_pb >= th).astype(np.float64))
        dp_b = [group_stats(
            np.asarray(img.image, np.float64).ravel()[rag.dir_pixels],
            dpid, Ed, img.hist_bins, img.hist_range)
            for img in cfg.b_images]

        da = FieldPack()
        da.add("cnt", ())
        da.add("vp", (nT,))
        da.add("b_cnt", (spec.n_b,))
        da.add("b_sum", (spec.n_b,))
        da.add("b_sumsq", (spec.n_b,))
        da.add("b_hist", (spec.n_b, max(spec.b_bins_max, 1)))
        if spec.median_as_feats:
            da.add("b_medh", (spec.n_b, spec.b_med_v))
        self.dp_add_pack = da

        bh = np.zeros((Ed, spec.n_b, max(spec.b_bins_max, 1)))
        for i, s in enumerate(dp_b):
            bh[:, i, : s["hist"].shape[1]] = s["hist"]
        dp_fields = {
            "cnt": dp_cnt, "vp": dp_vp,
            "b_cnt": np.stack([s["cnt"] for s in dp_b], 1) if dp_b else
            np.zeros((Ed, 0)),
            "b_sum": np.stack([s["sum"] for s in dp_b], 1) if dp_b else
            np.zeros((Ed, 0)),
            "b_sumsq": np.stack([s["sumsq"] for s in dp_b], 1) if dp_b else
            np.zeros((Ed, 0)),
            "b_hist": bh,
        }
        if spec.median_as_feats:
            from ..features.device import counting_hist

            b_medh = np.zeros((Ed, spec.n_b, spec.b_med_v))
            for i, img in enumerate(cfg.b_images):
                v = np.asarray(img.image, np.float64).ravel()[rag.dir_pixels]
                b_medh[:, i, : len(spec.b_med_vals[i])] = counting_hist(
                    v, dpid, Ed, spec.b_med_vals[i],
                    len(spec.b_med_vals[i]))
            dp_fields["b_medh"] = b_medh
        dp_add = da.pack(Ed, dp_fields)
        # min/max rows: fill where the dp has no pixels of that image
        def _mm(key, fill):
            if not dp_b:
                return np.zeros((Ed, 0))
            v = np.stack([np.where(s["cnt"] > 0, s[key], fill)
                          for s in dp_b], 1)
            return v

        dp_min = _mm("min", POS_INF)
        dp_max = _mm("max", NEG_INF)

        # dp endpoints as leaf NODE ids; LCA per dp
        pa = np.array([key2node.get(int(a), -1)
                       for a in rag.dir_pairs[:, 0]], np.int64)
        pq = np.array([key2node.get(int(b), -1)
                       for b in rag.dir_pairs[:, 1]], np.int64)
        self.dp_a_node, self.dp_q_node = pa, pq
        self.dp_lca = pairs_lca(tree, pa, pq)
        # mutual (both directions exist) pairs cancel at their LCA;
        # non-mutual pairs stay in the one-sided boundary forever
        # (region.hxx:66-77 residual semantics, merge_bc.py part split)
        dir_code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
        rev_code = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
        sc = np.sort(dir_code)
        pos = np.searchsorted(sc, rev_code)
        self.dp_mutual = ((pos < len(sc))
                          & (sc[np.minimum(pos, len(sc) - 1)] == rev_code))

        # contribution shards: leaves by region owner, dps by first
        # endpoint's region owner (spatially local, deterministic)
        ai = rag.key_index(rag.dir_pairs[:, 0]).astype(np.int64)
        self.dp_shard = part.region_shard[ai].astype(np.int64)
        self.leaf_shard = leaf_shard

        # pad per-shard leaf/dp blocks
        n = self.n
        lg = [np.nonzero(leaf_shard == s)[0] for s in range(n)]
        eg = [np.nonzero(self.dp_shard == s)[0] for s in range(n)]
        self.Rl = max(max((len(g) for g in lg), default=1), 1)
        self.El = max(max((len(g) for g in eg), default=1), 1)
        self.leaf_groups, self.dp_groups = lg, eg

        def pad_rows(groups, rows, width, cap):
            out = np.zeros((n, cap, width))
            for s, g in enumerate(groups):
                out[s, : len(g)] = rows[g]
            return out

        self.leaf_add = pad_rows(lg, leaf_add, la.width, self.Rl)
        self.leaf_min = pad_rows(lg, leaf_min, lm.width, self.Rl)
        self.leaf_max = pad_rows(lg, leaf_max, lx.width, self.Rl)
        self.dp_add = pad_rows(eg, dp_add, da.width, self.El)
        self.dp_min = pad_rows(eg, dp_min, dp_min.shape[1], self.El)
        self.dp_max = pad_rows(eg, dp_max, dp_max.shape[1], self.El)
        # padded leaf node ids / dp leaf-node endpoints (pad = -1)
        self.leaf_nodes_p = np.full((n, self.Rl), -1, np.int64)
        self.dp_a_p = np.full((n, self.El), -1, np.int64)
        self.dp_q_p = np.full((n, self.El), -1, np.int64)
        self.dp_lca_p = np.full((n, self.El), -1, np.int64)
        self.dp_mutual_p = np.zeros((n, self.El), bool)
        for s in range(n):
            g = lg[s]
            self.leaf_nodes_p[s, : len(g)] = self.leaf_node[g]
            e = eg[s]
            self.dp_a_p[s, : len(e)] = pa[e]
            self.dp_q_p[s, : len(e)] = pq[e]
            self.dp_lca_p[s, : len(e)] = self.dp_lca[e]
            self.dp_mutual_p[s, : len(e)] = self.dp_mutual[e]

    # ------------------------------------------------------------------
    def level_pass(self, l: int) -> _Pass:
        """Routing for the node-record reduction at tree level ``l``."""
        lut = _alive_lut(self.tree, self.level, l)
        n, M = self.n, self.M
        leaf_comp = np.where(self.leaf_nodes_p >= 0,
                             lut[np.maximum(self.leaf_nodes_p, 0)], M)
        ca = np.where(self.dp_a_p >= 0,
                      lut[np.maximum(self.dp_a_p, 0)], M)
        cq = np.where(self.dp_q_p >= 0,
                      lut[np.maximum(self.dp_q_p, 0)], M)
        # one-sided boundary membership: mutual pairs die once both sides
        # are in the same component; non-mutual pairs never die
        dp_comp = np.where(
            ((ca != cq) | ~self.dp_mutual_p) & (ca < M), ca, M)

        owner = np.full(M, -1, np.int64)
        # alive components = alive ancestors of the LEAVES (lut over all
        # nodes also maps not-yet-alive deep internal nodes to themselves)
        alive = np.unique(lut[self.tree.is_leaf])
        owner[alive] = self.node_owner[alive]
        srcs = np.concatenate(
            [np.repeat(np.arange(n), self.Rl),
             np.repeat(np.arange(n), self.El)])
        comps = np.concatenate(
            [leaf_comp.reshape(-1), dp_comp.reshape(-1)])
        send_ids, recv_local, own_ids, log = _ragged_routes(
            n, srcs, comps, owner, M)
        return _Pass(send_ids, recv_local, own_ids, log,
                     leaf_comp, dp_comp)


_FILL = {"add": 0.0, "min": POS_INF, "max": NEG_INF}


def _segment_partial(vals, comp, M, combine):
    """Per-component partial rows [M + 1, F] of a rank's rows; ids >= M
    go to the discard row M.  Sums run in a fixed order (a stable sort of
    the ids, then B2's sorted entry)."""
    comp = torch.clamp(comp, max=M)
    if combine == "add":
        return segment_sum_ordered(vals, segment_order(comp), M + 1)
    out = vals.new_full((M + 1, vals.shape[1]), _FILL[combine])
    index = comp[:, None].expand(-1, vals.shape[1])
    return out.scatter_reduce_(0, index, vals,
                               "amin" if combine == "min" else "amax",
                               include_self=True)


def _masked_rows(table, ids, fill):
    """table[ids] where ids >= 0, ``fill`` ([F] or a scalar) elsewhere."""
    return torch.where((ids >= 0)[:, None], table[ids.clamp(min=0)], fill)


def _reduce(mesh: Mesh, partial, send_ids, recv_local, own_ids, fold,
            combine):
    """Two-phase ragged reduction on one rank: partial [M + 1, F] -> the
    owner rows [C_own, F] of the components this rank owns.  ``fold`` is
    the ``halo.fold_order`` of ``recv_local``: the additive rows are
    folded in that fixed order."""
    n, H = send_ids.shape
    F = partial.shape[1]
    fill = _FILL[combine]
    rows = _masked_rows(partial, send_ids.reshape(-1), fill)
    recv = mesh.all_to_all(rows.reshape(n, H, F)).reshape(n * H, F)
    own = _masked_rows(partial, own_ids, fill)
    if combine == "add":
        return owner_fold(own, recv, fold)
    rl = recv_local.reshape(-1)
    recv = torch.where((rl >= 0)[:, None], recv, fill)
    tgt = rl.clamp(min=0)
    return own.scatter_reduce(0, tgt[:, None].expand(-1, F), recv,
                              "amin" if combine == "min" else "amax",
                              include_self=True)


def sharded_level_features(mesh: Mesh, plan: TreeShardPlan, l: int,
                           scorer: Optional[Callable] = None):
    """Node records at tree level ``l`` plus assembled and scored BC
    feature rows for the merges AT level ``l``, sharded over the mesh;
    every rank calls it with the same plan.

    ``scorer``: fn(X [B, D] float32) -> [B], e.g.
    ``models.forest.make_label_scorer(model, label, device)`` on the
    rank's device.  Records are float32 on the card and float64 on the
    CPU (``device.default_dtype``).

    Returns (records dict of host arrays keyed by field name, rows aligned
    with ``node_ids`` (the alive node ids); feats [n_l, D]; scores [n_l]
    or None; merge order-indices [n_l]) where n_l = merges at level l."""
    n, M = plan.n, plan.M
    tree, level = plan.tree, plan.level
    pass_b = plan.level_pass(l)
    pass_a = plan.level_pass(l - 1)

    # merges at level l, assembly assigned to the owner of the merged node
    at_l = np.nonzero(plan.merge_level == l)[0]
    m_nodes = plan.merge_node[at_l]
    m_owner = plan.node_owner[m_nodes]
    n0 = tree.left[m_nodes].astype(np.int64)
    n1 = tree.right[m_nodes].astype(np.int64)

    # pair reduction: dp keyed by LCA node, owner = owner of merged node
    owner_pair = np.full(M, -1, np.int64)
    owner_pair[m_nodes] = m_owner
    lca_comp = np.where(
        (plan.dp_lca_p >= 0)
        & (level[np.maximum(plan.dp_lca_p, 0)] == l),
        plan.dp_lca_p, M)
    sends_p, recvl_p, own_p, log_p = _ragged_routes(
        n, np.repeat(np.arange(n), plan.El), lca_comp.reshape(-1),
        owner_pair, M)

    # fetch: merge owners need pass-A rows of n0 and n1
    owner_a = np.full(M, -1, np.int64)
    lut_a = _alive_lut(tree, level, l - 1)
    alive_a = np.unique(lut_a[tree.is_leaf])
    owner_a[alive_a] = plan.node_owner[alive_a]
    fetch_local, slot_of, Hf = _fetch_routes(
        n, np.concatenate([m_owner, m_owner]),
        np.concatenate([n0, n1]), owner_a, pass_a.local_of_global, M)

    # per-shard merge assembly tables
    mM = max(max(np.bincount(m_owner, minlength=n)), 1)
    C_own_a = pass_a.own_ids.shape[1]
    idx0 = np.zeros((n, mM), np.int64)
    idx1 = np.zeros((n, mM), np.int64)
    idx2 = np.zeros((n, mM), np.int64)
    idxp = np.zeros((n, mM), np.int64)
    mvalid = np.zeros((n, mM), bool)
    m_order_idx = np.full((n, mM), -1, np.int64)
    fill_count = np.zeros(n, np.int64)
    for j, (mn, mo) in enumerate(zip(m_nodes, m_owner)):
        k = fill_count[mo]
        fill_count[mo] += 1
        for arr, node in ((idx0, n0[j]), (idx1, n1[j])):
            if owner_a[node] == mo:
                arr[mo, k] = pass_a.local_of_global[node]
            else:
                arr[mo, k] = C_own_a + slot_of[mo, node]
        idx2[mo, k] = pass_b.local_of_global[mn]
        idxp[mo, k] = log_p[mn]
        mvalid[mo, k] = True
        m_order_idx[mo, k] = at_l[j]

    # ---- one rank's share, on its device ----
    dt = default_dtype(mesh.device)
    r = mesh.rank

    def mine(a, dtype=torch.int64):
        return to_device(np.ascontiguousarray(np.asarray(a)[r]), mesh, dtype)

    spec = plan.spec
    la, lm, lx, da = (plan.leaf_add_pack, plan.leaf_min_pack,
                      plan.leaf_max_pack, plan.dp_add_pack)
    leaf = {c: mine(getattr(plan, f"leaf_{c}"), dt)
            for c in ("add", "min", "max")}
    dp = {c: mine(getattr(plan, f"dp_{c}"), dt) for c in ("add", "min", "max")}
    # widths of the leaf part of each combined table
    w_leaf = {c: leaf[c].shape[1] for c in leaf}

    def node_tables(leaf_comp, dp_comp, routes):
        """Owner rows of every alive component, per combine kind: the leaf
        fields then the one-sided boundary fields."""
        out = {}
        for c in ("add", "min", "max"):
            lv, dv = leaf[c], dp[c]
            if c != "add":
                lv = torch.where((leaf_comp < M)[:, None], lv, _FILL[c])
                dv = torch.where((dp_comp < M)[:, None], dv, _FILL[c])
            part = torch.cat([_segment_partial(lv, leaf_comp, M, c),
                              _segment_partial(dv, dp_comp, M, c)], dim=1)
            out[c] = _reduce(mesh, part, *routes, c)
        return out

    def routes(send_ids, recv_local, own_ids):
        """A routing plan's rows of this rank, and the order of its fold."""
        rl, own = mine(recv_local), mine(own_ids)
        return mine(send_ids), rl, own, fold_order(rl, own.shape[0])

    ta = node_tables(mine(pass_a.leaf_comp), mine(pass_a.dp_comp),
                     routes(pass_a.send_ids, pass_a.recv_local,
                            pass_a.own_ids))
    tb = node_tables(mine(pass_b.leaf_comp), mine(pass_b.dp_comp),
                     routes(pass_b.send_ids, pass_b.recv_local,
                            pass_b.own_ids))

    # pair tables (additive + min/max over dps at level-l LCAs)
    lca = mine(lca_comp)
    p_routes = routes(sends_p, recvl_p, own_p)
    pair_t = {}
    for c in ("add", "min", "max"):
        dv = dp[c] if c == "add" else torch.where((lca < M)[:, None], dp[c],
                                                  _FILL[c])
        pair_t[c] = _reduce(mesh, _segment_partial(dv, lca, M, c),
                            *p_routes, c)

    # fetch the pass-A rows this rank's merges need, all kinds at once
    fl = mine(fetch_local).reshape(-1)
    tab_a = torch.cat([ta["add"], ta["min"], ta["max"]], dim=1)
    fill = torch.cat([torch.full((ta[c].shape[1],), _FILL[c], dtype=dt,
                                 device=mesh.device)
                      for c in ("add", "min", "max")])
    rows = _masked_rows(tab_a, fl, fill)
    halo = mesh.all_to_all(rows.reshape(n, Hf, -1)).reshape(n * Hf, -1)
    tab_a = torch.cat([tab_a, halo], dim=0)
    wa = [ta[c].shape[1] for c in ("add", "min", "max")]
    tabs_a = dict(zip(("add", "min", "max"),
                      torch.split(tab_a, wa, dim=1)))

    def record(tabs, idx):
        """The bc_features_dev record of rows ``idx`` of the tables."""
        add, mn, mx = (tabs[c][idx] for c in ("add", "min", "max"))
        a, b = w_leaf["add"], w_leaf["min"]
        ba, bm = add[:, a:], mn[:, b:]
        bx = mx[:, w_leaf["max"]:]
        rec = {
            "area": la.unpack(add[:, :a], "area"),
            "border": la.unpack(add[:, :a], "border"),
            "r_cnt": la.unpack(add[:, :a], "r_cnt"),
            "r_sum": la.unpack(add[:, :a], "r_sum"),
            "r_sumsq": la.unpack(add[:, :a], "r_sumsq"),
            "r_hist": la.unpack(add[:, :a], "r_hist"),
            "rl_hist": la.unpack(add[:, :a], "rl_hist"),
            "bbox_lo": lm.unpack(mn[:, :b], "bbox_lo"),
            "r_min": lm.unpack(mn[:, :b], "r_min"),
            "bbox_hi": lx.unpack(mx[:, :w_leaf["max"]], "bbox_hi"),
            "r_max": lx.unpack(mx[:, :w_leaf["max"]], "r_max"),
            "bd": da.unpack(ba, "cnt"),
            "vp": da.unpack(ba, "vp"),
            "b_cnt": da.unpack(ba, "b_cnt"),
            "b_sum": da.unpack(ba, "b_sum"),
            "b_sumsq": da.unpack(ba, "b_sumsq"),
            "b_hist": da.unpack(ba, "b_hist"),
            "b_min": bm,
            "b_max": bx,
        }
        if spec.median_as_feats:
            rec["r_medh"] = la.unpack(add[:, :a], "r_medh")
            rec["b_medh"] = da.unpack(ba, "b_medh")
        return rec

    rec0 = record(tabs_a, mine(idx0))
    rec1 = record(tabs_a, mine(idx1))
    rec2 = record(tb, mine(idx2))
    ip = mine(idxp)
    padd = pair_t["add"][ip]
    pair = {
        "cnt": da.unpack(padd, "cnt"),
        "vp": da.unpack(padd, "vp"),
        "b_cnt": da.unpack(padd, "b_cnt"),
        "b_sum": da.unpack(padd, "b_sum"),
        "b_sumsq": da.unpack(padd, "b_sumsq"),
        "b_hist": da.unpack(padd, "b_hist"),
        "b_min": pair_t["min"][ip],
        "b_max": pair_t["max"][ip],
    }
    if spec.median_as_feats:
        pair["b_medh"] = da.unpack(padd, "b_medh")
    feats = bc_features_dev(rec0, rec1, rec2, pair, spec)
    if scorer is not None:
        scores = scorer(feats.to(torch.float32)).to(feats.dtype)
    else:
        scores = feats.new_zeros(feats.shape[0])

    # every rank's owner tables and rows, then the host gather of
    # glia_tpu: owner tables -> per-alive-node records
    wb = [tb[c].shape[1] for c in ("add", "min", "max")]
    nb = mesh.all_gather(torch.cat([tb["add"], tb["min"], tb["max"]], dim=1))
    fs = mesh.all_gather(torch.cat([feats, scores[:, None]], dim=1))
    nb_add, nb_min, nb_max = (t.cpu().numpy()
                              for t in torch.split(nb, wb, dim=1))
    fs = fs.cpu().numpy()
    feats, scores = fs[:, :-1], fs[:, -1]

    lut_b = _alive_lut(plan.tree, plan.level, l)
    alive_b = np.unique(lut_b[plan.tree.is_leaf])
    C_own_b = pass_b.own_ids.shape[1]
    rows = (plan.node_owner[alive_b] * C_own_b
            + pass_b.local_of_global[alive_b])
    a, b, x = w_leaf["add"], w_leaf["min"], w_leaf["max"]
    records = {
        "node_ids": alive_b,
        "add": nb_add[rows, :a], "min": nb_min[rows, :b],
        "max": nb_max[rows, :x],
        "b_add": nb_add[rows, a:], "b_min": nb_min[rows, b:],
        "b_max": nb_max[rows, x:],
    }
    sel = mvalid.reshape(-1)
    order_idx = m_order_idx.reshape(-1)[sel]
    return records, feats[sel], (scores[sel].astype(np.float32)
                                 if scorer is not None else None), order_idx
