"""Device classifier-in-the-loop merge engine (merge_order_bc), PyTorch.

Counterpart of glia_tpu.graph.merge_bc_device.  The reference's
genMergeOrderGreedyUsingBoundaryClassifier (code/util/struct_merge_bc.hxx:
10-58) recomputes full BoundaryClassificationFeats and a classifier
probability for every candidate pair inside a serial priority loop.  This
engine keeps per-*component* records as tensors so that EVERY frontier
candidate's features assemble and score on the device per superstep:

  - superstep = score all table candidates (full-width BC features +
    classifier) -> merge the independent set of edges that are the
    probability *maximum* of both endpoints -> commit merges, rekey and
    deduplicate edges with segment reductions (the batched analogue of
    boundary_table.hxx:122-167's pop+update);
  - boundary-cancellation bookkeeping follows the mutual / non-mutual
    split of directed base-pair stats (code/type/region.hxx:66-77): per
    edge four stat groups [m_u, n_u, m_v, n_v]; a merge cancels the two
    mutual groups of its own edge and moves the non-mutual groups into the
    merged component's residual;
  - min/max of the *hypothetical* merged boundary uses exclude-one scatter
    reductions (min1/count/min2 per component).

State layout: per-component stats pack into three matrices (additive /
min / max) and per-edge directed-part stats into three [E, 4, *] tensors.
Additive fields merge by +, min/max fields by min/max with +-inf empty
fills (group_stats' conventions, so count<=0 rows serialize to zeros,
feat.hxx:703).

The supersteps run as a Python loop with one host sync each (the loop
condition, the superstep's merge count and its live edges, read in one
copy).  The dedupe leaves every live edge ahead of every dead one, so the
loop runs each superstep on a prefix of the edge arrays: the capacity
halves, from the staged E through ceil(E / 2**k), whenever the live edges
fit (the rows cut off are dead, and dead rows add nothing).  Sums over
edges go through ``segment_sum_auto``.  The float sums use its sorted
form, which adds each segment's rows in index order on the CPU (as XLA's
scatter does) and on the card (the CUDA kernel's sorted entry point), so
two runs give the same bits: the edges are kept sorted by their lower
endpoint (``e_lo``), and the sums by the upper endpoint go
through one stable sort per superstep.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import (DeviceLike, default_dtype, resolve_device,
                      synchronize)
from ..features.config import FeatureConfig
from ..features.device import (DeviceFeatureSpec, bc_features_dev,
                               counting_hist)
from ..ops.segment_csr import segment_sum_auto
from ..utils import profiling
from .merge_device import order_to_keys
from .rag import Rag

POS_INF = np.inf
NEG_INF = -np.inf

# part indices along the edge "parts" axis
P_MU, P_NU, P_MV, P_NV = 0, 1, 2, 3

# the state's arrays with a row per edge, which the loop cuts to a prefix
EDGE_KEYS = ("eu", "ev", "e_lo", "e_alive", "e_table", "e_add", "e_min",
             "e_max")


class _Pack:
    """Named slices of a flat trailing feature axis."""

    def __init__(self):
        self.slices = {}
        self.width = 0

    def add(self, name, shape=()):
        k = int(np.prod(shape)) if shape else 1
        self.slices[name] = (self.width, self.width + k, tuple(shape))
        self.width += k
        return self

    def get(self, mat, name):
        a, b, shape = self.slices[name]
        col = mat[..., a:b]
        return col.reshape(col.shape[:-1] + shape) if shape else col[..., 0]

    def put_np(self, mat, name, val):
        a, b, _ = self.slices[name]
        mat[..., a:b] = np.asarray(val).reshape(mat.shape[:-1] + (b - a,))


def _make_packs(spec: DeviceFeatureSpec):
    """(component add/min/max packs, edge-part add pack).

    The component add pack ends with a residual block laid out exactly
    like the edge-part pack so residual += part-slice is one vector op;
    same for the min/max packs' trailing residual-boundary block.
    """
    nR, nRL, nB, nT, D = (spec.n_r, spec.n_rl, spec.n_b, spec.n_thresh,
                          spec.ndim)
    rB = max(spec.r_bins_max, 1)
    rlB = max(spec.rl_bins_max, 1)
    bB = max(spec.b_bins_max, 1)
    ea = _Pack()
    ea.add("cnt").add("vp", (nT,)).add("b_cnt", (nB,)).add("b_sum", (nB,))
    ea.add("b_sumsq", (nB,)).add("b_hist", (nB, bB))
    if spec.median_as_feats:
        ea.add("b_medh", (nB, spec.b_med_v))
    ca = _Pack()
    ca.add("area").add("border").add("r_cnt", (nR,)).add("r_sum", (nR,))
    ca.add("r_sumsq", (nR,)).add("r_hist", (nR, rB))
    ca.add("rl_hist", (nRL, rlB))
    if spec.median_as_feats:
        ca.add("r_medh", (nR, spec.r_med_v))
    res_off = ca.width
    for name, (a, b, shape) in ea.slices.items():
        ca.add("res_" + name, shape if shape else ())
    cm = _Pack()
    cm.add("bbox_lo", (D,)).add("r_min", (nR,))
    rmin_off = cm.width
    cm.add("res_b_min", (nB,))
    cx = _Pack()
    cx.add("bbox_hi", (D,)).add("r_max", (nR,))
    cx.add("res_b_max", (nB,))
    return ca, cm, cx, ea, res_off, rmin_off


@dataclass
class BcDeviceStatic:
    """Static (python-level) config of the superstep."""

    spec: DeviceFeatureSpec
    C: int            # component capacity
    E: int            # edge capacity
    R: int            # initial leaf regions
    feat_dim: int
    ca: _Pack = None
    cm: _Pack = None
    cx: _Pack = None
    ea: _Pack = None
    res_off: int = 0
    rmin_off: int = 0


def build_state(rag: Rag, cfg: FeatureConfig):
    """Host-side packing of the RAG + feature images into engine arrays.

    Returns (state dict of numpy arrays, BcDeviceStatic); ``state_to_device``
    moves the state to a device.  Leaf records, the mutual/non-mutual
    directed-pair split and the initial table membership follow glia_tpu's
    host engine (graph/merge_bc.DynamicRagState).
    """
    # imported here, as in glia_tpu: features imports graph
    from ..features.hierarchical import group_stats

    if rag.region_ptr is None:
        raise ValueError("build RAG with contour_only=False")
    ndim = len(rag.shape)
    spec = DeviceFeatureSpec.from_config(cfg, ndim)
    R = rag.n_regions
    C = R + max(R - 1, 1)
    nT, nR, nRL, nB = spec.n_thresh, spec.n_r, spec.n_rl, spec.n_b
    ca, cm, cx, ea, res_off, rmin_off = _make_packs(spec)

    pb = np.asarray(cfg.pb_image, dtype=np.float64).ravel()

    # ---- leaf component records ----
    rid = np.repeat(np.arange(R), np.diff(rag.region_ptr))
    pix = rag.region_pixels
    c_add = np.zeros((C, ca.width))
    c_min = np.full((C, cm.width), POS_INF)
    c_max = np.full((C, cx.width), NEG_INF)

    area = np.zeros(C)
    np.add.at(area, rid, 1.0)
    ca.put_np(c_add, "area", area)
    border = np.zeros(C)
    border[:R] = np.diff(rag.border_ptr).astype(np.float64)
    ca.put_np(c_add, "border", border)
    # residual blocks start zeroed (additive) and stay +-inf (min/max)
    a, b, _ = ca.slices["res_cnt"]
    c_add[:, a:] = 0.0

    coords_all = np.unravel_index(pix, rag.shape)
    coords = np.stack([coords_all[ndim - 1 - d] for d in range(ndim)],
                      axis=1).astype(np.float64)
    bbox_lo = np.full((C, ndim), POS_INF)
    bbox_hi = np.full((C, ndim), NEG_INF)
    for d in range(ndim):
        np.minimum.at(bbox_lo[:, d], rid, coords[:, d])
        np.maximum.at(bbox_hi[:, d], rid, coords[:, d])
    bbox_lo[:R] = np.where(np.isfinite(bbox_lo[:R]), bbox_lo[:R], 0.0)
    bbox_hi[:R] = np.where(np.isfinite(bbox_hi[:R]), bbox_hi[:R], 0.0)
    cm.put_np(c_min, "bbox_lo", bbox_lo)
    cx.put_np(c_max, "bbox_hi", bbox_hi)

    def _img_group(images, bins):
        cnt = np.zeros((C, len(images)))
        s = np.zeros((C, len(images)))
        ss = np.zeros((C, len(images)))
        mn = np.full((C, len(images)), POS_INF)
        mx = np.full((C, len(images)), NEG_INF)
        h = np.zeros((C, len(images), bins))
        for i, img in enumerate(images):
            v = np.asarray(img.image, np.float64).ravel()[pix]
            st = group_stats(v, rid, R, img.hist_bins, img.hist_range)
            cnt[:R, i] = st["cnt"]
            s[:R, i] = st["sum"]
            ss[:R, i] = st["sumsq"]
            mn[:R, i] = st["min"]
            mx[:R, i] = st["max"]
            h[:R, i, :img.hist_bins] = st["hist"]
        return cnt, s, ss, mn, mx, h

    r_cnt, r_sum, r_sumsq, r_min, r_max, r_hist = _img_group(
        cfg.r_images, max(spec.r_bins_max, 1))
    ca.put_np(c_add, "r_cnt", r_cnt)
    ca.put_np(c_add, "r_sum", r_sum)
    ca.put_np(c_add, "r_sumsq", r_sumsq)
    ca.put_np(c_add, "r_hist", r_hist)
    cm.put_np(c_min, "r_min", r_min)
    cx.put_np(c_max, "r_max", r_max)
    rl_hist = np.zeros((C, nRL, max(spec.rl_bins_max, 1)))
    for i, img in enumerate(cfg.rl_images):
        v = np.asarray(img.image, np.float64).ravel()[pix]
        st = group_stats(v, rid, R, img.hist_bins, img.hist_range)
        rl_hist[:R, i, :img.hist_bins] = st["hist"]
    ca.put_np(c_add, "rl_hist", rl_hist)
    if spec.median_as_feats:
        r_medh = np.zeros((C, nR, spec.r_med_v))
        for i, img in enumerate(cfg.r_images):
            v = np.asarray(img.image, np.float64).ravel()[pix]
            r_medh[:R, i, :len(spec.r_med_vals[i])] = counting_hist(
                v, rid, R, spec.r_med_vals[i], len(spec.r_med_vals[i]))
        ca.put_np(c_add, "r_medh", r_medh)

    # ---- directed base-pair stats -> per-edge part groups ----
    Ed = len(rag.dir_pairs)
    dpid = np.repeat(np.arange(Ed), np.diff(rag.dir_ptr))
    dp_cnt = np.diff(rag.dir_ptr).astype(np.float64)
    dp_pb = pb[rag.dir_pixels]
    dp_vp = np.zeros((Ed, nT))
    for t, th in enumerate(cfg.boundary_thresholds):
        np.add.at(dp_vp[:, t], dpid, (dp_pb >= th).astype(np.float64))
    dp_b = []
    for img in cfg.b_images:
        v = np.asarray(img.image, np.float64).ravel()[rag.dir_pixels]
        dp_b.append(group_stats(v, dpid, Ed, img.hist_bins, img.hist_range))

    # mutual classification of directed pairs (merge_bc.py:112-118)
    dir_code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
    rev_code = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
    sc = np.sort(dir_code)
    pos = np.searchsorted(sc, rev_code)
    mutual = (pos < len(sc)) & (sc[np.minimum(pos, len(sc) - 1)] == rev_code)

    # undirected pair universe: unique (lo, hi) over directed pairs
    a_idx = rag.key_index(rag.dir_pairs[:, 0]).astype(np.int64)
    b_idx = rag.key_index(rag.dir_pairs[:, 1]).astype(np.int64)
    lo = np.minimum(a_idx, b_idx)
    hi = np.maximum(a_idx, b_idx)
    pair_code = lo * np.int64(C) + hi
    uniq, inv = np.unique(pair_code, return_inverse=True)
    E = len(uniq)
    # np.unique sorts the codes, so eu is non-decreasing: the order the
    # superstep's dedupe keeps (e_lo of state_to_device)
    eu = (uniq // C).astype(np.int32)
    ev = (uniq % C).astype(np.int32)
    # side: directed pair (a,b) with a==lo is the u side
    is_u_side = a_idx == eu.astype(np.int64)[inv]
    part = np.where(mutual, 0, 1) + np.where(is_u_side, 0, 2)

    e_add = np.zeros((E, 4, ea.width))
    e_min = np.full((E, 4, max(nB, 0)), POS_INF)
    e_max = np.full((E, 4, max(nB, 0)), NEG_INF)
    dp_rows = np.zeros((Ed, ea.width))
    ea.put_np(dp_rows, "cnt", dp_cnt)
    ea.put_np(dp_rows, "vp", dp_vp)
    if nB:
        ea.put_np(dp_rows, "b_cnt", np.stack([s["cnt"] for s in dp_b], 1))
        ea.put_np(dp_rows, "b_sum", np.stack([s["sum"] for s in dp_b], 1))
        ea.put_np(dp_rows, "b_sumsq",
                  np.stack([s["sumsq"] for s in dp_b], 1))
        bh = np.zeros((Ed, nB, max(spec.b_bins_max, 1)))
        for i, s in enumerate(dp_b):
            bh[:, i, :s["hist"].shape[1]] = s["hist"]
        ea.put_np(dp_rows, "b_hist", bh)
        if spec.median_as_feats:
            bmh = np.zeros((Ed, nB, spec.b_med_v))
            for i, img in enumerate(cfg.b_images):
                v = np.asarray(img.image, np.float64).ravel()[rag.dir_pixels]
                bmh[:, i, :len(spec.b_med_vals[i])] = counting_hist(
                    v, dpid, Ed, spec.b_med_vals[i],
                    len(spec.b_med_vals[i]))
            ea.put_np(dp_rows, "b_medh", bmh)
    np.add.at(e_add, (inv, part), dp_rows)
    for bi, st in enumerate(dp_b):
        nz = st["cnt"] > 0
        np.minimum.at(e_min[:, :, bi], (inv[nz], part[nz]), st["min"][nz])
        np.maximum.at(e_max[:, :, bi], (inv[nz], part[nz]), st["max"][nz])

    # table membership: both directions exist (boundary_table.hxx:99-103)
    has_u = np.zeros(E, bool)
    has_v = np.zeros(E, bool)
    has_u[inv[is_u_side]] = True
    has_v[inv[~is_u_side]] = True
    e_table = has_u & has_v

    state = {
        "c_alive": np.concatenate([np.ones(R, bool), np.zeros(C - R, bool)]),
        "c_add": c_add, "c_min": c_min, "c_max": c_max,
        "eu": eu, "ev": ev,
        "e_alive": np.ones(E, bool), "e_table": e_table,
        "e_add": e_add, "e_min": e_min, "e_max": e_max,
        "next_id": np.int32(R),
    }
    nt_feat = bc_feat_dim(cfg, ndim)
    return state, BcDeviceStatic(
        spec=spec, C=C, E=E, R=R, feat_dim=nt_feat, ca=ca, cm=cm, cx=cx,
        ea=ea, res_off=res_off, rmin_off=rmin_off)


def bc_feat_dim(cfg: FeatureConfig, ndim: int) -> int:
    return (cfg.boundary_feat_dim(with_saliency=False)
            + 3 * cfg.region_feat_dim(ndim, with_saliency=False))


def state_to_device(state_np, device, dtype):
    """The numpy state of ``build_state`` as tensors on ``device``: floats
    in ``dtype``, indices int64, masks bool.  Adds ``e_lo``, the ids of the
    sums by lower endpoint: ``eu`` where it is non-decreasing over all
    edges, as ``build_state`` leaves it and every superstep keeps it (with
    the dropped id C for dead edges)."""
    if np.any(np.diff(np.asarray(state_np["eu"]).astype(np.int64)) < 0):
        raise ValueError("state edges are not sorted by lower endpoint")
    out = {}
    for k, v in state_np.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            out[k] = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = torch.as_tensor(a, dtype=torch.int64, device=device)
        else:
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
    out["e_lo"] = out["eu"].clone()
    return out


# ---------------------------------------------------------------------------
# superstep
# ---------------------------------------------------------------------------

def _segment_sum(src, index, n, sorted=False):
    """out[s] = sum of src[i] over index[i] == s (rows of ``src``, whose
    trailing axes are summed as one flat feature axis); ids outside
    [0, n) are dropped.  ``sorted=True`` states that ``index`` is
    non-decreasing: each segment is then added in index order, on the card
    too."""
    flat = src.reshape(src.shape[0], -1) if src.ndim > 2 else src
    out = segment_sum_auto(flat, index, n, sorted=sorted)
    return out.reshape((n,) + tuple(src.shape[1:]))


def _scatter_reduce_(target, index, src, how):
    """target[index[i]] = how(target[index[i]], src[i]) row-wise, in
    place; ``how`` is "amin" or "amax" (include_self: target holds the
    fill)."""
    idx = index.reshape((-1,) + (1,) * (src.ndim - 1)).expand_as(src)
    return target.scatter_reduce_(0, idx, src, how, include_self=True)


def _component_totals(state, static):
    """One-sided boundary totals per component (record_with_boundary's
    bd/vp/b fields): residual + all outgoing entry parts.

    Returns (tot_badd [C, PA], tot_bmin [C, nB], tot_bmax [C, nB],
    (side mins/maxes per edge))."""
    C = static.C
    eu, ev, alive = state["eu"], state["ev"], state["e_alive"]
    e_add, e_min, e_max = state["e_add"], state["e_min"], state["e_max"]

    side_u = e_add[:, P_MU] + e_add[:, P_NU]       # [E, PA]
    side_v = e_add[:, P_MV] + e_add[:, P_NV]
    am = alive[:, None]
    tot_badd = state["c_add"][:, static.res_off:]
    # by the lower endpoint: e_lo is eu in the order the dedupe's sort left
    # (non-decreasing, C for edges dead before it: dropped); an edge that
    # died in the dedupe sits inside its run and adds zeros
    tot_badd = tot_badd + _segment_sum(torch.where(am, side_u, 0.0),
                                       state["e_lo"], C, sorted=True)
    # by the upper endpoint: a stable sort keeps index order inside each
    # segment (dead edges sort to the dropped id C)
    ev_s, by_ev = torch.sort(torch.where(alive, ev, C), stable=True)
    tot_badd = tot_badd + _segment_sum(torch.where(am, side_v, 0.0)[by_ev],
                                       ev_s, C, sorted=True)

    side_u_min = torch.minimum(e_min[:, P_MU], e_min[:, P_NU])
    side_v_min = torch.minimum(e_min[:, P_MV], e_min[:, P_NV])
    side_u_max = torch.maximum(e_max[:, P_MU], e_max[:, P_NU])
    side_v_max = torch.maximum(e_max[:, P_MV], e_max[:, P_NV])
    res_min = state["c_min"][:, static.rmin_off:]
    tmin = torch.full_like(res_min, POS_INF)
    _scatter_reduce_(tmin, eu, torch.where(am, side_u_min, POS_INF), "amin")
    _scatter_reduce_(tmin, ev, torch.where(am, side_v_min, POS_INF), "amin")
    tot_bmin = torch.minimum(res_min, tmin)
    res_max = state["c_max"][:, static.rmin_off:]
    tmax = torch.full_like(res_max, NEG_INF)
    _scatter_reduce_(tmax, eu, torch.where(am, side_u_max, NEG_INF), "amax")
    _scatter_reduce_(tmax, ev, torch.where(am, side_v_max, NEG_INF), "amax")
    tot_bmax = torch.maximum(res_max, tmax)
    return (tot_badd, tot_bmin, tot_bmax,
            (side_u_min, side_v_min, side_u_max, side_v_max))


def _excl_reduce(vals_u, vals_v, eu, ev, alive, C, kind):
    """Per-edge-endpoint exclude-one reduction: for edge e and endpoint u,
    the min (or max) of the OTHER alive incident edges' side values.

    Returns (excl_u [E, nB], excl_v [E, nB]).
    """
    if kind == "min":
        fill, how = POS_INF, "amin"

        def beats(x, m):  # strictly worse than best
            return x > m
    else:
        fill, how = NEG_INF, "amax"

        def beats(x, m):
            return x < m

    shape = (C,) + tuple(vals_u.shape[1:])
    z_u = torch.where(alive[:, None], vals_u, fill)
    z_v = torch.where(alive[:, None], vals_v, fill)
    m1 = torch.full(shape, fill, dtype=vals_u.dtype, device=vals_u.device)
    _scatter_reduce_(m1, eu, z_u, how)
    _scatter_reduce_(m1, ev, z_v, how)
    m2 = torch.full_like(m1, fill)
    _scatter_reduce_(m2, eu, torch.where(beats(z_u, m1[eu]), z_u, fill), how)
    _scatter_reduce_(m2, ev, torch.where(beats(z_v, m1[ev]), z_v, fill), how)

    # achiever counts (duplicated extrema survive exclusion): sums of 0.0
    # and 1.0 are exact in any order, so the unsorted form gives the same
    # bits on every run
    c1 = _segment_sum(
        torch.where(alive[:, None] & (z_u == m1[eu]), 1.0, 0.0).to(
            vals_u.dtype), eu, C)
    c1 = c1 + _segment_sum(
        torch.where(alive[:, None] & (z_v == m1[ev]), 1.0, 0.0).to(
            vals_u.dtype), ev, C)

    def excl(z, comp):
        keep_m1 = beats(z, m1[comp]) | (c1[comp] >= 2.0)
        return torch.where(keep_m1, m1[comp], m2[comp])

    return excl(z_u, eu), excl(z_v, ev)


def _region_rec(static, add_rows, min_rows, max_rows, badd_rows,
                bmin_rows, bmax_rows):
    """Unpack gathered rows into the bc_features_dev record dict."""
    ca, cm, cx, ea = static.ca, static.cm, static.cx, static.ea
    rec = {
        "area": ca.get(add_rows, "area"),
        "border": ca.get(add_rows, "border"),
        "r_cnt": ca.get(add_rows, "r_cnt"),
        "r_sum": ca.get(add_rows, "r_sum"),
        "r_sumsq": ca.get(add_rows, "r_sumsq"),
        "r_hist": ca.get(add_rows, "r_hist"),
        "rl_hist": ca.get(add_rows, "rl_hist"),
        "bbox_lo": cm.get(min_rows, "bbox_lo"),
        "r_min": cm.get(min_rows, "r_min"),
        "bbox_hi": cx.get(max_rows, "bbox_hi"),
        "r_max": cx.get(max_rows, "r_max"),
        "bd": ea.get(badd_rows, "cnt"),
        "vp": ea.get(badd_rows, "vp"),
        "b_cnt": ea.get(badd_rows, "b_cnt"),
        "b_sum": ea.get(badd_rows, "b_sum"),
        "b_sumsq": ea.get(badd_rows, "b_sumsq"),
        "b_hist": ea.get(badd_rows, "b_hist"),
        "b_min": bmin_rows,
        "b_max": bmax_rows,
    }
    if static.spec.median_as_feats:
        rec["r_medh"] = ca.get(add_rows, "r_medh")
        rec["b_medh"] = ea.get(badd_rows, "b_medh")
    return rec


def candidate_features(state, static: BcDeviceStatic):
    """Full-width BC feature matrix [E, D] for every alive edge, plus the
    candidate-valid mask (alive & in-table)."""
    spec, ea = static.spec, static.ea
    eu, ev, alive = state["eu"], state["ev"], state["e_alive"]
    e_add, e_min, e_max = state["e_add"], state["e_min"], state["e_max"]
    tot_badd, tot_bmin, tot_bmax, sides = _component_totals(state, static)
    side_u_min, side_v_min, side_u_max, side_v_max = sides

    rec0 = _region_rec(static, state["c_add"][eu], state["c_min"][eu],
                       state["c_max"][eu], tot_badd[eu], tot_bmin[eu],
                       tot_bmax[eu])
    rec1 = _region_rec(static, state["c_add"][ev], state["c_min"][ev],
                       state["c_max"][ev], tot_badd[ev], tot_bmin[ev],
                       tot_bmax[ev])

    # pair boundary: all four parts (getBoundary both sides); the parts
    # are added in order, as XLA's reduction over the parts axis does
    pair_add = e_add[:, 0] + e_add[:, 1] + e_add[:, 2] + e_add[:, 3]
    pair = {
        "cnt": ea.get(pair_add, "cnt"),
        "vp": ea.get(pair_add, "vp"),
        "b_cnt": ea.get(pair_add, "b_cnt"),
        "b_sum": ea.get(pair_add, "b_sum"),
        "b_sumsq": ea.get(pair_add, "b_sumsq"),
        "b_hist": ea.get(pair_add, "b_hist"),
        "b_min": e_min.amin(dim=1),
        "b_max": e_max.amax(dim=1),
    }
    if spec.median_as_feats:
        pair["b_medh"] = ea.get(pair_add, "b_medh")

    # merged record (the reference's scratch merge, struct_merge_bc.hxx:
    # 18-35): additive = sum, min/max = elementwise (+-inf empty fills
    # preserve the host's both/only0 semantics exactly)
    add2 = state["c_add"][eu] + state["c_add"][ev]
    min2 = torch.minimum(state["c_min"][eu], state["c_min"][ev])
    max2 = torch.maximum(state["c_max"][eu], state["c_max"][ev])
    # merged boundary, additive block: tot_u + tot_v - both mutual parts
    badd2 = (tot_badd[eu] + tot_badd[ev]
             - e_add[:, P_MU] - e_add[:, P_MV])
    # merged boundary min/max: exclude this edge's side values, keep its
    # non-mutual parts and residuals
    exu_min, exv_min = _excl_reduce(side_u_min, side_v_min, eu, ev, alive,
                                    static.C, "min")
    exu_max, exv_max = _excl_reduce(side_u_max, side_v_max, eu, ev, alive,
                                    static.C, "max")
    res_min = state["c_min"][:, static.rmin_off:]
    res_max = state["c_max"][:, static.rmin_off:]
    n_min = torch.minimum(e_min[:, P_NU], e_min[:, P_NV])
    n_max = torch.maximum(e_max[:, P_NU], e_max[:, P_NV])
    bmin2 = torch.minimum(
        torch.minimum(res_min[eu], res_min[ev]),
        torch.minimum(torch.minimum(exu_min, exv_min), n_min))
    bmax2 = torch.maximum(
        torch.maximum(res_max[eu], res_max[ev]),
        torch.maximum(torch.maximum(exu_max, exv_max), n_max))
    rec2 = _region_rec(static, add2, min2, max2, badd2, bmin2, bmax2)

    feats = bc_features_dev(rec0, rec1, rec2, pair, spec)
    valid = alive & state["e_table"]
    return feats, valid


def _select_independent_max(probs, valid, eu, ev, C):
    """Edges that are the strict probability maximum of BOTH endpoints
    (ties broken by lowest edge index) -- a conflict-free merge set.

    Probabilities compare as the int32 bit patterns of their clamped
    float32 values (order-preserving for non-negative floats).  Float32
    denormals count as 0, as in glia_tpu: XLA flushes them to zero on the
    CPU, and the TPU has none."""
    E = probs.shape[0]
    idx = torch.arange(E, device=probs.device)
    p32 = probs.to(torch.float32)
    p32 = torch.where(p32 < torch.finfo(torch.float32).tiny, 0.0, p32)
    bits = p32.view(torch.int32)
    bits = torch.where(valid, bits, -1)
    rbits = torch.full((C,), -1, dtype=torch.int32, device=probs.device)
    _scatter_reduce_(rbits, eu, bits, "amax")
    _scatter_reduce_(rbits, ev, bits, "amax")
    cand = valid & (rbits[eu] == bits) & (rbits[ev] == bits)
    cidx = torch.where(cand, idx, E)
    ridx = torch.full((C,), E, dtype=idx.dtype, device=probs.device)
    _scatter_reduce_(ridx, eu, cidx, "amin")
    _scatter_reduce_(ridx, ev, cidx, "amin")
    return cand & (ridx[eu] == idx) & (ridx[ev] == idx)


def superstep(state, static: BcDeviceStatic, predict_fn: Callable):
    """One superstep: score every candidate, merge the independent set of
    probability maxima, rekey and deduplicate the edges.  ``state`` is
    left as it was: the new state is made of new tensors.

    Edges are the rows of ``state``'s edge arrays (``EDGE_KEYS``), as
    many as it has.  Returns (new state, rows [E, 3] (u, v, new id) dense
    ids, probs [E], merge mask [E], n_table_left, n_scored, n_merged,
    n_live) -- the last four as tensors; every live edge of the new state
    lies in its first n_live rows."""
    with profiling.span("bc.features"):
        feats, valid = candidate_features(state, static)
    with profiling.span("bc.score"):
        probs = predict_fn(feats).to(feats.dtype)
    with profiling.span("bc.commit"):
        return _commit(state, static, probs, valid)


def _commit(state, static: BcDeviceStatic, probs, valid):
    """The superstep after scoring: selection, new records, rekey and
    dedupe (``superstep``'s returns but the state's)."""
    C, E = static.C, state["eu"].shape[0]
    res_off, rmin_off = static.res_off, static.rmin_off
    eu, ev = state["eu"], state["ev"]
    ok = _select_independent_max(probs, valid, eu, ev, C)

    e_add, e_min, e_max = state["e_add"], state["e_min"], state["e_max"]
    rank = torch.cumsum(ok.to(torch.int64), 0) - 1
    r2 = state["next_id"] + rank
    rows = torch.stack([eu, ev, r2], dim=1)
    n_new = ok.sum()

    # merged components go to row r2; rows of edges not merged go to the
    # dump slot C, the only index written twice, which is then cut off
    dump = C
    tgt = torch.where(ok, r2, dump)

    def scat_set(arr, new_vals):
        pad = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
        pad[tgt] = new_vals
        return pad[:C]

    # --- new component records (union of endpoints); the residual block
    # additionally absorbs this edge's non-mutual parts (the mutual parts
    # cancel, region.hxx:68-77) ---
    st = dict(state)
    add2 = state["c_add"][eu] + state["c_add"][ev]
    add2 = torch.cat(
        [add2[:, :res_off],
         add2[:, res_off:] + e_add[:, P_NU] + e_add[:, P_NV]], dim=1)
    st["c_add"] = scat_set(state["c_add"], add2)
    min2 = torch.minimum(state["c_min"][eu], state["c_min"][ev])
    min2 = torch.cat(
        [min2[:, :rmin_off],
         torch.minimum(min2[:, rmin_off:],
                       torch.minimum(e_min[:, P_NU], e_min[:, P_NV]))],
        dim=1)
    st["c_min"] = scat_set(state["c_min"], min2)
    max2 = torch.maximum(state["c_max"][eu], state["c_max"][ev])
    max2 = torch.cat(
        [max2[:, :rmin_off],
         torch.maximum(max2[:, rmin_off:],
                       torch.maximum(e_max[:, P_NU], e_max[:, P_NV]))],
        dim=1)
    st["c_max"] = scat_set(state["c_max"], max2)

    src_u = torch.where(ok, eu, dump)
    src_v = torch.where(ok, ev, dump)
    alive_pad = torch.cat([state["c_alive"],
                           state["c_alive"].new_zeros(1)])
    alive_pad[src_u] = False
    alive_pad[src_v] = False
    alive_pad[tgt] = True
    st["c_alive"] = alive_pad[:C]

    # --- rekey edges ---
    lut = torch.arange(C + 1, device=eu.device)
    new_id = torch.where(ok, r2, dump)
    lut[src_u] = new_id
    lut[src_v] = new_id
    eu2 = lut[eu]
    ev2 = lut[ev]
    alive2 = state["e_alive"] & ~ok & (eu2 != ev2)

    # orientation normalize: keep eu < ev; swapping endpoints swaps the
    # (m_u, n_u) and (m_v, n_v) part groups
    swap = eu2 > ev2
    eu3 = torch.where(swap, ev2, eu2)
    ev3 = torch.where(swap, eu2, ev2)
    # (m_u, n_u, m_v, n_v) -> (m_v, n_v, m_u, n_u): a roll by two parts
    sw = swap[:, None, None]
    e_add = torch.where(sw, e_add.roll(2, 1), e_add)
    e_min = torch.where(sw, e_min.roll(2, 1), e_min)
    e_max = torch.where(sw, e_max.roll(2, 1), e_max)

    # --- dedupe duplicate pairs: a stable sort on the packed key
    # (lo, hi), the order of lax.sort((lo, hi, idx), num_keys=2), so the
    # first of a run of duplicates is the lowest edge index; edges not
    # alive2 sort after every alive2 one, in index order ---
    idx = torch.arange(E, device=eu.device)
    lo_k = torch.where(alive2, eu3, C)
    hi_k = torch.where(alive2, ev3, idx)
    key = lo_k * (max(C, E) + 1) + hi_k
    permE = torch.sort(key, stable=True).indices
    lo_s = lo_k[permE]
    hi_s = hi_k[permE]
    alive_s = alive2[permE]
    table_s = state["e_table"][permE]
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=eu.device),
         (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])])
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = first & alive_s

    am3 = alive_s[:, None, None]
    k3 = keep[:, None, None]
    ea_s = e_add[permE]
    ps = _segment_sum(torch.where(am3, ea_s, 0.0), seg_id, E, sorted=True)
    st["e_add"] = torch.where(k3, ps[seg_id], ea_s)
    em_s = e_min[permE]
    pm = torch.full_like(em_s, POS_INF)
    _scatter_reduce_(pm, seg_id, torch.where(am3, em_s, POS_INF), "amin")
    st["e_min"] = torch.where(k3, pm[seg_id], em_s)
    ex_s = e_max[permE]
    px = torch.full_like(ex_s, NEG_INF)
    _scatter_reduce_(px, seg_id, torch.where(am3, ex_s, NEG_INF), "amax")
    st["e_max"] = torch.where(k3, px[seg_id], ex_s)

    # table: any duplicate in table keeps the pair a candidate
    # (boundary_table update() rekeys existing entries)
    tbl = torch.zeros(E, dtype=torch.int64, device=eu.device)
    _scatter_reduce_(tbl, seg_id, (alive_s & table_s).to(torch.int64),
                     "amax")
    st["e_table"] = torch.where(keep, tbl[seg_id] > 0, table_s)
    st["e_lo"] = lo_s
    st["eu"] = eu3[permE]
    st["ev"] = ev3[permE]
    st["e_alive"] = alive_s & keep
    st["next_id"] = state["next_id"] + n_new

    n_scored = valid.sum()
    n_left = (st["e_alive"] & st["e_table"]).sum()
    return st, rows, probs, ok, n_left, n_scored, n_new, alive2.sum()


def _edge_capacity(E: int, n_live: int, k: int) -> int:
    """The loop's next capacity exponent: the k' >= k of the smallest
    capacity ceil(E / 2**k') that holds ``n_live`` rows.  k only grows
    (live edges only die), so a merge sees at most ceil(log2 E) + 1 edge
    shapes, the same ones on every call: the caching allocator reuses
    the blocks of one call in the next, and a capture of the superstep
    can key on the shape.  Cutting to exactly ``n_live`` would make a new
    shape almost every superstep."""
    while (E - 1) >> k and n_live <= ((E - 1) >> (k + 1)) + 1:
        k += 1
    return k


def stage_bc_state(rag: Rag, cfg: FeatureConfig, device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None):
    """The loop's initial state on the device: ``build_state`` packed on
    the host and uploaded by ``state_to_device`` (floats in ``dtype``).
    Returns (device state, BcDeviceStatic), which
    ``merge_order_bc_device(..., state=...)`` takes as it is, and leaves
    unchanged, call after call.  The span ``bc.stage``."""
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    with profiling.span("bc.stage"):
        state_np, static = build_state(rag, cfg)
        state = state_to_device(state_np, dev, dt)
        synchronize(dev)
    return state, static


def merge_order_bc_device(rag: Rag, cfg: Optional[FeatureConfig],
                          predict_fn: Callable[[torch.Tensor], torch.Tensor],
                          max_supersteps: Optional[int] = None,
                          stats: Optional[dict] = None,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None,
                          state=None):
    """Batched classifier-in-the-loop merge on the device.

    predict_fn: feats [E, D] tensor -> merge probabilities [E] (e.g.
    models.forest.make_label_scorer, whose node tables live on the
    device).  Returns (order [n, 3] int64 label keys, probabilities [n])
    like glia_tpu's merge_order_bc_device: the per-superstep independent
    set of probability maxima is merged, supersteps run until no table
    candidate is left or ``max_supersteps`` is reached.

    ``state``: the (device state, BcDeviceStatic) of ``stage_bc_state``
    for ``rag``, staged once and reused by any number of calls, each
    under its own ``predict_fn``; the call reads it and writes nothing
    into it (``cfg`` and ``dtype`` are then not used: the state holds its
    features and its dtype).  Without it the call stages its own.

    A ``stats`` dict, when passed, receives n_supersteps, n_scored, E
    (the staged edges), feat_dim, merges_per_superstep (the rows of each
    superstep, in order), edge_rows_per_superstep (the edge rows each
    superstep ran on: E, then halved while the live edges fit) and the
    wall seconds of staging (t_build_state, host packing and
    upload; 0 with ``state``) and of the superstep loop (t_merge_loop).

    The call is the span ``bc.merge``, with ``bc.stage`` (staging, without
    ``state``), ``bc.features``, ``bc.score`` (``predict_fn``),
    ``bc.commit`` (selection, records, rekey, dedupe), ``bc.step_read``
    (the one host read a superstep) and ``bc.readback`` (order,
    probabilities, ``order_to_keys``) inside it, and the counts
    ``bc.supersteps``, ``bc.scored`` and ``bc.edge_rows`` (Σ
    edge_rows_per_superstep).
    """
    with profiling.span("bc.merge"):
        t0 = time.perf_counter()
        if state is None:
            state, static = stage_bc_state(rag, cfg, device, dtype)
        else:
            state, static = state
        t1 = time.perf_counter()
        order, sals, n_scored, steps, rows = _merge_loop(
            state, static, predict_fn, max_supersteps)
        with profiling.span("bc.readback"):
            n_m = sum(steps)
            order_dense = order[:n_m].cpu().numpy()
            sals = sals[:n_m].cpu().numpy().astype(np.float64)
            n_scored = int(n_scored)
            keys = order_to_keys(order_dense, n_m, rag)
        t2 = time.perf_counter()
        profiling.count("bc.supersteps", len(steps))
        profiling.count("bc.scored", n_scored)
    if stats is not None:
        stats.update(n_supersteps=len(steps), n_scored=n_scored,
                     E=static.E, feat_dim=static.feat_dim,
                     merges_per_superstep=steps,
                     edge_rows_per_superstep=rows,
                     t_build_state=t1 - t0, t_merge_loop=t2 - t1)
    return keys, sals


def _merge_loop(state, static: BcDeviceStatic, predict_fn: Callable,
                max_supersteps: Optional[int]):
    """The supersteps from ``state``: (order rows [R, 3] dense ids (one
    spare row), their probabilities, candidates scored (a device
    scalar), merges of each superstep, edge rows of each superstep).
    After each superstep the edge arrays are cut to the capacity
    ``_edge_capacity`` gives for its live edges (views: nothing moves)."""
    dev = state["eu"].device
    if max_supersteps is None:
        max_supersteps = 4 * int(np.ceil(np.log2(max(static.R, 2)))) + 16
    R, E = static.R, static.E
    max_m = max(R - 1, 1)
    # one extra row: the dump slot for rows of edges not merged
    order = torch.full((max_m + 1, 3), -1, dtype=torch.int64, device=dev)
    sal = torch.zeros(max_m + 1, dtype=state["c_add"].dtype, device=dev)
    n_scored = torch.zeros((), dtype=torch.int64, device=dev)
    with profiling.span("bc.step_read"):
        n_left = int((state["e_alive"] & state["e_table"]).sum())
    steps, edge_rows, k = [], [], 0
    while n_left > 0 and len(steps) < max_supersteps:
        edge_rows.append(state["eu"].shape[0])
        profiling.count("bc.edge_rows", edge_rows[-1])
        state, rows, probs, ok, n_left_t, scored, n_new, n_live = superstep(
            state, static, predict_fn)
        with profiling.span("bc.commit"):
            slot = torch.where(ok, rows[:, 2] - R, max_m)
            order[slot] = rows
            sal[slot] = probs
            n_scored += scored
            read = torch.stack([n_left_t, n_new, n_live])
        with profiling.span("bc.step_read"):
            n_left, n, n_live = read.tolist()
        steps.append(n)
        k2 = _edge_capacity(E, n_live, k)
        if k2 > k:
            k, cap = k2, ((E - 1) >> k2) + 1
            state = {key: v[:cap] if key in EDGE_KEYS else v
                     for key, v in state.items()}
    return order, sal, n_scored, steps, edge_rows
