"""On-device greedy merge by boundary statistic (pb policies), PyTorch.

Counterpart of glia_tpu.graph.merge_device.  The reference's hot loop is
a serial priority queue (code/type/boundary_table.hxx:122-167).  Engines:

  - ``merge_serial_device``: that loop on the device, one merge per
    iteration, the host engine's order and saliencies for the pooled mean.
  - mode="fused": every superstep runs depth-limited Boruvka star/chain
    contraction over the whole edge list: every region selects its
    minimum incident edge (ties by lowest edge index); each component of
    the selection forest holds exactly one mutual-minimum 2-cycle (its
    root); every vertex within ``dmax`` parent hops of its root attaches
    this superstep, emitted as a chain of binary (r0, r1, r2) triples in
    (statistic, hop) order, so parents attach before children; the
    remaining edges are rekeyed and duplicate pairs are combined by one
    sort and one segment sum.  O(log R) supersteps on typical RAGs.
  - mode="fused_ms": the same supersteps in phases; between phases the
    live edges and the vertices that still have one move into smaller
    capacities and a compact local id space (alive counts collapse fast),
    the order still recorded in global ids.  The capacity plan is
    measured on the first call per shape and replayed after.
  - mode="chunked": mutual-minimum matching supersteps (an independent
    set of edges a superstep), with the live edges compacted on the host's
    command into power-of-two capacities every few supersteps.

All three of the reference's saliency policies ride the same superstep
through an additive per-edge payload: (sum, count) for the pooled mean,
a histogram sketch for the approximate median, and for median * minsize
the sketch plus region sizes pooled per vertex.  The exact merge-time
pooled means of a finished order come from one LCA-keyed segment sum
(``exact_saliency_device``); exact medians from a serial host replay.

Regions are dense indices [0, R); merged regions get fresh ids R, R+1, ...
so the emitted order aligns with the reference's key scheme when composed
with the RAG's key table (``order_to_keys``).

A first run's supersteps are a Python loop with one host read each (the
loop condition).  Once a multi-phase plan is memoized, a run of it is
one program of tensors with no host read (``_plan_program``: every phase,
transition and, for ``merge_batched_device_exact``, the exact saliencies),
whose scalars the host reads in one copy; on a CUDA device the program is
captured once per plan and shape into a CUDA graph and replayed
(``plan_graph_info``).  Plans of the pooled mean persist between
processes in the store that ``utils.enable_persistent_cache`` names.
Every segment sum goes through ``segment_sum_auto``: the hand-written CUDA
kernel on the card, ``index_add_`` on the CPU.  Indices are int64 tensors.

Two environment switches, read as glia_tpu reads them: GLIA_MERGE_DEBUG
(any non-empty value) makes a multi-phase call that is given a ``stats``
dict run its phases one by one, the device synchronized around each, and
record per-phase walls and supersteps and per-transition walls and alive
counts; GLIA_MERGE_NOPACK64 (set, and not 0 / false / no / off) runs the
unpacked hop and sort forms of every fused superstep.  Neither changes a
row or a saliency.  Both are diagnostic A/B switches, kept to match
glia_tpu: the unpacked forms give the same bits about 30 % slower, and
no mode of the port needs them.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import (DeviceLike, default_dtype, resolve_device,
                      synchronize)
from ..ops.segment_csr import segment_sum_auto
from ..utils import profiling
from ..utils.cache import plan_store_dir

BIG32 = 2 ** 31 - 1
# what GLIA_MERGE_DEBUG records into a multi-phase call's stats dict
DEBUG_KEYS = ("phase_s", "phase_steps", "trans_s", "alive_at_transition")


def _env_flag(name):
    """An environment toggle as a boolean ('', '0', 'false', 'no', 'off'
    are off), glia_tpu's parse."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


def _pack64_enabled():
    """Packed hop / sort keys (the default); GLIA_MERGE_NOPACK64 turns
    them off, glia_tpu's A/B switch of its packed emission sort.  A
    diagnostic switch, not a mode to run: the same bits, slower."""
    return not _env_flag("GLIA_MERGE_NOPACK64")


def _merge_debug(stats):
    """GLIA_MERGE_DEBUG is on for a call given a ``stats`` dict.  Any
    non-empty value is on, "0" included: glia_tpu reads the variable with
    ``os.environ.get`` and not with ``_env_flag``."""
    return stats is not None and bool(os.environ.get("GLIA_MERGE_DEBUG"))

# ---------------------------------------------------------------------------
# host packing of the RAG
# ---------------------------------------------------------------------------

def edge_mean_arrays(rag, pb_image):
    """Per-edge (sum, count) of boundary pb + dense endpoint indices."""
    pb = np.asarray(pb_image, dtype=np.float64).ravel()
    E = rag.n_edges
    eid = np.repeat(np.arange(E), np.diff(rag.edge_ptr))
    s = np.bincount(eid, weights=pb[rag.edge_pixels], minlength=E)
    c = np.diff(rag.edge_ptr).astype(np.float64)
    u = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    v = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    return u, v, s, c


def edge_hist_arrays(rag, pb_image, n_bins=32, lo=0.0, hi=1.0):
    """Per-edge boundary-pb histogram sketch [E, n_bins] + endpoints.

    The histogram is the mergeable sketch for the approx-median policy:
    histograms add under splicing, and the upper median is read off the
    cumulative counts to bin resolution."""
    pb = np.asarray(pb_image, dtype=np.float64).ravel()
    E = rag.n_edges
    eid = np.repeat(np.arange(E), np.diff(rag.edge_ptr))
    vals = pb[rag.edge_pixels]
    bins = np.clip(((vals - lo) / (hi - lo) * n_bins).astype(np.int64),
                   0, n_bins - 1)
    h = np.zeros((E, n_bins))
    np.add.at(h, (eid, bins), 1.0)
    u = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    v = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    return u, v, h


# ---------------------------------------------------------------------------
# merge statistics of a payload
# ---------------------------------------------------------------------------

def hist_median_stat(h: torch.Tensor, lo=0.0, hi=1.0) -> torch.Tensor:
    """Approx upper median from histogram rows: bin center of the first
    bin whose cumulative count exceeds n//2 (amedian = sorted[n//2]).  An
    empty row reads bin 0."""
    n_bins = h.shape[-1]
    k = torch.div(h.sum(dim=-1), 2.0, rounding_mode="floor")
    cum = torch.cumsum(h, dim=-1)
    # argmax returns the first maximum: the first bin above k
    idx = torch.argmax((cum > k[..., None]).to(torch.int32), dim=-1)
    width = (hi - lo) / n_bins
    return lo + (idx.to(h.dtype) + 0.5) * width


def _mean_stat_packed(payload):
    """Mean over a single packed [E, 2] (sum, count) payload."""
    (sc,) = payload
    return sc[:, 0] / torch.clamp(sc[:, 1], min=1.0)


# the statistic functions of the histogram policies, one per (lo, hi) for
# the life of the process: the multi-phase engine's plan memo is keyed by
# the function, so a second call with the same range finds its plan
_HIST_STATS = {}
_MINSIZE_STATS = {}


def _hist_stat(lo, hi):
    fn = _HIST_STATS.get((lo, hi))
    if fn is None:
        def fn(payload):
            (h,) = payload
            return hist_median_stat(h, lo, hi)
        _HIST_STATS[(lo, hi)] = fn
    return fn


def _minsize_stat(lo, hi):
    fn = _MINSIZE_STATS.get((lo, hi))
    if fn is None:
        def fn(payload, uu, vv, vsz):
            (h,) = payload
            return hist_median_stat(h, lo, hi) * torch.minimum(vsz[uu],
                                                               vsz[vv])
        _MINSIZE_STATS[(lo, hi)] = fn
    return fn


# ---------------------------------------------------------------------------
# tensor helpers
# ---------------------------------------------------------------------------

def _scatter_min_(target, index, src):
    """target[index[i]] = min(target[index[i]], src[i]) in place; the
    target's fill takes part (include_self)."""
    return target.scatter_reduce_(0, index, src, "amin", include_self=True)


def _first_of_runs(*sorted_keys):
    """Mask of the rows that start a run of equal key tuples."""
    dev = sorted_keys[0].device
    change = sorted_keys[0][1:] != sorted_keys[0][:-1]
    for k in sorted_keys[1:]:
        change = change | (k[1:] != k[:-1])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=dev), change])


def _stat_bits(stat, alive):
    """The order of statistics: the int32 bit pattern of the float32 value
    (monotone for floats >= 0), also when the payload is float64; dead
    edges read ``BIG32``, above the bits of inf.  Float32 denormals count
    as 0, as in glia_tpu: XLA flushes them to zero on the CPU, and the
    TPU has none."""
    p32 = stat.to(torch.float32)
    p32 = torch.where(p32.abs() < torch.finfo(torch.float32).tiny, 0.0, p32)
    return torch.where(alive, p32.view(torch.int32).long(), BIG32)


def _dedupe(u2, v2, alive2, payload, n_ids):
    """Combine duplicate pairs of the live edges: a stable sort on the
    packed (lo, hi) key (a dead edge's ``hi`` is its own index, so it sorts
    alone), so the first of a run of duplicates is the lowest edge index;
    then one segment sum over the runs, whose ids are sorted.  Returns
    (u, v, payload, alive) in the sorted order."""
    E = u2.shape[0]
    idx = torch.arange(E, device=u2.device)
    lo_k = torch.where(alive2, torch.minimum(u2, v2), n_ids)
    hi_k = torch.where(alive2, torch.maximum(u2, v2), idx)
    perm = torch.sort(lo_k * (max(n_ids, E) + 1) + hi_k, stable=True).indices
    alive_s = alive2[perm]
    pfirst = _first_of_runs(lo_k[perm], hi_k[perm])
    seg_id = torch.cumsum(pfirst.long(), 0) - 1
    keep = pfirst & alive_s
    combined = []
    for p in payload:
        ps = p[perm]
        am = alive_s[:, None] if ps.ndim == 2 else alive_s
        km = keep[:, None] if ps.ndim == 2 else keep
        pseg = segment_sum_auto(torch.where(am, ps, 0.0), seg_id, E,
                                sorted=True)
        combined.append(torch.where(km, pseg[seg_id], ps))
    return u2[perm], v2[perm], tuple(combined), alive_s & keep


def _as_tensor(a, dev):
    """``a`` on ``dev``: a tensor as it is, anything else through a numpy
    copy (arrays handed in may be read-only)."""
    if torch.is_tensor(a):
        return a.to(dev)
    return torch.tensor(np.asarray(a), device=dev)


def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32"): the memo keys' and the
    plan store's spelling."""
    return str(dtype).replace("torch.", "")


def _min(a, b):
    """min of two ints or 0-d tensors, with no host read."""
    if not torch.is_tensor(a):
        a, b = b, a
    if not torch.is_tensor(a):
        return min(a, b)
    return torch.minimum(a, b) if torch.is_tensor(b) else torch.clamp(a,
                                                                       max=b)


def _as_index(a, dev):
    return _as_tensor(a, dev).long()


def _as_float(a, dev, dtype):
    return _as_tensor(a, dev).to(dtype)


def _order_buffers(max_m, dtype, dev):
    """The order rows [max_m + 1, 3] (-1 where unrecorded) and saliencies
    [max_m + 1]; the last row is the dump slot of rows not recorded."""
    return (torch.full((max_m + 1, 3), -1, dtype=torch.int64, device=dev),
            torch.zeros(max_m + 1, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# the exact serial engine
# ---------------------------------------------------------------------------

# merges between two host reads of the serial engine's loop condition; the
# iterations after the last merge change nothing
_SERIAL_READ_EVERY = 64


def merge_serial_device(u, v, s, c, n_regions,
                        dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = None):
    """Exact serial greedy mean-policy merge on the device: one merge per
    iteration (argmin + masked rekey + combine of the merged pair's
    duplicate boundaries), all fixed-shape vector ops over the edge arrays.
    Reproduces the host engine's merge order and saliencies for the pooled
    mean, ties broken by the lowest edge index.

    Every iteration is guarded on the device by its own loop condition
    (merges left and a live edge), so the host reads that condition only
    every ``_SERIAL_READ_EVERY`` iterations.  Returns (order [max_m, 3]
    int64 dense-index triples, rows beyond n_merges -1; saliencies
    [max_m]; n_merges)."""
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    E = len(u)
    R = int(n_regions)
    max_m = max(R - 1, 1)
    n_ids = R + max_m
    u = _as_index(u, dev)
    v = _as_index(v, dev)
    s = _as_float(s, dev, dt)
    c = _as_float(c, dev, dt)
    order, sal = _order_buffers(max_m, dt, dev)
    if E == 0:
        return order[:max_m], sal[:max_m], 0
    idx = torch.arange(E, device=dev)
    alive = torch.ones(E, dtype=torch.bool, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(max_m):
        if it and it % _SERIAL_READ_EVERY == 0 and not bool(
                (i < max_m) & alive.any()):
            break
        go = (i < max_m) & alive.any()
        stat = torch.where(alive, s / torch.clamp(c, min=1.0),
                           float("inf"))
        e = torch.argmin(stat)             # the first minimum: lowest index
        a, b = u[e], v[e]
        r2 = R + i
        slot = torch.where(go, i, max_m)
        order[slot] = torch.stack([a, b, r2])
        sal[slot] = -stat[e]
        alive = alive & ~(go & (idx == e))
        touch = go & alive & ((u == a) | (u == b) | (v == a) | (v == b))
        u = torch.where(touch & ((u == a) | (u == b)), r2, u)
        v = torch.where(touch & ((v == a) | (v == b)), r2, v)
        # the partner is the endpoint that is not r2; the duplicate edges
        # of a partner combine into its lowest-index edge
        partner = torch.where(u == r2, v, u)
        can = torch.full((n_ids,), E, dtype=torch.int64, device=dev)
        _scatter_min_(can, partner, torch.where(touch, idx, E))
        is_can = touch & (can[partner] == idx)
        # before the merge every pair was unique, so a partner has at most
        # one edge to a and one to b: each sum adds at most two non-zero
        # values and zeros, which gives the same bits in any order, so the
        # atomic entry of the segment sum is reproducible here
        s_tot = segment_sum_auto(torch.where(touch, s, 0.0), partner, n_ids)
        c_tot = segment_sum_auto(torch.where(touch, c, 0.0), partner, n_ids)
        s = torch.where(is_can, s_tot[partner], s)
        c = torch.where(is_can, c_tot[partner], c)
        alive = alive & (~touch | is_can)
        i = i + go.long()
    return order[:max_m], sal[:max_m], int(i)


# ---------------------------------------------------------------------------
# the chunked engine (mutual-minimum matching, host-driven compaction)
# ---------------------------------------------------------------------------

def _chunk_superstep(stat_fn, R, n_m, u, v, payload, alive, order, sal,
                     select_rounds):
    """One superstep of the chunked engine: merge every live edge that is
    the (index-tiebroken) minimum of both its endpoints' live edges -- a
    conflict-free independent set -- give the merges fresh ids in edge
    order, relabel and combine duplicate pairs.  ``select_rounds`` > 1
    grows the set by further matching rounds over the still-free
    vertices.  Updates ``order`` / ``sal`` in place; returns (u, v,
    payload, alive, n_new)."""
    E = u.shape[0]
    max_m = max(R - 1, 1)
    n_ids = R + max_m
    dev = u.device
    idx = torch.arange(E, device=dev)
    stat = torch.where(alive, stat_fn(payload), float("inf"))
    bits = _stat_bits(stat, alive)
    is_merge = torch.zeros(E, dtype=torch.bool, device=dev)
    free = torch.ones(n_ids, dtype=torch.bool, device=dev)
    for _ in range(select_rounds):
        eligible = alive & ~is_merge & free[u] & free[v]
        b = torch.where(eligible, bits, BIG32)
        rbits = torch.full((n_ids,), BIG32, dtype=torch.int64, device=dev)
        _scatter_min_(rbits, u, b)
        _scatter_min_(rbits, v, b)
        cand = eligible & (rbits[u] == b) & (rbits[v] == b)
        ridx = torch.full((n_ids,), E, dtype=torch.int64, device=dev)
        _scatter_min_(ridx, u, torch.where(cand, idx, E))
        _scatter_min_(ridx, v, torch.where(cand, idx, E))
        new = cand & (ridx[u] == idx) & (ridx[v] == idx)
        is_merge = is_merge | new
        if select_rounds > 1:
            occ = torch.zeros(n_ids, dtype=torch.int64, device=dev)
            occ.scatter_reduce_(0, u, new.long(), "amax")
            occ.scatter_reduce_(0, v, new.long(), "amax")
            free = free & (occ == 0)
    # fresh ids in edge order
    rank = torch.cumsum(is_merge.long(), 0) - 1
    ok = is_merge & (n_m + rank < max_m)
    r2 = R + n_m + rank
    slot = torch.where(ok, n_m + rank, max_m)
    order[slot] = torch.where(ok[:, None], torch.stack([u, v, r2], dim=1),
                              -1)
    sal[slot] = torch.where(ok, -stat, 0.0).to(sal.dtype)
    # relabel through a lut over region ids (sentinel slot n_ids)
    lut = torch.arange(n_ids + 1, device=dev)
    lut[torch.where(ok, u, n_ids)] = torch.where(ok, r2, n_ids)
    lut[torch.where(ok, v, n_ids)] = torch.where(ok, r2, n_ids)
    u2 = lut[u]
    v2 = lut[v]
    alive2 = alive & ~ok & (u2 != v2)
    u3, v3, payload, alive3 = _dedupe(u2, v2, alive2, payload, n_ids)
    return u3, v3, payload, alive3, ok.sum()


def _superstep_merge_core(u, v, payload, stat_fn, n_regions,
                          max_supersteps, dtype, device, select_rounds=1,
                          chunk=6, stats=None):
    """The chunked batched merge: supersteps of ``_chunk_superstep`` in
    pieces of ``chunk``; between pieces the live edges are compacted, a
    stable partition to the front, into the next power-of-two capacity
    (at least 256), so the tail supersteps run on small arrays.  The loop
    condition is read on the host after every superstep.

    Returns (order [max_m, 3] int64, saliencies = -stat, n_merges)."""
    E = len(u)
    R = int(n_regions)
    max_m = max(R - 1, 1)
    u_d = _as_index(u, device)
    v_d = _as_index(v, device)
    payload_d = tuple(_as_float(p, device, dtype) for p in payload)
    alive = torch.ones(E, dtype=torch.bool, device=device)
    order, sal = _order_buffers(max_m, dtype, device)
    n_m, total_steps, any_alive = 0, 0, E > 0
    cap = E
    buckets = [E]
    while total_steps < max_supersteps:
        steps = min(chunk, max_supersteps - total_steps)
        done = 0
        while done < steps and any_alive and n_m < max_m:
            u_d, v_d, payload_d, alive, n_new = _chunk_superstep(
                stat_fn, R, n_m, u_d, v_d, payload_d, alive, order, sal,
                select_rounds)
            done += 1
            n_new_h, any_alive = torch.stack(
                [n_new, alive.any().long()]).tolist()
            n_m = min(n_m + n_new_h, max_m)
        total_steps += done
        if n_m >= max_m:
            break
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        new_cap = max(256, 1 << int(np.ceil(np.log2(max(n_alive, 1)))))
        if new_cap < cap:
            perm = torch.sort((~alive).to(torch.uint8),
                              stable=True).indices[:new_cap]
            u_d, v_d, alive = u_d[perm], v_d[perm], alive[perm]
            payload_d = tuple(p[perm] for p in payload_d)
            cap = new_cap
            buckets.append(cap)
    if stats is not None:
        stats["n_supersteps"] = total_steps
        stats["buckets"] = buckets
    return order[:max_m], sal[:max_m], n_m


# ---------------------------------------------------------------------------
# the fused engine: single-phase, and multi-phase over shrinking capacities
# ---------------------------------------------------------------------------

@dataclass
class _FusedStatic:
    """Sizes and options of one phase of the fused engine (fixed over its
    supersteps).  A phase runs in a local id space: ``E`` edge rows,
    ``R`` local regions and fresh local ids from R on; it records order
    rows in global ids, region x < R as ``g_of[x]`` and fresh local
    R + t as ``R_glob + n_m_base + t`` (both spaces allocate fresh ids
    contiguously in merge order; ``n_m_base`` is the number of merges
    recorded before the phase).  The single-phase engine is the phase
    whose map is the identity (``g_of`` None)."""

    stat_fn: Callable
    E: int
    R: int
    dmax: int
    with_vsz: bool
    # hop count and root of a vertex pack into one integer h*(n_ids+1)+rt
    # (one gather per hop instead of two), and the emission sort's three
    # keys into one int64, while (dmax+2)*(n_ids+1) < 2**31; beyond that
    # both fall back to their unpacked forms
    pack_hr: bool
    R_glob: int

    @property
    def max_m(self) -> int:
        return max(self.R - 1, 1)

    @property
    def n_ids(self) -> int:
        return self.R + self.max_m

    @property
    def max_m_glob(self) -> int:
        return max(self.R_glob - 1, 1)


def _phase_static(stat_fn, E, R_loc, R_glob, dmax, with_vsz,
                  pack_hr=None):
    """The _FusedStatic of a phase; ``pack_hr=False`` forces the unpacked
    hop and sort forms that ids beyond the packing bound take (tests), as
    GLIA_MERGE_NOPACK64 does for every phase."""
    n_ids = R_loc + max(R_loc - 1, 1)
    fits = (int(dmax) + 2) * (n_ids + 1) < 2 ** 31
    return _FusedStatic(stat_fn=stat_fn, E=E, R=R_loc, dmax=int(dmax),
                        with_vsz=with_vsz,
                        pack_hr=(fits and pack_hr is not False
                                 and _pack64_enabled()),
                        R_glob=R_glob)


def _contract_chains(parent, has, vbits, dmax: int, pack_hr: bool,
                     cap: int, fresh0: int):
    """Chain contraction of one superstep, shared by ``fused_superstep``
    and the sharded engine (parallel/merge_shard.py).

    ``parent`` [n_ids]: the other end of each vertex's minimum incident
    edge (the vertex itself where ``has`` is False); ``vbits``: that
    edge's statistic bits.  Attaches vertices up to ``dmax`` hops below
    the canonical root of each mutual-minimum 2-cycle, orders them by
    (component, edge stat, hop, id), records the first ``cap`` and
    contracts each component into its last recorded fresh id
    (``fresh0`` + its rank).  Returns (vs, rt_s, grank, first_in_run, ok,
    lut): the sorted vertices, each row's root (n_ids for none), its rank
    among the attaches, whether it starts its chain, whether it is
    recorded, and the id lut [n_ids]."""
    n_ids = parent.shape[0]
    dev = parent.device
    vid = torch.arange(n_ids, device=dev)

    # --- roots: canonical vertex of each mutual-minimum 2-cycle ---
    is_root = (parent[parent] == vid) & (vid < parent)

    # --- depth-limited hop counts + root propagation ---
    inf_h = dmax + 1
    if pack_hr:
        W = n_ids + 1
        known_lim = inf_h * W
        code = torch.where(is_root, vid, known_lim + n_ids)
        for _ in range(dmax):
            cp = code[parent]
            code = torch.where(code < known_lim, code,
                               torch.where(cp < known_lim, cp + W, code))
        h = code // W
        rt = torch.where(code < known_lim, code % W, n_ids)
    else:
        h = torch.where(is_root, 0, inf_h)
        rt = torch.where(is_root, vid, n_ids)
        for _ in range(dmax):
            hp = h[parent]
            h = torch.minimum(h, torch.where(hp < inf_h, hp + 1, inf_h))
            rt = torch.where(rt < n_ids, rt, rt[parent])
    attach = (h >= 1) & (h <= dmax) & has

    # --- order vertices by (component, edge stat, hop, id) ---
    # stat(m(child)) >= stat(m(parent)) always (m(v) is incident to
    # parent(v), whose m is ITS minimum incident edge), so stat-major
    # order still attaches parents before children (hop breaks stat
    # ties) AND makes each chain monotone non-decreasing in stat -- the
    # monotonized threshold cut then judges every attach by exactly its
    # own edge's statistic, like the serial order.
    rt_key = torch.where(attach | is_root, rt, n_ids)
    b_key = torch.where(attach, vbits, -2 ** 31) + 2 ** 31   # roots first
    h_key = torch.where(attach | is_root, h, inf_h)
    # the vertex id is the last key: the sorts are stable and start from
    # the vertices in id order
    if pack_hr:
        key = (rt_key * 2 ** 32 + b_key) * (inf_h + 1) + h_key
        vs = torch.sort(key, stable=True).indices
    else:
        vs = torch.sort(h_key, stable=True).indices
        vs = vs[torch.sort(b_key[vs], stable=True).indices]
        vs = vs[torch.sort(rt_key[vs], stable=True).indices]
    rt_s = rt_key[vs]
    h_s = h_key[vs]
    is_merge = (rt_s < n_ids) & (h_s >= 1)              # attached rows
    grank = torch.cumsum(is_merge.long(), 0) - 1
    first = _first_of_runs(rt_s)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    first_in_run = is_merge & (torch.cat([true1, ~is_merge[:-1]]) | first)
    ok = is_merge & (grank < cap)

    # --- component final id lut (last merge of each run), local ids ---
    run_id = torch.cumsum(first.long(), 0) - 1
    last_rank = torch.full((n_ids + 1,), -1, dtype=torch.int64, device=dev)
    last_rank.scatter_reduce_(0, run_id, torch.where(ok, grank, -1), "amax",
                              include_self=True)
    last = last_rank[run_id]
    # only vertices whose own attach was RECORDED (ok is a prefix of the
    # global merge ranks, hence of each run's hop-ordered chain) plus the
    # run root are contracted; overflowed attaches stay put
    contracted = (rt_s < n_ids) & (last >= 0) & (ok | (h_s == 0))
    # (id n_ids-1 is a safe dump slot: ids allocated so far are
    # < fresh0 < n_ids - 1 while the loop still runs)
    lut = vid.clone()
    lut[torch.where(contracted, vs, n_ids - 1)] = torch.where(
        contracted, fresh0 + last, n_ids - 1)
    return vs, rt_s, grank, first_in_run, ok, lut


def fused_superstep(st: _FusedStatic, n_loc, u, v, payload, vstate,
                    alive, order, sal, n_m_base=0, g_of=None):
    """One superstep of the fused engine, a plain function on tensors.

    ``n_loc`` merges are recorded so far in this phase, ``n_m_base``
    before it: each a Python int or a 0-d int64 tensor on the device (the
    superstep then reads nothing back to the host).  ``order``
    [max_m_glob + 1, 3] and ``sal`` [max_m_glob + 1] are updated in place
    (their last row is the dump slot of rows not recorded).  ``g_of`` [R]:
    the global id of each local region (None for the identity).  Returns
    (u, v, payload, vstate, alive, n_new) with ``n_new`` the number of
    merges recorded, as a tensor."""
    E, R, dmax, max_m, n_ids = st.E, st.R, st.dmax, st.max_m, st.n_ids
    max_m_glob = st.max_m_glob
    # the global id of this phase's first fresh local id, at its start
    Rb = st.R_glob + n_m_base
    dev = u.device
    idx = torch.arange(E, device=dev)
    vid = torch.arange(n_ids, device=dev)

    def gfun(x):
        if g_of is None:
            return x
        return torch.where(x < R, g_of[torch.clamp(x, 0, R - 1)],
                           Rb + (x - R))

    if st.with_vsz:
        stat = st.stat_fn(payload, u, v, vstate[0])
    else:
        stat = st.stat_fn(payload)
    stat = torch.where(alive, stat, float("inf"))
    bits = _stat_bits(stat, alive)

    # --- per-vertex minimum incident edge m(v), ties by edge index ---
    rbits = torch.full((n_ids,), BIG32, dtype=torch.int64, device=dev)
    _scatter_min_(rbits, u, bits)
    _scatter_min_(rbits, v, bits)
    at_min_u = alive & (rbits[u] == bits)
    at_min_v = alive & (rbits[v] == bits)
    m = torch.full((n_ids,), E, dtype=torch.int64, device=dev)
    _scatter_min_(m, u, torch.where(at_min_u, idx, E))
    _scatter_min_(m, v, torch.where(at_min_v, idx, E))   # [n_ids]; E = none
    uv_pad = torch.cat([torch.stack([u, v], dim=1),
                        torch.full((1, 2), n_ids, dtype=torch.int64,
                                   device=dev)])
    muv = uv_pad[m]
    mu, mv = muv[:, 0], muv[:, 1]
    parent = torch.where(m < E, torch.where(mu == vid, mv, mu), vid)

    mbits = torch.cat([bits, bits.new_full((1,), BIG32)])[m]
    # two bounds: the phase's local id space and the global order buffer
    cap = _min(max_m - n_loc, max_m_glob - n_m_base - n_loc)
    vs, rt_s, grank, first_in_run, ok, lut = _contract_chains(
        parent, m < E, mbits, dmax, st.pack_hr, cap, R + n_loc)
    r2 = Rb + n_loc + grank                              # global ids
    r0 = torch.where(first_in_run, gfun(rt_s), r2 - 1)
    n_new = ok.sum()

    # saliency: the attached vertex's own selected edge's statistic
    m_s = m[vs]
    stat_pad = torch.cat([stat, stat.new_zeros(1)])
    sal_rows = -stat_pad[m_s]

    # rows not recorded all write the same values to the dump slot
    slot = torch.where(ok, n_m_base + n_loc + grank, max_m_glob)
    rows = torch.stack([r0, gfun(vs), r2], dim=1)
    order[slot] = torch.where(ok[:, None], rows, -1)
    sal[slot] = torch.where(ok, sal_rows.to(sal.dtype), 0.0)

    # consumed edges: each attached-and-recorded vertex's m edge
    used = torch.zeros(E + 1, dtype=torch.bool, device=dev)
    used[torch.where(ok, m_s, E)] = ok
    u2 = lut[u]
    v2 = lut[v]
    alive2 = alive & ~used[:E] & (u2 != v2)
    u3, v3, combined, alive3 = _dedupe(u2, v2, alive2, payload, n_ids)
    if st.with_vsz:
        # vertex payload (region sizes) pools additively through the
        # component lut: one segment sum per superstep
        vstate = tuple(segment_sum_auto(z, lut, n_ids) for z in vstate)
    return u3, v3, combined, vstate, alive3, n_new


def _run_phase(st, u, v, payload, vstate, alive, any_alive, order, sal,
               max_steps, n_m_base=0, g_of=None, n_loc=0):
    """Supersteps of one phase until ``max_steps``, no live edge, or no
    merge left in the local or the global id space, from ``n_loc`` merges
    recorded in the phase.  ``any_alive``: the host's knowledge that
    ``alive`` has a live edge.  The one host read of a superstep is the
    loop condition.  Returns (u, v, payload, vstate, alive, any_alive,
    merges recorded in the phase, supersteps)."""
    steps = 0
    while (steps < max_steps and any_alive and n_loc < st.max_m
           and n_m_base + n_loc < st.max_m_glob):
        u, v, payload, vstate, alive, n_new = fused_superstep(
            st, n_loc, u, v, payload, vstate, alive, order, sal,
            n_m_base=n_m_base, g_of=g_of)
        steps += 1
        n_new_h, any_alive = torch.stack(
            [n_new, alive.any().long()]).tolist()
        n_loc += n_new_h
    return u, v, payload, vstate, alive, bool(any_alive), n_loc, steps


def _run_phase_fixed(st, u, v, payload, vstate, alive, order, sal,
                     n_steps, n_m_base, g_of=None):
    """``n_steps`` supersteps of one phase with no host read: the loop of
    ``_run_phase`` unrolled, each superstep guarded by its condition on the
    device.  A superstep whose condition is false records nothing (no
    live edge attaches, or the merge bound leaves no room) and keeps the
    state as it was, so the result is the loop's; the superstep count
    advances only while the condition holds.  ``n_m_base``: a 0-d tensor.
    Returns (u, v, payload, vstate, alive, merges recorded, supersteps),
    the counts as 0-d tensors."""
    n_loc = torch.zeros((), dtype=torch.int64, device=u.device)
    done = torch.zeros_like(n_loc)
    for _ in range(n_steps):
        go = (alive.any() & (n_loc < st.max_m)
              & (n_m_base + n_loc < st.max_m_glob))
        u2, v2, p2, vs2, a2, n_new = fused_superstep(
            st, n_loc, u, v, payload, vstate, alive, order, sal,
            n_m_base=n_m_base, g_of=g_of)
        u, v, alive = (torch.where(go, x2, x)
                       for x2, x in ((u2, u), (v2, v), (a2, alive)))
        payload = tuple(torch.where(go, x2, x) for x2, x in zip(p2, payload))
        vstate = tuple(torch.where(go, x2, x) for x2, x in zip(vs2, vstate))
        n_loc = n_loc + torch.where(go, n_new, 0)
        done = done + go.long()
    return u, v, payload, vstate, alive, n_loc, done


def _initial_state(u, v, payload, vsizes, R, dtype, device):
    """Edge arrays, payloads and vertex state of a fused run on ``device``:
    vsizes (optional [R]) becomes the vertex payload [R + max_m]."""
    max_m = max(R - 1, 1)
    vstate = ()
    if vsizes is not None:
        vsz = torch.zeros(R + max_m, dtype=dtype, device=device)
        vsz[:R] = _as_float(vsizes, device, dtype)
        vstate = (vsz,)
    return (_as_index(u, device), _as_index(v, device),
            tuple(_as_float(p, device, dtype) for p in payload), vstate)


def _fused_merge_core(u, v, payload, stat_fn, n_regions, max_supersteps,
                      dtype, device, dmax=4, stats=None, vsizes=None,
                      pack_hr=None):
    """Single-phase batched merge: supersteps at full edge capacity until
    no edge is alive, every merge is recorded or ``max_supersteps`` is
    reached.  vsizes (optional [R]): additive per-vertex payload (region
    sizes) made available to ``stat_fn(payload, u, v, vsz)`` -- the
    median * minsize policy's carrier.  ``pack_hr=False`` forces the
    unpacked hop and sort forms that ids beyond the packing bound take
    (for tests).

    Returns (order [max_m, 3] int64 dense triples, rows beyond n_merges
    -1; saliencies [max_m] = -stat; n_merges), tensors on ``device``."""
    E = len(u)
    R = int(n_regions)
    max_m = max(R - 1, 1)
    st = _phase_static(stat_fn, E, R, R, dmax, vsizes is not None,
                       pack_hr=pack_hr)
    u_d, v_d, payload_d, vstate = _initial_state(u, v, payload, vsizes, R,
                                                 dtype, device)
    alive = torch.ones(E, dtype=torch.bool, device=device)
    order, sal = _order_buffers(max_m, dtype, device)
    *_, n_m, steps = _run_phase(st, u_d, v_d, payload_d, vstate, alive,
                                E > 0, order, sal, max_supersteps)
    if stats is not None:
        stats["n_supersteps"] = steps
        stats["buckets"] = [E]
    return order[:max_m], sal[:max_m], n_m


def _phase_transition(u, v, payload, vstate, alive, g_of_prev,
                      n_m_base_prev, R_loc_prev, R_glob, E2, R2_cap):
    """Between two phases: compact the live edges into ``E2`` rows (in
    order) and remap the vertices that still have a live edge into
    [0, R2_cap) (in order), composing the local -> global id table; the
    vertex payload follows the remap.  Never drops data: returns an
    overflow flag (a tensor) instead, and the caller falls back.
    Returns (u, v, payload, vstate, alive, g_of, overflow)."""
    dev = u.device
    n_vert_prev = R_loc_prev + max(R_loc_prev - 1, 1)
    lid = torch.arange(n_vert_prev, device=dev)
    # fresh locals of the previous phase map with the base at its start
    Rb = R_glob + n_m_base_prev
    gl = torch.where(lid < R_loc_prev,
                     g_of_prev[torch.clamp(lid, 0, R_loc_prev - 1)],
                     Rb + (lid - R_loc_prev))
    # present: an endpoint of a live edge (slot n_vert_prev is a dump)
    pres = torch.zeros(n_vert_prev + 1, dtype=torch.bool, device=dev)
    pres.index_fill_(0, torch.where(alive, u, n_vert_prev), True)
    pres.index_fill_(0, torch.where(alive, v, n_vert_prev), True)
    pres = pres[:n_vert_prev]
    new_id = torch.cumsum(pres.long(), 0) - 1
    ovf_v = pres.sum() > R2_cap
    g2 = torch.zeros(R2_cap + 1, dtype=torch.int64, device=dev)
    g2[torch.where(pres, torch.clamp(new_id, 0, R2_cap - 1), R2_cap)] = \
        torch.where(pres, gl, 0)
    rank = torch.cumsum(alive.long(), 0) - 1
    ovf_e = alive.sum() > E2
    sl = torch.where(alive, torch.clamp(rank, 0, E2 - 1), E2)

    def compact(x, fill):
        buf = x.new_full((E2 + 1,) + tuple(x.shape[1:]), fill)
        am = alive[:, None] if x.ndim == 2 else alive
        buf[sl] = torch.where(am, x, fill)
        return buf[:E2]

    # after an overflow the ids are only kept in bounds: the run is
    # thrown away and the caller falls back
    new_id_in = torch.clamp(new_id, 0, R2_cap - 1)
    u2 = compact(new_id_in[u], 0)
    v2 = compact(new_id_in[v], 0)
    a2 = compact(alive, False)
    p2 = tuple(compact(p, 0.0) for p in payload)
    n_vert2 = R2_cap + max(R2_cap - 1, 1)
    vsl = torch.where(pres, torch.clamp(new_id, 0, n_vert2 - 1), n_vert2)
    vstate2 = []
    for z in vstate:
        buf = z.new_zeros(n_vert2 + 1)
        buf[vsl] = torch.where(pres, z[:n_vert_prev], 0.0)
        vstate2.append(buf[:n_vert2])
    return u2, v2, p2, tuple(vstate2), a2, g2[:R2_cap], ovf_v | ovf_e


def _tile_ceil(x, lo=256, tile=256):
    """Round a phase capacity up to a multiple of ``tile``, at least
    ``lo`` (capacities need not be powers of two)."""
    return max(lo, ((max(int(x), 1) + tile - 1) // tile) * tile)


def _cap_quantize(x, lo=256, tile=256):
    """Round a measured capacity UP to ~1/8-of-pow2 steps (tile-aligned):
    at most 8 distinct capacities per power-of-two bucket while staying
    within 12.5% of the measured need."""
    x = max(int(x), 1)
    step = max((1 << max(x.bit_length() - 1, 0)) // 8, tile)
    return max(lo, ((x + step - 1) // step) * step)


# realized multi-phase plans [(steps | None, E_cap, R_cap)] by (E, R,
# statistic, payload layout, dmax, dtype name, vertex payload), for the life
# of the process; a memoized plan replays without reading alive counts
_PLAN_MEMO = {}
# the most supersteps a memoized plan's last phase has run in any call (its
# eager continuation included), by the same key: the count a captured
# program runs that phase for
_PLAN_LAST_STEPS = {}


def _keep_last_steps(memo_key, steps):
    """Record a memoized plan's last-phase supersteps, keeping the largest
    count seen: data that needs one superstep more than the plan's graph
    runs goes on eagerly once, and the next call captures a graph that
    runs it (a guarded superstep that is not needed changes nothing).
    A raise counts plan.last_steps_raised."""
    old = _PLAN_LAST_STEPS.get(memo_key)
    if old is None or steps > old:
        _PLAN_LAST_STEPS[memo_key] = steps
        if old is not None:
            profiling.count("plan.last_steps_raised")


# ---------------------------------------------------------------------------
# the plan store: memoized plans between processes
# ---------------------------------------------------------------------------

_PLAN_STORE_FILE = "glia_plan_memo.json"
# the store file read last, so that each is read once a process
_PLAN_STORE_LOADED: list = [None]


def _plan_store_path() -> Optional[str]:
    d = plan_store_dir()
    return os.path.join(d, _PLAN_STORE_FILE) if d else None


def _plan_store_load():
    """Read the plan store once: the plans of the pooled-mean statistic
    (the histogram policies' statistics are closures, which rediscover in
    each process) and the exact saliencies' depth capacities, glia_tpu's
    layout ``{"plans": {key: plan}, "sal_L": {key: L}}``.  An entry the
    process already has wins.  A missing, stale or corrupt store means
    "rediscover": nothing is read from a file that does not parse whole."""
    path = _plan_store_path()
    if path is None or _PLAN_STORE_LOADED[0] == path:
        return
    _PLAN_STORE_LOADED[0] = path
    try:
        with open(path) as f:
            d = json.load(f)
        plans = {}
        for k, plan in d.get("plans", {}).items():
            E, R, dmax, dt, dt_struct, with_vsz = json.loads(k)
            key = (int(E), int(R), _mean_stat_packed, ((2, str(dt_struct)),),
                   int(dmax), str(dt), bool(with_vsz))
            plans[key] = [(None if n is None else int(n), int(e), int(r))
                          for n, e, r in plan]
        sal_L = {(int(E), int(M), int(R), str(dt)): int(L)
                 for (E, M, R, dt), L in (
                     (json.loads(k), L) for k, L in d.get("sal_L",
                                                          {}).items())}
    except (OSError, ValueError, TypeError, AttributeError):
        return
    for key, plan in plans.items():
        _PLAN_MEMO.setdefault(key, plan)
    for key, L in sal_L.items():
        _EXACT_SAL_L.setdefault(key, L)


def _plan_store_save():
    """Write the process's pooled-mean plans and depth capacities to the
    store (a temporary file renamed into place); nothing without a store,
    and a store that cannot be written is left as it was."""
    path = _plan_store_path()
    if path is None:
        return
    plans = {}
    for (E, R, stat_fn, struct, dmax, dt, with_vsz), plan in \
            _PLAN_MEMO.items():
        if stat_fn is not _mean_stat_packed or len(struct) != 1 \
                or struct[0][0] != 2:
            continue
        plans[json.dumps([E, R, dmax, dt, struct[0][1], with_vsz])] = [
            list(e) for e in plan]
    sal_L = {json.dumps(list(k)): L for k, L in _EXACT_SAL_L.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({"plans": plans, "sal_L": sal_L}, f)
        os.replace(tmp, path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the plan program: a memoized plan as one function of tensors
# ---------------------------------------------------------------------------

class _ProgramOut(NamedTuple):
    """What ``_plan_program`` returns, every field a tensor (or None).
    ``scalars``: [n_m, supersteps, overflow, a live edge left, merges of
    the last phase, its supersteps, converged], read by the host in one
    copy; ``state``: the last phase's (u, v, payload, vstate, alive) and
    ``g_of`` its id table, from which an unfinished last phase goes on."""
    order: torch.Tensor
    sal: torch.Tensor
    sal_exact: Optional[torch.Tensor]
    scalars: torch.Tensor
    state: tuple
    g_of: Optional[torch.Tensor]


def _plan_program(entries, stat_fn, R, dmax, max_supersteps, dtype,
                  with_vsz, last_steps, u0, v0, payload0, vstate0,
                  sal_L=None) -> _ProgramOut:
    """Every phase and transition of a memoized plan in one function of
    tensors with no host read (glia_tpu's one-program plan pipeline): each
    non-last phase runs its planned supersteps and the last one
    ``last_steps`` (the loop condition guarded on the device,
    ``_run_phase_fixed``).  With ``sal_L``, the exact merge-time pooled
    means of the order follow from the pooled-mean payload (payload0[0]
    as (sum, count) columns) by the LCA pass at depth capacity ``sal_L``.
    On a CUDA device this is what a plan graph captures; on the CPU it
    runs as it is."""
    dev = u0.device
    max_m = max(R - 1, 1)
    order, sal = _order_buffers(max_m, dtype, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    alive = torch.ones(entries[0][1], dtype=torch.bool, device=dev)
    g_of = torch.arange(R, device=dev)
    u, v, payload, vstate = u0, v0, payload0, vstate0
    n_base, total = zero, zero
    for pi, (steps, E_cap, R_cap) in enumerate(entries):
        last = pi == len(entries) - 1
        if last:
            steps = last_steps
        elif steps is None:
            steps = max_supersteps
        st = _phase_static(stat_fn, E_cap, R_cap, R, dmax, with_vsz)
        # the first phase maps by the identity, as glia_tpu's pipeline
        g_phase = None if pi == 0 else g_of
        base = n_base
        u, v, payload, vstate, alive, n_loc, done = _run_phase_fixed(
            st, u, v, payload, vstate, alive, order, sal, steps, base,
            g_phase)
        total = total + done
        n_base = base + n_loc
        if not last:
            u, v, payload, vstate, alive, g_of, o = _phase_transition(
                u, v, payload, vstate, alive, g_of, base, R_cap, R,
                *entries[pi + 1][1:])
            ovf = ovf | o
    sal_exact, conv = None, torch.ones((), dtype=torch.bool, device=dev)
    if sal_L is not None:
        (sc,) = payload0
        ex, conv = _exact_saliency_pass(u0, v0, sc[:, 0], sc[:, 1],
                                        order[:max_m], R, sal_L)
        sal_exact = torch.where(torch.isnan(ex), sal[:max_m], -ex)
    scalars = torch.stack([n_base, total, ovf.long(), alive.any().long(),
                           n_loc, done, conv.long()])
    return _ProgramOut(order, sal, sal_exact, scalars,
                       (u, v, payload, vstate, alive), g_phase)


def _flat(inputs):
    u, v, payload, vstate = inputs
    return (u, v, *payload, *vstate)


class _PlanGraph:
    """A plan program captured into a CUDA graph, with the static tensors
    it reads (a copy of each input) and writes (its outputs, overwritten
    by every replay).  Capturing raises on anything that would read the
    device from the host; no call falls back to running eagerly."""

    def __init__(self, program, inputs, info):
        from ..ops import cuda as kcuda

        self.info = info
        dev = inputs[0].device
        self.inputs = (inputs[0].clone(), inputs[1].clone(),
                       tuple(p.clone() for p in inputs[2]),
                       tuple(z.clone() for z in inputs[3]))
        with profiling.span("merge.graph_capture") as sp:
            # one run on a side stream first, as torch.cuda.graphs asks of
            # a capture (lazy initialization stays out of the graph)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                program(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with kcuda.graph_launch_tally() as tally:
                with torch.cuda.graph(self.graph):
                    reserved = torch.cuda.memory_reserved(dev)
                    self.outputs = program(*self.inputs)
                    self.pool_bytes = (torch.cuda.memory_reserved(dev)
                                       - reserved)
            torch.cuda.synchronize(dev)
        self.capture_s = sp.seconds
        self.launches = tally
        self.replays = 0

    def replay(self, inputs) -> _ProgramOut:
        from ..ops import cuda as kcuda

        with profiling.span("merge.graph_inputs"):
            for dst, src in zip(_flat(self.inputs), _flat(inputs)):
                dst.copy_(src)
        with profiling.span("merge.graph_launch"):
            self.graph.replay()
        kcuda.count_graph_replay(self.launches)
        self.replays += 1
        return self.outputs


# captured plan programs by plan, statistic, sizes, options and device, for
# the life of the process (unbounded, as glia_tpu's compiled programs);
# each holds a private memory pool.  One graph a plan: a call with another
# last-phase count captures again, in place of the plan's graph
_PLAN_GRAPHS = {}


def plan_graph_info():
    """One dict per captured plan program: edges, regions, phases, the
    last phase's supersteps, the saliency depth capacity (None for a
    merge alone), dtype, whether it was captured packed (pack64), capture
    seconds (with its warm-up run), the bytes of its
    memory pool, replays so far, and each kernel's launches and bytes
    moved per replay."""
    return [dict(g.info, capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                 replays=g.replays, launches_per_replay=dict(g.launches),
                 bytes_per_replay=dict(g.launches.nbytes))
            for g in _PLAN_GRAPHS.values()]


class _PlanRun(NamedTuple):
    order: torch.Tensor        # [max_m + 1, 3]
    sal: torch.Tensor          # [max_m + 1]
    sal_exact: Optional[torch.Tensor]
    n_m: int
    steps: int
    bad: bool                  # overflow, or a live edge left
    conv: bool
    last_steps: int            # supersteps of the last phase
    graph: bool                # replayed from a CUDA graph
    eager_steps: int           # supersteps of the eager continuation


def _run_plan(entries, stat_fn, R, dmax, max_supersteps, dtype, with_vsz,
              inputs, last_steps=None, sal_L=None):
    """Run a plan: the plan program, then one batched read of its
    scalars.  On a CUDA device, with the last phase's superstep count
    known (a memoized plan's), the program is a captured CUDA graph
    (captured at the first such call, and again in place of the plan's
    graph when the count has changed); otherwise it runs eagerly, its
    last phase for ``last_steps`` (0 when unknown).  A last phase with a
    live edge after those supersteps goes on eagerly from the program's
    state, up to ``max_supersteps`` (the same supersteps, so the same
    rows); the exact saliencies are then taken again on the finished
    order.  Spans: merge.graph_inputs and merge.graph_launch (a replay),
    merge.scalar_wait (the host waiting for the program's scalars),
    merge.output_clone, merge.eager_tail (the continuation, whose
    supersteps count as merge.eager_supersteps); plan.graph_capture
    counts a new graph."""
    u0, v0, payload0, vstate0 = inputs
    dev = u0.device
    max_m = max(R - 1, 1)
    use_graph = dev.type == "cuda" and last_steps is not None
    K = last_steps or 0
    args = (tuple(entries), stat_fn, R, dmax, max_supersteps, dtype,
            with_vsz, K)
    if use_graph:
        # the packing setting is part of the key, as it is of glia_tpu's
        # program keys: a graph captured packed never replays unpacked
        pack64 = _pack64_enabled()
        key = (args[0], stat_fn, R, dmax, max_supersteps,
               _dtype_name(dtype), with_vsz,
               tuple(tuple(t.shape) for t in _flat(inputs)), sal_L,
               str(dev), pack64)
        g = _PLAN_GRAPHS.get(key)
        if g is not None and g.info["last_steps"] != K:
            # the superseded graph and its memory pool go before the new
            # capture takes a pool
            del _PLAN_GRAPHS[key]
            g = None
        if g is None:
            info = {"E": entries[0][1], "R": R, "phases": len(entries),
                    "last_steps": K, "sal_L": sal_L,
                    "dtype": _dtype_name(dtype), "pack64": pack64}
            profiling.count("plan.graph_capture")
            g = _PLAN_GRAPHS[key] = _PlanGraph(
                lambda *xs: _plan_program(*args, *xs, sal_L=sal_L), inputs,
                info)
        out = g.replay(inputs)
    else:
        out = _plan_program(*args, u0, v0, payload0, vstate0, sal_L=sal_L)
    with profiling.span("merge.scalar_wait"):
        n_m, steps, ovf, any_alive, n_loc, done, conv = out.scalars.tolist()
    order, sal, sal_exact = out.order, out.sal, out.sal_exact
    if use_graph:
        # the graph's outputs belong to its next replay
        with profiling.span("merge.output_clone"):
            order, sal = order.clone(), sal.clone()
            sal_exact = None if sal_exact is None else sal_exact.clone()
    more = 0
    if any_alive and done < max_supersteps:
        with profiling.span("merge.eager_tail"):
            st = _phase_static(stat_fn, entries[-1][1], entries[-1][2], R,
                               dmax, with_vsz)
            base = n_m - n_loc
            u, v, payload, vstate, alive = out.state
            *_, any_alive, n_loc, more = _run_phase(
                st, u, v, payload, vstate, alive, True, order, sal,
                max_supersteps - done, n_m_base=base, g_of=out.g_of,
                n_loc=n_loc)
            n_m, steps, done = base + n_loc, steps + more, done + more
            if sal_L is not None:
                (sc,) = payload0
                ex, conv_t = _exact_saliency_pass(u0, v0, sc[:, 0], sc[:, 1],
                                                  order[:max_m], R, sal_L)
                sal_exact = torch.where(torch.isnan(ex), sal[:max_m], -ex)
                conv = bool(conv_t)
        profiling.count("merge.eager_supersteps", more)
    return _PlanRun(order, sal, sal_exact, n_m, steps,
                    bool(ovf or any_alive), bool(conv), done, use_graph,
                    more)


def _run_phases(stat_fn, R, dmax, max_supersteps, dtype, with_vsz, inputs,
                entries=None, debug=None):
    """The multi-phase merge run eagerly, phase by phase.

    ``entries=None`` is the adaptive first run on a shape: 1-step phases
    while the phase index is below 2, then 2-step phases, a phase being
    the last one once its edge capacity is at most 4096 or it is the
    seventh; after each non-last phase the alive count is read, and the
    next phase's edge capacity is the quantized count, its vertex
    capacity the quantized min(2 * alive, current).  A frontier that does
    not shrink makes the next phase the last, at the same capacities and
    without a transition.  Given ``entries`` (a plan), each phase runs its
    planned supersteps at its capacities, the last to completion.

    ``debug`` (a stats dict, GLIA_MERGE_DEBUG): the device is synchronized
    around each phase and transition, and the lists of DEBUG_KEYS get
    each phase's wall and supersteps and each transition's wall and the
    alive count after it.

    Returns (a _PlanRun whose ``last_steps`` is the last phase's
    supersteps, the realized plan)."""
    u_d, v_d, payload_d, vstate = inputs
    E = u_d.shape[0]
    device = u_d.device
    max_m = max(R - 1, 1)
    alive = torch.ones(E, dtype=torch.bool, device=device)
    any_alive = E > 0
    order, sal = _order_buffers(max_m, dtype, device)
    g_of = torch.arange(R, device=device)
    E_cur, R_cur = E, R
    n_base, total_steps = 0, 0
    ovf_any = torch.zeros((), dtype=torch.bool, device=device)
    realized = []
    force_final = False
    pi = 0
    while True:
        if entries is not None:
            steps = entries[pi][0]
            last = pi == len(entries) - 1
        else:
            last = force_final or E_cur <= 4096 or pi >= 6
            steps = None if last else (1 if pi < 2 else 2)
        st = _phase_static(stat_fn, E_cur, R_cur, R, dmax, with_vsz)
        # fresh locals of this phase map with the base at its start; the
        # following transition composes the id table with the same value.
        # The first phase maps by the identity (a later one without a
        # transition before it maps by the table, as in glia_tpu)
        base_start = n_base
        if debug is not None:
            synchronize(device)
            t = time.perf_counter()
        u_d, v_d, payload_d, vstate, alive, any_alive, n_loc, done = \
            _run_phase(st, u_d, v_d, payload_d, vstate, alive, any_alive,
                       order, sal,
                       max_supersteps if steps is None or last else steps,
                       n_m_base=base_start, g_of=None if pi == 0 else g_of)
        if debug is not None:
            synchronize(device)
            debug.setdefault("phase_s", []).append(
                round(time.perf_counter() - t, 4))
            debug.setdefault("phase_steps", []).append(done)
        n_base = base_start + n_loc
        total_steps += done
        realized.append((None if last else steps, E_cur, R_cur))
        if last:
            break
        if entries is not None:
            E2, R2_cap = entries[pi + 1][1], entries[pi + 1][2]
        else:
            n_alive = int(alive.sum())
            if n_alive == 0:
                realized[-1] = (None, E_cur, R_cur)
                break
            E2 = _cap_quantize(n_alive)
            R2_cap = _cap_quantize(min(2 * n_alive, R_cur), lo=128,
                                   tile=128)
            if E2 >= E_cur:
                # frontier not shrinking: finish at the current capacity
                force_final = True
                pi += 1
                continue
        if debug is not None:
            t = time.perf_counter()
        u_d, v_d, payload_d, vstate, alive, g_of, ovf = _phase_transition(
            u_d, v_d, payload_d, vstate, alive, g_of, base_start, R_cur, R,
            E2, R2_cap)
        ovf_any = ovf_any | ovf
        if debug is not None:
            synchronize(device)
            debug.setdefault("trans_s", []).append(
                round(time.perf_counter() - t, 4))
            debug.setdefault("alive_at_transition", []).append(
                int(alive.sum()))
        E_cur, R_cur = E2, R2_cap
        pi += 1
    bad = bool(ovf_any | alive.any())
    return _PlanRun(order, sal, None, n_base, total_steps, bad, True, done,
                    False, 0), realized


def _fused_multiphase_core(u, v, payload, stat_fn, n_regions,
                           max_supersteps, dtype, device, dmax=4, plan=None,
                           stats=None, vsizes=None):
    """Multi-phase fused merge: full-capacity supersteps first, then
    transitions into smaller edge and vertex capacities for the tail
    (alive counts roughly halve per superstep).  Same selection rule and
    chain emission as the single-phase engine, each phase in its own
    compact id space.

    plan=None is adaptive: the first call on an (E, R, policy) shape
    measures its plan (``_run_phases``), reading the alive count after
    every phase but the last, and memoizes it per shape (with the pooled
    mean's plans, in the plan store when there is one).  Later calls run
    the memoized plan as one program (``_run_plan``; on a CUDA device a
    captured CUDA graph), its last phase for the most supersteps a call
    of the plan has needed (``_keep_last_steps``):
    ``stats["plan_replayed"]``, and ``stats["plan_graph"]`` when it came
    from a graph.  Another graph of the same shape may replay the plan
    too, at the cost of at most one fallback.  An explicit plan is a list
    of (steps, edge_cap, vert_cap), caps as fractions of E / R (<= 1.0)
    or absolute rows, run eagerly; its last entry runs to completion.  A
    capacity overflow or an unfinished frontier falls back to the
    single-phase engine and drops the memo entry (``stats["fallback"]``).

    Under GLIA_MERGE_DEBUG with a ``stats`` dict, its DEBUG_KEYS lists
    are cleared, and every plan, a memoized one too, runs phase by phase
    (``_run_phases``), recording them; the rows are the same.
    """
    E = len(u)
    R = int(n_regions)
    max_m = max(R - 1, 1)
    with_vsz = vsizes is not None
    inputs = _initial_state(u, v, payload, vsizes, R, dtype, device)
    struct = tuple((p.ndim, _dtype_name(p.dtype)) for p in inputs[2])
    memo_key = (E, R, stat_fn, struct, dmax, _dtype_name(dtype), with_vsz)
    debug = _merge_debug(stats)
    if debug:
        # the lists would otherwise run on across the calls of a caller
        # that passes one dict to each
        for k in DEBUG_KEYS:
            stats.pop(k, None)
    st = stats if stats is not None else {}
    discovered = False
    if plan is not None:
        entries = []
        for i, (steps, ef, vf) in enumerate(plan):
            Ei = E if i == 0 else _tile_ceil(E * ef if ef <= 1.0 else ef)
            Ri = R if i == 0 else _tile_ceil(R * vf if vf <= 1.0 else vf,
                                             lo=128, tile=128)
            entries.append((steps, Ei, Ri))
    else:
        _plan_store_load()
        entries = _PLAN_MEMO.get(memo_key)
        discovered = entries is None
        profiling.count("plan.memo_miss" if discovered else "plan.memo_hit")
    if discovered or debug:
        run, realized = _run_phases(stat_fn, R, dmax, max_supersteps, dtype,
                                    with_vsz, inputs, entries=entries,
                                    debug=stats if debug else None)
        entries = entries or realized
    else:
        # an explicit plan runs eagerly (no known last-phase count)
        run = _run_plan(entries, stat_fn, R, dmax, max_supersteps, dtype,
                        with_vsz, inputs,
                        last_steps=None if plan is not None
                        else _PLAN_LAST_STEPS.get(memo_key))
    if run.bad:
        # capacity plan too tight for this RAG: the single-phase engine
        # (slower, never wrong); drop a stale memo so the next call
        # measures again
        _PLAN_MEMO.pop(memo_key, None)
        _PLAN_LAST_STEPS.pop(memo_key, None)
        st["fallback"] = True
        profiling.count("plan.fallback")
        return _fused_merge_core(u, v, payload, stat_fn, n_regions,
                                 max_supersteps, dtype, device, dmax=dmax,
                                 stats=st, vsizes=vsizes)
    if discovered:
        _PLAN_MEMO[memo_key] = entries
        _plan_store_save()
    if plan is None:
        _keep_last_steps(memo_key, run.last_steps)
    st.update(n_supersteps=run.steps, buckets=[e for _, e, _ in entries],
              fallback=False, plan_replayed=plan is None and not discovered,
              plan_graph=run.graph, eager_supersteps=run.eager_steps)
    return run.order[:max_m], run.sal[:max_m], run.n_m


MODES = ("fused", "fused_ms", "chunked")


def _check_mode(mode, modes=MODES):
    if mode not in modes:
        raise ValueError(f"merge mode {mode!r} ({'|'.join(modes)})")


def merge_batched_device(u, v, s, c, n_regions, max_supersteps=256,
                         dtype: Optional[torch.dtype] = None,
                         select_rounds=1, stats=None, mode="fused", dmax=4,
                         device: DeviceLike = None):
    """Batched superstep merge, pooled-mean policy.

    Per-edge data (s, c) = (sum, count) of boundary pb; statistic = s/c
    (util/struct_merge.hxx:38-85 semantics under splice-as-sum).
    ``mode="fused"`` runs depth-``dmax`` chain contraction per superstep
    at full edge capacity; ``"fused_ms"`` adds capacity-shrinking tail
    phases to it (the default of greedy_merge_device); ``"chunked"`` is
    the mutual-matching engine with host-driven compaction
    (``select_rounds`` matching rounds a superstep).
    Returns (order, saliencies, n_merges)."""
    _check_mode(mode)
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    sc = torch.stack([_as_float(s, dev, dt), _as_float(c, dev, dt)], dim=1)
    if mode == "chunked":
        return _superstep_merge_core(u, v, (sc,), _mean_stat_packed,
                                     n_regions, max_supersteps, dt, dev,
                                     select_rounds=select_rounds,
                                     stats=stats)
    core = _fused_multiphase_core if mode == "fused_ms" else _fused_merge_core
    return core(u, v, (sc,), _mean_stat_packed, n_regions, max_supersteps,
                dt, dev, dmax=dmax, stats=stats)


def merge_batched_device_hist(u, v, h, n_regions, max_supersteps=256,
                              lo=0.0, hi=1.0,
                              dtype: Optional[torch.dtype] = None,
                              select_rounds=1, stats=None, mode="fused",
                              dmax=4, device: DeviceLike = None):
    """Batched superstep merge on histogram sketches (approx-median
    policy).  h: [E, n_bins] per-edge boundary histograms, which splice
    additively; the statistic is the sketch's upper median.  ``mode`` as
    in merge_batched_device.
    Returns (order, saliencies=-stat, n_merges)."""
    _check_mode(mode)
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    stat_fn = _hist_stat(lo, hi)
    if mode == "chunked":
        return _superstep_merge_core(u, v, (h,), stat_fn, n_regions,
                                     max_supersteps, dt, dev,
                                     select_rounds=select_rounds,
                                     stats=stats)
    core = _fused_multiphase_core if mode == "fused_ms" else _fused_merge_core
    return core(u, v, (h,), stat_fn, n_regions, max_supersteps, dt, dev,
                dmax=dmax, stats=stats)


def merge_batched_device_hist_minsize(u, v, h, sizes, n_regions,
                                      max_supersteps=256, lo=0.0, hi=1.0,
                                      dtype: Optional[torch.dtype] = None,
                                      stats=None, mode="fused_ms", dmax=4,
                                      device: DeviceLike = None):
    """Batched superstep merge, median * minsize policy
    (util/struct_merge.hxx:141-185): statistic = (approx) boundary median
    from the additive histogram sketch TIMES the smaller endpoint
    region's size -- sizes ride as an additive per-VERTEX payload pooled
    through the component lut each superstep (start-of-superstep values,
    like every other statistic input).  sizes: [R] leaf region sizes.
    ``mode``: "fused_ms" or "fused" (the chunked engine has no vertex
    payload).  Returns (order, saliencies=-stat, n_merges)."""
    if mode not in ("fused", "fused_ms"):
        raise ValueError(f"median_minsize device mode {mode!r} "
                         "(fused|fused_ms)")
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    core = _fused_multiphase_core if mode == "fused_ms" else _fused_merge_core
    return core(u, v, (h,), _minsize_stat(lo, hi), n_regions,
                max_supersteps, dt, dev, dmax=dmax, stats=stats,
                vsizes=sizes)


# ---------------------------------------------------------------------------
# exact merge-time saliencies
# ---------------------------------------------------------------------------

# the last depth capacity L that converged, per (E, M, R, dtype), for the
# life of the process
_EXACT_SAL_L = {}


def _lca_sums(u, v, s, c, order, R, L):
    """The LCA pass at depth capacity ``L`` (see exact_saliency_device):
    per merge node the (s, c) sums of the edges whose endpoints' tree LCA
    it is.  Returns (s_tot [R + M + 1], c_tot [R + M + 1], r2 [M],
    ok_row [M], converged flag as a tensor); slot R + M is the discard."""
    E, M = u.shape[0], order.shape[0]
    dev = u.device
    # table slot n_ids is a dummy: padded order rows (r2 < 0, the fused
    # engine's unfilled buffer tail) scatter there and self-loop
    n_ids = R + M
    vid = torch.arange(n_ids + 1, device=dev)
    ok_row = order[:, 2] >= 0
    r0 = torch.where(ok_row, order[:, 0], n_ids)
    r1 = torch.where(ok_row, order[:, 1], n_ids)
    r2 = torch.where(ok_row, order[:, 2], n_ids)
    parent = vid.clone()
    parent[r0] = r2
    parent[r1] = r2
    # --- doubling: anc[k] = 2^k-th ancestor, depth = steps to root ---
    anc = [parent]
    depth = (parent != vid).long()
    p = parent
    for _ in range(L - 1):
        depth = depth + depth[p]
        p = p[p]
        anc.append(p)
    root = anc[-1]
    converged = (parent[root] == root).all()

    # --- per-edge LCA: lift the deeper endpoint, then descend together ---
    da = depth[u]
    db = depth[v]
    swap = db > da
    a = torch.where(swap, v, u)
    b = torch.where(swap, u, v)
    diff = (da - db).abs()
    for k in range(L - 1, -1, -1):
        lift = ((diff >> k) & 1) > 0
        a = torch.where(lift, anc[k][a], a)
    same = a == b
    for k in range(L - 1, -1, -1):
        ka = anc[k][a]
        kb = anc[k][b]
        go = ~same & (ka != kb)
        a = torch.where(go, ka, a)
        b = torch.where(go, kb, b)
    lca = torch.where(same, a, anc[0][a])
    valid = root[u] == root[v]

    # --- exact pooled (s, c) per merge node = LCA-keyed segment sum; the
    # last of the n_ids + 1 segments is the discard.  A stable sort of the
    # keys keeps index order inside each segment, so the sums add in the
    # same order on every run ---
    seg, by_seg = torch.sort(torch.where(valid, lca, n_ids), stable=True)
    s_tot = segment_sum_auto(torch.where(valid, s, 0.0)[by_seg], seg,
                             n_ids + 1, sorted=True)
    c_tot = segment_sum_auto(torch.where(valid, c, 0.0)[by_seg], seg,
                             n_ids + 1, sorted=True)
    return s_tot, c_tot, r2, ok_row, converged


def _pooled_stat(s_tot, c_tot, r2, ok_row):
    """Pooled mean s / c of each merge row; NaN where its boundary is
    empty or the row is padding."""
    cm = c_tot[r2]
    sm = s_tot[r2]
    return torch.where(ok_row & (cm > 0), sm / torch.clamp(cm, min=1.0),
                       float("nan"))


def _exact_saliency_pass(u, v, s, c, order, R, L):
    """One LCA pass at depth capacity ``L`` (see exact_saliency_device).
    Returns (stat [M], converged flag as a tensor)."""
    s_tot, c_tot, r2, ok_row, converged = _lca_sums(u, v, s, c, order, R, L)
    return _pooled_stat(s_tot, c_tot, r2, ok_row), converged


def exact_saliency_device(u, v, s, c, order, n_regions,
                          dtype: Optional[torch.dtype] = None,
                          device: DeviceLike = None, stats=None):
    """Exact merge-time pooled-mean statistics of a merge order, computed
    on the device (the replacement for the serial host replay,
    ``replay_exact_saliency``).

    The identity: the boundary the serial engine pops at merge m
    (boundary_table.hxx:122-167) is exactly the base edges whose
    endpoints' merge-tree lowest common ancestor is m.  So the exact
    merge-time pooled (s, c) of every merge is one segment sum of
    base-edge payloads keyed by tree LCA; the LCA comes from binary
    lifting (O(E log R) gathers, no serial pass).

    The number of doubling rounds L is a depth capacity, not derived from
    n_ids: fused-engine trees are shallow (depth <= dmax * supersteps), so
    the pass starts from the last L that converged for this shape (8 at
    first, which covers depth 128) and doubles it while some 2^(L-1)-th
    ancestor is not yet a root.

    order: [M, 3] dense-index triples (r0, r1, r2), a tensor or an array;
    rows with r2 < 0 (the fused engine's unfilled buffer tail) are ignored
    and return NaN, so the engine's order buffer can be passed as it is.
    A merge whose popped boundary is empty (non-adjacent pair row) also
    gets NaN, matching the host replay.  Returns stat [M] as a tensor
    (saliency = -stat); ``stats``, when passed, receives ``sal_L``."""
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    order = _as_index(order, dev).reshape(-1, 3)
    M = int(order.shape[0])
    R = int(n_regions)
    if M == 0:
        return torch.zeros(0, dtype=dt, device=dev)
    n_ids = R + M
    L_full = max(1, int(np.ceil(np.log2(max(n_ids, 2)))))
    shape_key = (len(u), M, R, _dtype_name(dt))
    _plan_store_load()
    L = _EXACT_SAL_L.get(shape_key, min(8, L_full))
    u_d = _as_index(u, dev)
    v_d = _as_index(v, dev)
    s_d = _as_float(s, dev, dt)
    c_d = _as_float(c, dev, dt)
    while True:
        stat, converged = _exact_saliency_pass(u_d, v_d, s_d, c_d, order,
                                               R, L)
        if bool(converged) or L >= L_full:
            break
        L = min(2 * L, L_full)
    if _EXACT_SAL_L.get(shape_key) != L:
        _EXACT_SAL_L[shape_key] = L
        _plan_store_save()
    if stats is not None:
        stats["sal_L"] = L
    return stat


def _merge_exact(u, v, s, c, n_regions, mode, dmax, max_supersteps, dt,
                 stats, dev):
    """Pooled-mean merge in ``mode`` and the exact merge-time saliencies
    over its order buffer, both on ``dev``, one after the other; a
    ``stats`` dict receives the engine's counters and the wall seconds of
    the two stages (t_merge_loop, t_exact_saliency: the spans
    merge.merge_loop and merge.exact_saliency)."""
    st = stats if stats is not None else {}
    u_d = _as_index(u, dev)
    v_d = _as_index(v, dev)
    s_d = _as_float(s, dev, dt)
    c_d = _as_float(c, dev, dt)
    with profiling.span("merge.merge_loop") as loop:
        order, sal, n_m = merge_batched_device(
            u_d, v_d, s_d, c_d, n_regions, dmax=dmax,
            max_supersteps=max_supersteps, dtype=dt, stats=stats, mode=mode,
            device=dev)
        synchronize(dev)
    with profiling.span("merge.exact_saliency") as exact:
        ex = exact_saliency_device(u_d, v_d, s_d, c_d, order, n_regions,
                                   dtype=dt, device=dev, stats=st)
        sal = torch.where(torch.isnan(ex), sal, -ex)
        synchronize(dev)
    st["t_merge_loop"] = loop.seconds
    st["t_exact_saliency"] = exact.seconds
    return order, sal, n_m


def merge_batched_device_exact(u, v, s, c, n_regions, dmax=4,
                               max_supersteps=256,
                               dtype: Optional[torch.dtype] = None,
                               stats=None, device: DeviceLike = None):
    """Pooled-mean multi-phase merge (mode="fused_ms") and the exact
    merge-time saliencies, both on the device with the order never leaving
    it.

    The first call on a shape discovers: the merge (measuring its plan),
    then the LCA-keyed segment sums over its order buffer (measuring their
    depth capacity), then the exact value wherever it is defined.  Once
    the plan and the depth capacity are both known (in this process, or
    from the plan store), a call runs merge and saliencies as one program
    (``_plan_program``; on a CUDA device a captured CUDA graph) with one
    read of its scalars.  If that run overflows its plan or its depth
    capacity does not converge, both memos are dropped and the call
    discovers again.

    Returns (order [max_m, 3] dense triples, saliencies with exact
    merge-time pooled means where defined, n_merges).  ``stats``, when
    passed, receives the engine's counters (n_supersteps, buckets,
    fallback, plan_replayed, plan_graph, sal_L, eager_supersteps) and wall
    seconds: on the discovery path those of the two stages (t_merge_loop,
    t_exact_saliency), on the one-program path the call's
    (t_plan_program), where the two stages are not apart.

    Each call is the span merge.exact; on the one-program path it holds
    merge.stage_inputs and ``_run_plan``'s spans, and counts
    plan.memo_hit (plan.memo_miss and merge.discovery otherwise,
    plan.fallback where the plan failed)."""
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    st = stats if stats is not None else {}
    with profiling.span("merge.exact") as call:
        out, one_program = _merge_exact_call(u, v, s, c, n_regions, dmax,
                                             max_supersteps, dt, stats, dev)
    if one_program:
        st["t_plan_program"] = call.seconds
    return out


def _merge_exact_call(u, v, s, c, n_regions, dmax, max_supersteps, dt, stats,
                      dev):
    """merge_batched_device_exact's body: ((order, saliencies, n_merges),
    whether the one program ran)."""
    st = stats if stats is not None else {}
    E = len(u)
    R = int(n_regions)
    max_m = max(R - 1, 1)
    name = _dtype_name(dt)
    memo_key = (E, R, _mean_stat_packed, ((2, name),), dmax, name, False)
    sal_key = (E, max_m, R, name)
    _plan_store_load()
    plan = _PLAN_MEMO.get(memo_key)
    L = _EXACT_SAL_L.get(sal_key)
    if plan is None or L is None:
        # the multi-phase engine counts its own plan lookup
        with profiling.span("merge.discovery"):
            return _merge_exact(u, v, s, c, R, "fused_ms", dmax,
                                max_supersteps, dt, stats, dev), False
    profiling.count("plan.memo_hit")
    with profiling.span("merge.stage_inputs"):
        sc = torch.stack([_as_float(s, dev, dt), _as_float(c, dev, dt)],
                         dim=1)
        inputs = (_as_index(u, dev), _as_index(v, dev), (sc,), ())
    run = _run_plan(plan, _mean_stat_packed, R, dmax, max_supersteps, dt,
                    False, inputs, last_steps=_PLAN_LAST_STEPS.get(memo_key),
                    sal_L=L)
    if run.bad or not run.conv:
        # the plan overflowed or the depth capacity is too small for this
        # data: drop both memos and discover
        _PLAN_MEMO.pop(memo_key, None)
        _PLAN_LAST_STEPS.pop(memo_key, None)
        _EXACT_SAL_L.pop(sal_key, None)
        st["fallback"] = True
        profiling.count("plan.fallback")
        return merge_batched_device_exact(
            u, v, s, c, n_regions, dmax=dmax, max_supersteps=max_supersteps,
            dtype=dt, stats=stats, device=dev), False
    _keep_last_steps(memo_key, run.last_steps)
    st.update(n_supersteps=run.steps, buckets=[e for _, e, _ in plan],
              fallback=False, plan_replayed=True, plan_graph=run.graph,
              sal_L=L, eager_supersteps=run.eager_steps)
    return (run.order[:max_m], run.sal_exact, run.n_m), True


# ---------------------------------------------------------------------------
# host side: threshold cuts and serial replays of an order
# ---------------------------------------------------------------------------

def threshold_cut(order, stats, tau):
    """Consistent threshold cut of a (possibly non-monotone) merge
    hierarchy: select merge m iff its *monotonized* statistic
    max(stat[m], stats of the merges that built its inputs) <= tau.

    The batched superstep engine emits merges grouped by rounds, so its
    sequence is not sorted by statistic; cutting by count mixes weak and
    strong boundaries.  The monotonized-threshold cut is the correct way
    to extract "merge everything weaker than tau" from any merge
    hierarchy (equals the prefix cut for a serial sorted order).
    Returns a boolean mask over merges (prefix-closed by construction).

    The monotonized statistic is the max over each merge's subtree of
    merge rows, found by pointer jumping: O(n log depth) whatever the
    chain length."""
    order = np.asarray(order).reshape(-1, 3)
    stats = np.asarray(stats, dtype=np.float64)
    n = len(order)
    if n == 0:
        return np.zeros(0, dtype=bool)
    hi = int(max(order[:, 2].max(), order[:, :2].max())) + 2
    lut = np.full(hi, -1, dtype=np.int64)
    lut[order[:, 2]] = np.arange(n)
    c0 = lut[order[:, 0]]
    c1 = lut[order[:, 1]]
    # parent[j] = row that consumed r2_j; max is idempotent, so
    # scatter-max along 2^k links covers every descendant
    rows = np.arange(n, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    parent[c0[c0 >= 0]] = rows[c0 >= 0]
    parent[c1[c1 >= 0]] = rows[c1 >= 0]
    mono = stats.copy()
    par = parent
    while (par >= 0).any():
        valid = par >= 0
        np.maximum.at(mono, par[valid], mono[valid])
        par = np.where(valid, np.take(par, np.maximum(par, 0)), -1)
    return mono <= tau


def _splice_neighbors(tbl, nbrs, a, b, r2, splice):
    """Move the boundary entries of the merged regions a and b (their
    own pair already popped) to the new region r2: ``splice(dst, src)``
    folds an entry into one that r2 already has with the same neighbour."""
    na = nbrs.pop(a, set())
    nb = nbrs.pop(b, set())
    na.discard(b)
    nb.discard(a)
    merged = set()
    for src, rest in ((a, na), (b, nb)):
        for x in rest:
            ee = tbl.pop((src, x) if src < x else (x, src))
            k2 = (r2, x) if r2 < x else (x, r2)
            if k2 in tbl:
                splice(tbl[k2], ee)
            else:
                tbl[k2] = ee
            nx = nbrs[x]
            nx.discard(a)
            nx.discard(b)
            nx.add(r2)
            merged.add(x)
    nbrs[r2] = merged


def _sum_into(dst, src):
    dst[0] += src[0]
    dst[1] += src[1]


def replay_exact_saliency(u, v, s, c, order, engine="native"):
    """Serial host replay of a merge order recomputing each merge's EXACT
    pooled-mean boundary statistic at merge time.

    The batched superstep engine records each attach's start-of-superstep
    statistic, which goes stale once earlier merges in the same superstep
    re-pool the boundary (the reference's serial engine re-pools after
    EVERY pop, boundary_table.hxx:122-167).  Replaying the emitted order
    through a host boundary table restores the serial quantity.

    order rows are dense-index triples (r0, r1, r2).  Returns stat [n]
    (pooled mean of each merge's boundary at merge time; saliency =
    -stat), NaN for a non-adjacent pair.  engine="native" (default) runs
    the C++ replay, engine="py" the Python oracle (tests assert they
    agree)."""
    s = np.asarray(s, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    order_a = np.asarray(order, dtype=np.int64).reshape(-1, 3)
    if engine == "native":
        from ..native import replay_saliency_native

        hi = int(max(np.max(order_a, initial=0),
                     np.max(u, initial=0), np.max(v, initial=0))) + 1
        return replay_saliency_native(u, v, s, c, order_a, hi)
    if engine != "py":
        raise ValueError(f"replay engine {engine!r} (native|py)")
    tbl = {}
    nbrs = {}
    for ui, vi, si, ci in zip(np.asarray(u).tolist(),
                              np.asarray(v).tolist(),
                              s.tolist(), c.tolist()):
        a, b = (ui, vi) if ui < vi else (vi, ui)
        if (a, b) in tbl:
            _sum_into(tbl[(a, b)], (si, ci))
        else:
            tbl[(a, b)] = [si, ci]
            nbrs.setdefault(a, set()).add(b)
            nbrs.setdefault(b, set()).add(a)
    out = np.full(len(order_a), np.nan)
    for i, (a, b, r2) in enumerate(order_a.tolist()):
        e = tbl.pop((a, b) if a < b else (b, a), None)
        if e is None:
            continue  # non-adjacent pair: keep NaN, caller decides
        out[i] = e[0] / max(e[1], 1.0)
        _splice_neighbors(tbl, nbrs, a, b, r2, _sum_into)
    return out


def replay_exact_saliency_median(u, v, edge_ptr, edge_vals, order,
                                 engine="native", region_sizes=None):
    """Serial host replay of a merge order recomputing each merge's EXACT
    upper-median boundary statistic at merge time (policy-0 counterpart
    of replay_exact_saliency; util/stats.hxx:83-91 amedian under the
    boundary_table splice).  Medians are not additive, so the replay
    carries full per-pair value multisets.  With ``region_sizes`` (leaf
    sizes by dense region id) the statistic is median * min(size), the
    median_minsize policy.  engine="native" (default) runs the C++
    engine, "py" the dict oracle (tests assert they agree).  Returns
    stat [n] (saliency = -stat)."""
    order_a = np.asarray(order, dtype=np.int64).reshape(-1, 3)
    hi = int(max(order_a.max(initial=0), np.max(u, initial=0),
                 np.max(v, initial=0))) + 1
    if engine == "native":
        from ..native import replay_saliency_median_native

        return replay_saliency_median_native(u, v, edge_ptr, edge_vals,
                                             order_a, hi,
                                             region_sizes=region_sizes)
    if engine != "py":
        raise ValueError(f"replay engine {engine!r} (native|py)")
    sizes = None
    if region_sizes is not None:
        sizes = np.zeros(hi, dtype=np.int64)
        sizes[: len(region_sizes)] = np.asarray(region_sizes,
                                                dtype=np.int64)
    edge_ptr = np.asarray(edge_ptr)
    edge_vals = np.asarray(edge_vals, dtype=np.float64)
    tbl = {}
    nbrs = {}
    for e, (ui, vi) in enumerate(zip(np.asarray(u).tolist(),
                                     np.asarray(v).tolist())):
        a, b = (ui, vi) if ui < vi else (vi, ui)
        vals = edge_vals[int(edge_ptr[e]):int(edge_ptr[e + 1])].tolist()
        if (a, b) in tbl:
            tbl[(a, b)].extend(vals)
        else:
            tbl[(a, b)] = list(vals)
            nbrs.setdefault(a, set()).add(b)
            nbrs.setdefault(b, set()).add(a)
    out = np.full(len(order_a), np.nan)
    for i, (a, b, r2) in enumerate(order_a.tolist()):
        if sizes is not None:
            sizes[r2] = sizes[a] + sizes[b]
        vals = tbl.pop((a, b) if a < b else (b, a), None)
        if vals is None:
            continue
        arr = np.asarray(vals)
        out[i] = float(np.partition(arr, len(arr) // 2)[len(arr) // 2])
        if sizes is not None:
            out[i] *= float(min(sizes[a], sizes[b]))
        _splice_neighbors(tbl, nbrs, a, b, r2, list.extend)
    return out


# ---------------------------------------------------------------------------
# user surface
# ---------------------------------------------------------------------------

def order_to_keys(order, n_merges, rag):
    """Convert dense-index order rows to the RAG's label key space: a
    leaf index becomes its label, merge id R + i the key max_key + 1 + i;
    each row's two inputs are sorted (the host engine records sorted
    table keys, boundary_table.hxx)."""
    if torch.is_tensor(order):
        order = order.cpu().numpy()
    order = np.asarray(order)[:n_merges].astype(np.int64)
    R = rag.n_regions
    max_key = int(rag.keys.max()) if R else 0
    keys = np.asarray(rag.keys, dtype=np.int64)
    out = np.where(order < R, keys[np.minimum(order, R - 1)],
                   max_key + 1 + (order - R))
    out[:, :2] = np.sort(out[:, :2], axis=1)
    return out


def greedy_merge_device(rag, pb_image, policy="mean", n_bins=32,
                        mode="fused_ms", dmax=4, stats=None,
                        exact_saliency=True, saliency_engine="device",
                        device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None):
    """User-surface device merge: the (order_keys, saliencies) contract of
    the serial host engine, run as batched supersteps on the device (the
    counterpart of the reference's serial ``genMergeOrderGreedy``,
    util/struct_merge.hxx:13-33).

    policy: "mean" (pooled boundary mean, struct_merge.hxx:38-85),
    "median" (approx-median over an additive n_bins histogram sketch,
    struct_merge.hxx:90-136 semantics to bin resolution), or
    "median_minsize" (median * smaller endpoint region size,
    struct_merge.hxx:141-185; sizes pooled as an additive vertex
    payload) -- all three of the reference's saliency policies.

    mode: "fused_ms" (default; the multi-phase fused engine, falling back
    to the single-phase one by itself when the RAG overflows its capacity
    plan), "fused" or "chunked" (not for median_minsize).

    exact_saliency (default True): replace the engine's
    start-of-superstep saliencies with the exact merge-time statistics,
    the serial-engine quantity.  For policy "mean", saliency_engine
    selects how: "device" (default) runs the LCA-keyed segment sums on
    the device (exact_saliency_device); "native"/"py" run the serial host
    replay (replay_exact_saliency).  The median policies always replay on
    the host (medians are not additive).

    ``device`` defaults to the CUDA card and raises without one.  A
    ``stats`` dict receives the engine's counters (n_supersteps, buckets;
    fallback, plan_replayed and plan_graph for "fused_ms") and the wall
    seconds of the stages (t_merge_loop, t_exact_saliency), but for the
    mean with device saliencies in "fused_ms" once its plan is known:
    merge and saliencies are then one program (merge_batched_device_exact),
    timed as t_plan_program.
    Returns (order [n, 3] int64 label keys, saliencies [n] float64)."""
    _check_mode(mode)
    dev = resolve_device(device)
    dt = default_dtype(dev, dtype)
    st = stats if stats is not None else {}
    # the engines get the caller's dict (or None): GLIA_MERGE_DEBUG acts on
    # a call given one
    kw = dict(mode=mode, dmax=dmax, stats=stats, device=dev, dtype=dt)

    def timed_merge(fn, *args):
        with profiling.span("merge.merge_loop") as sp:
            order, sal, n_m = fn(*args, rag.n_regions, **kw)
            order = order[:n_m].cpu().numpy()
            sal = sal[:n_m].double().cpu().numpy()
        st["t_merge_loop"] = sp.seconds
        return order, sal, n_m

    def with_replay(sal, replay, *args, **kwargs):
        with profiling.span("merge.exact_saliency") as sp:
            ex = replay(*args, **kwargs)
        st["t_exact_saliency"] = sp.seconds
        return np.where(np.isnan(ex), sal, -ex)

    if policy == "mean":
        u, v, s, c = edge_mean_arrays(rag, pb_image)
        if exact_saliency and saliency_engine == "device":
            if mode == "fused_ms":
                order, sal, n_m = merge_batched_device_exact(
                    u, v, s, c, rag.n_regions, dmax=dmax, dtype=dt,
                    stats=stats, device=dev)
            else:
                order, sal, n_m = _merge_exact(u, v, s, c, rag.n_regions,
                                               mode, dmax, 256, dt, stats,
                                               dev)
            sal = sal[:n_m].double().cpu().numpy()
            return order_to_keys(order, n_m, rag), sal
        order, sal, n_m = timed_merge(merge_batched_device, u, v, s, c)
        if exact_saliency:
            sal = with_replay(sal, replay_exact_saliency, u, v, s, c, order,
                              engine=saliency_engine)
    elif policy in ("median", "median_minsize"):
        sizes = None
        if policy == "median_minsize":
            if rag.sizes is None:
                raise ValueError("median_minsize needs region sizes; build "
                                 "the RAG with contour_only=False")
            sizes = rag.sizes
        u, v, h = edge_hist_arrays(rag, pb_image, n_bins=n_bins)
        if sizes is None:
            order, sal, n_m = timed_merge(merge_batched_device_hist, u, v, h)
        else:
            order, sal, n_m = timed_merge(merge_batched_device_hist_minsize,
                                          u, v, h, sizes)
        if exact_saliency:
            # exact upper medians at merge time: a host replay, since
            # medians are not additive and have no segment-sum form
            pb = np.asarray(pb_image, dtype=np.float64).ravel()
            sal = with_replay(sal, replay_exact_saliency_median, u, v,
                              rag.edge_ptr, pb[rag.edge_pixels], order,
                              region_sizes=sizes)
    else:
        raise ValueError(
            f"device policy {policy!r} (mean|median|median_minsize)")
    return order_to_keys(order, n_m, rag), sal
