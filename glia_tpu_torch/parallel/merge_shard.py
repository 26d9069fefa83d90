"""Edge-partitioned merge-tree construction across the ranks of a mesh
(counterpart of glia_tpu.parallel.merge_shard).

The batched superstep greedy merge (graph/merge_device.py, mode="fused")
sharded over ranks, with owner arbitration at superstep barriers:

  - every (lo, hi) pair lives on exactly one rank, its hash owner
    (``pair_owner``), holding its pooled (s, c) payload.  Vertex state is
    O(R) and kept replicated through all-reduced minima each superstep.
  - per superstep each rank scatter-mins its edges into the per-vertex
    tables (minimum statistic bits; winner global edge id; the winner's
    partner and statistic), and four ``pmin`` all-reduces make them
    global, so every rank knows each region's globally minimal incident
    edge: the single-process engine's selection, ties broken by the
    global edge id.
  - chain contraction (depth-dmax attach, hop-ordered emission, component
    luts) runs replicated from the vertex tables: every rank emits the
    same (r0, r1, r2) rows, so the order needs no gather.
  - after relabeling, only surviving edges touched by the superstep's
    merges (an endpoint relabeled, so the pair and its owner may change)
    go to their new owner through one padded ``all_to_all``; the owner
    dedupes the incoming rows by a sort and a segment sum (kernel B2's
    sorted entry on the card) and appends them into freed slots.

glia_tpu runs the supersteps in one ``lax.while_loop``; here a Python
loop on every rank reads the all-reduced ``go`` count, so the ranks leave
the loop together.  A rank's route buffer that overflows sets a flag
that is all-reduced with MAX at the end, so every rank retries together
with a doubled ``route_cap``.  (glia_tpu returns its flag through
``out_specs=P()`` with ``check_vma=False``, which reads one shard's
value.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import default_dtype
from ..graph.merge_device import (BIG32, _contract_chains, _first_of_runs,
                                  _lca_sums, _mean_stat_packed, _pooled_stat,
                                  _scatter_min_, _stat_bits)
from ..ops.segment_csr import segment_sum_auto
from .mesh import Mesh

_HASH_A = 2654435761
_HASH_B = 0x85EBCA6B
_MASK32 = 0xFFFFFFFF


def pair_owner_np(lo, hi, n_shards):
    """Host-side pair -> owner hash (``pair_owner`` on tensors)."""
    lo = np.asarray(lo, dtype=np.uint32)
    hi = np.asarray(hi, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = (lo * np.uint32(_HASH_A)) ^ (hi * np.uint32(_HASH_B))
        h = h ^ (h >> np.uint32(15))
    return (h % np.uint32(n_shards)).astype(np.int32)


def pair_owner(lo: torch.Tensor, hi: torch.Tensor, n_shards: int):
    """The uint32 hash of ``pair_owner_np`` in int64 arithmetic masked to
    32 bits (ids are below 2**31, so every product fits in int64)."""
    h = ((lo * _HASH_A) & _MASK32) ^ ((hi * _HASH_B) & _MASK32)
    h = h ^ (h >> 15)
    return h % n_shards


def shard_merge_inputs(u, v, payload, n_shards, headroom=2.0, min_cap=256):
    """Host-side initial distribution: each pair to its hash owner,
    padded to a common per-shard capacity C (power of two).

    payload: [E, W] additive sketch rows.  Returns flat [n_shards*C]
    (u, v, gid, payload, alive) arrays plus C."""
    u = np.asarray(u, dtype=np.int32)
    v = np.asarray(v, dtype=np.int32)
    payload = np.asarray(payload)
    E = len(u)
    W = payload.shape[1]
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    dest = pair_owner_np(lo, hi, n_shards)
    counts = np.bincount(dest, minlength=n_shards)
    C = max(min_cap,
            1 << int(np.ceil(np.log2(max(counts.max() * headroom, 1)))))
    uf = np.zeros(n_shards * C, dtype=np.int32)
    vf = np.zeros(n_shards * C, dtype=np.int32)
    gf = np.full(n_shards * C, BIG32, dtype=np.int32)
    pf = np.zeros((n_shards * C, W), dtype=payload.dtype)
    af = np.zeros(n_shards * C, dtype=bool)
    gid = np.arange(E, dtype=np.int32)
    for d in range(n_shards):
        m = dest == d
        n = int(m.sum())
        s = d * C
        uf[s:s + n] = u[m]
        vf[s:s + n] = v[m]
        gf[s:s + n] = gid[m]
        pf[s:s + n] = payload[m]
        af[s:s + n] = True
    return uf, vf, gf, pf, af, C


class _Run:
    """Sizes of one sharded merge (fixed over its supersteps)."""

    def __init__(self, mesh: Mesh, C, R, W, dmax, Ct):
        self.mesh, self.C, self.R, self.W = mesh, C, R, W
        self.dmax, self.Ct = int(dmax), Ct
        self.max_m = max(R - 1, 1)
        self.n_ids = R + self.max_m
        # hop and root pack into one integer, and the emission sort's keys
        # into one int64, while (dmax + 2) * (n_ids + 1) < 2**31
        self.pack_hr = (self.dmax + 2) * (self.n_ids + 1) < 2 ** 31


def _pmin_int(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """pmin of an int64 table whose values fit in int32, sent as int32."""
    return mesh.pmin(x.to(torch.int32)).long()


def _superstep(rs: _Run, n_m: int, u, v, gid, payload, alive, order, sal,
               counters):
    """One superstep on one rank; ``order`` / ``sal`` (replicated, with a
    dump row at max_m) are updated in place.  Returns the rank's new edge
    state, the number of merges recorded and the all-reduced count of
    live edges (tensors)."""
    mesh, C, R, dmax, Ct = rs.mesh, rs.C, rs.R, rs.dmax, rs.Ct
    max_m, n_ids, D, me = rs.max_m, rs.n_ids, mesh.world, mesh.rank
    dev = u.device
    vid = torch.arange(n_ids, device=dev)
    big = torch.full((), BIG32, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=payload.dtype, device=dev)

    stat = torch.where(alive, _mean_stat_packed((payload,)), inf)
    bits = _stat_bits(stat, alive)

    # --- global per-vertex minimum incident edge (4 all-reduces) ---
    rb = torch.full((n_ids,), BIG32, dtype=torch.int64, device=dev)
    _scatter_min_(rb, u, bits)
    _scatter_min_(rb, v, bits)
    rb = _pmin_int(mesh, rb)
    at_u = alive & (rb[u] == bits)
    at_v = alive & (rb[v] == bits)
    rg = torch.full((n_ids,), BIG32, dtype=torch.int64, device=dev)
    _scatter_min_(rg, u, torch.where(at_u, gid, big))
    _scatter_min_(rg, v, torch.where(at_v, gid, big))
    rg = _pmin_int(mesh, rg)
    win_u = at_u & (rg[u] == gid)
    win_v = at_v & (rg[v] == gid)
    pn = torch.full((n_ids,), n_ids, dtype=torch.int64, device=dev)
    _scatter_min_(pn, u, torch.where(win_u, v, n_ids))
    _scatter_min_(pn, v, torch.where(win_v, u, n_ids))
    pn = _pmin_int(mesh, pn)
    ws = torch.full((n_ids,), float("inf"), dtype=payload.dtype, device=dev)
    _scatter_min_(ws, u, torch.where(win_u, stat, inf))
    _scatter_min_(ws, v, torch.where(win_v, stat, inf))
    ws = mesh.pmin(ws)

    has = rg < BIG32
    # chain contraction (replicated: every rank has the same tables)
    vs, rt_s, grank, first_in_run, ok, lut = _contract_chains(
        torch.where(has, pn, vid), has, rb, dmax, rs.pack_hr, max_m - n_m,
        R + n_m)
    r2 = R + n_m + grank
    r0 = torch.where(first_in_run, rt_s, r2 - 1)
    n_new = ok.sum()

    slot = torch.where(ok, n_m + grank, max_m)
    order[slot] = torch.where(ok[:, None], torch.stack([r0, vs, r2], 1), -1)
    sal[slot] = torch.where(ok, -ws[vs], 0.0)

    # --- consume winner edges of recorded attaches; relabel ---
    rec = torch.zeros(n_ids + 1, dtype=torch.bool, device=dev)
    rec[torch.where(ok, vs, n_ids)] = ok
    used = (rec[u] & (rg[u] == gid)) | (rec[v] & (rg[v] == gid))
    u2 = lut[u]
    v2 = lut[v]
    alive2 = alive & ~used & (u2 != v2)

    # --- owner routing: only touched edges cross the wire; a touched
    # pair holds a fresh id, so it can collide only with incoming rows ---
    touched = alive2 & ((u2 != u) | (v2 != v))
    resident = alive2 & ~touched
    dest = torch.where(touched, pair_owner(torch.minimum(u2, v2),
                                           torch.maximum(u2, v2), D), me)
    ints = torch.stack([u2, v2, gid, touched.long()], dim=1)
    send_i = torch.zeros((D * (Ct + 1), 4), dtype=torch.int64, device=dev)
    send_p = payload.new_zeros((D * (Ct + 1), rs.W))
    overflow = counters["overflow"]
    for d in range(D):
        m_d = touched & (dest == d)
        rank = torch.cumsum(m_d.long(), 0) - 1
        sl = d * (Ct + 1) + torch.where(m_d, torch.clamp(rank, max=Ct - 1),
                                        Ct)
        send_i[sl] = torch.where(m_d[:, None], ints, 0)
        send_p[sl] = torch.where(m_d[:, None], payload, 0.0)
        overflow = overflow | (torch.where(m_d, rank, 0).max() >= Ct)
    counters["routed"] += touched.sum()
    counters["moved"] += (touched & (dest != me)).sum()
    keep_rows = (torch.arange(D * (Ct + 1), device=dev) % (Ct + 1)) < Ct
    recv_i = mesh.all_to_all(
        send_i[keep_rows].reshape(D, Ct, 4).to(torch.int32)).long()
    recv_p = mesh.all_to_all(send_p[keep_rows].reshape(D, Ct, rs.W))
    u_r = recv_i[:, :, 0].reshape(-1)
    v_r = recv_i[:, :, 1].reshape(-1)
    g_r = recv_i[:, :, 2].reshape(-1)
    ok_r = recv_i[:, :, 3].reshape(-1) > 0
    p_r = recv_p.reshape(D * Ct, rs.W)

    # --- owner-side dedupe among the incoming rows: sort by (lo, hi, gid,
    # arrival) with two stable sorts, then one sorted segment sum ---
    lo_r = torch.where(ok_r, torch.minimum(u_r, v_r), n_ids)
    hi_r = torch.where(ok_r, torch.maximum(u_r, v_r), n_ids)
    g_k = torch.where(ok_r, g_r, big)
    perm = torch.sort(g_k, stable=True).indices
    perm = perm[torch.sort((lo_r * (n_ids + 1) + hi_r)[perm],
                           stable=True).indices]
    lo_s, hi_s, g_s = lo_r[perm], hi_r[perm], g_k[perm]
    ok_s = ok_r[perm]
    pf = _first_of_runs(lo_s, hi_s)
    seg_id = torch.cumsum(pf.long(), 0) - 1
    pseg = segment_sum_auto(torch.where(ok_s[:, None], p_r[perm], 0.0),
                            seg_id, D * Ct, sorted=True)
    keep = pf & ok_s
    n_keep = keep.sum()

    # --- append the deduped incoming rows into free slots ---
    free = ~resident
    overflow = overflow | (n_keep > free.sum())
    counters["overflow"] = overflow
    cidx = torch.arange(C, device=dev)
    free_rank = torch.cumsum(free.long(), 0) - 1
    slot_of_rank = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free, torch.clamp(free_rank, max=C - 1), C)] = \
        torch.where(free, cidx, 0)
    in_rank = torch.cumsum(keep.long(), 0) - 1
    ksl = torch.where(keep, slot_of_rank[torch.clamp(in_rank, 0, C - 1)], C)

    def place(resident_vals, fill, incoming):
        out = torch.cat([resident_vals, resident_vals[:1]])
        out[ksl] = torch.where(
            keep if incoming.ndim == 1 else keep[:, None], incoming, fill)
        return out[:C]

    ub = place(torch.where(resident, u, 0), 0, u_r[perm])
    vb = place(torch.where(resident, v, 0), 0, v_r[perm])
    gb = place(torch.where(resident, gid, big), BIG32, g_s)
    ab = place(resident, False, keep)
    pb = place(torch.where(resident[:, None], payload, 0.0), 0.0,
               pseg[seg_id])
    go = mesh.psum(n_keep + resident.sum())
    return ub, vb, gb, pb, ab, n_new, go


def _run_sharded(rs: _Run, uf, vf, gf, pf, af, max_supersteps, dtype):
    """The whole merge on one rank.  Returns (order, sal, n_m, supersteps,
    routed, moved, overflow) with the counters summed over the ranks."""
    mesh = rs.mesh
    dev = mesh.device
    blk = lambda a: mesh.shard(torch.from_numpy(a)).to(dev)  # noqa: E731
    u, v, gid = blk(uf).long(), blk(vf).long(), blk(gf).long()
    payload, alive = blk(pf).to(dtype), blk(af)
    order = torch.full((rs.max_m + 1, 3), -1, dtype=torch.int64, device=dev)
    sal = torch.zeros(rs.max_m + 1, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    counters = {"routed": zero.clone(), "moved": zero.clone(),
                "overflow": torch.zeros((), dtype=torch.bool, device=dev)}
    n_m, steps, go = 0, 0, 1
    while steps < max_supersteps and go > 0 and n_m < rs.max_m:
        u, v, gid, payload, alive, n_new, go_t = _superstep(
            rs, n_m, u, v, gid, payload, alive, order, sal, counters)
        steps += 1
        # one host read a superstep; ``go`` is the same on every rank
        n_new_h, go = torch.stack([n_new, go_t.to(n_new.device)]).tolist()
        n_m += n_new_h
    routed = int(mesh.psum(counters["routed"]))
    moved = int(mesh.psum(counters["moved"]))
    overflow = bool(mesh.pmax(counters["overflow"]))
    return order[:rs.max_m], sal[:rs.max_m], n_m, steps, routed, moved, \
        overflow


def merge_batched_sharded(u, v, s, c, n_regions, mesh: Mesh, dmax=4,
                          max_supersteps=64,
                          dtype: Optional[torch.dtype] = None, stats=None,
                          headroom=2.0, route_cap=None):
    """Pooled-mean batched merge, edge-partitioned across ``mesh``; every
    rank calls it with the same full host arrays.

    Same contract as graph.merge_device.merge_batched_device: per-edge
    (s, c) = (sum, count) of boundary pb, statistic = s/c; returns (order
    [max_m, 3] int64 dense-index triples, saliencies, n_merges), the
    tensors on the mesh's device and the same on every rank.  ``dtype``:
    the payload's float type (float32 on the card, float64 on the CPU by
    default).

    route_cap: per-destination all_to_all row capacity for touched edges
    (default max(256, C // 32)); an overflow on any rank is detected and
    every rank retries with doubled capacity (the result never depends on
    it, only the padded wire size).

    ``stats`` (optional dict) receives glia_tpu's keys: n_supersteps,
    capacity C, route_cap, routed_rows (edges through the owner
    all_to_all, total), moved_rows (those that changed rank),
    allreduce_bytes (glia_tpu's count: 4 tables of n_ids 4-byte values a
    superstep), a2a_padded_rows / a2a_wire_bytes (the padded buffer the
    wire moves, 4 int32 and 2 payload values a row); and the port's
    host_staged_bytes (bytes copied between the card and the host for the
    gloo backend) and retries.  Raises RuntimeError if a rank's capacity
    overflowed at route_cap = C (increase ``headroom``)."""
    dt = default_dtype(mesh.device, dtype)
    D = mesh.world
    R = int(n_regions)
    sc = np.stack([np.asarray(s, np.float64), np.asarray(c, np.float64)],
                  axis=1)
    uf, vf, gf, pf, af, C = shard_merge_inputs(u, v, sc, D,
                                               headroom=headroom)
    Ct = route_cap if route_cap is not None else max(256, C // 32)
    staged0 = mesh.stats["host_staged_bytes"]
    retries = 0
    while True:
        rs = _Run(mesh, C, R, 2, dmax, Ct)
        order, sal, n_m, steps, routed, moved, overflow = _run_sharded(
            rs, uf, vf, gf, pf, af, max_supersteps, dt)
        if not overflow:
            break
        if Ct >= C:
            raise RuntimeError(
                f"sharded merge capacity overflow (C={C}, Ct={Ct}, "
                f"D={D}); rerun with larger headroom")
        Ct = min(2 * Ct, C)
        retries += 1
    if stats is not None:
        n_ids = R + max(R - 1, 1)
        row_bytes = 4 * 4 + 2 * torch.empty((), dtype=dt).element_size()
        stats["n_supersteps"] = steps
        stats["capacity"] = C
        stats["route_cap"] = Ct
        stats["routed_rows"] = routed
        stats["moved_rows"] = moved
        stats["allreduce_bytes"] = steps * 4 * n_ids * 4
        stats["a2a_padded_rows"] = steps * D * Ct
        stats["a2a_wire_bytes"] = steps * D * Ct * row_bytes
        stats["host_staged_bytes"] = (mesh.stats["host_staged_bytes"]
                                      - staged0)
        stats["retries"] = retries
    return order, sal, n_m


def exact_saliency_sharded(u, v, s, c, order, n_regions, mesh: Mesh,
                           dtype: Optional[torch.dtype] = None):
    """Exact merge-time pooled means of a merge order, edge-partitioned
    over the mesh (graph.merge_device.exact_saliency_device's LCA
    identity): each rank finds its edges' tree LCAs from the replicated
    order, sums its (s, c) by LCA (kernel B2's sorted entry on the card),
    and one psum pair makes the per-merge sums global.  order: [M, 3]
    dense-index triples.  Returns stat [M] as a numpy array, NaN where
    the popped boundary is empty."""
    dt = default_dtype(mesh.device, dtype)
    dev = mesh.device
    order = torch.as_tensor(np.asarray(order, dtype=np.int64).reshape(-1, 3),
                            device=dev)
    M = int(order.shape[0])
    R = int(n_regions)
    if M == 0:
        return np.zeros(0)
    D = mesh.world
    E = len(u)
    E_pad = ((E + D - 1) // D) * D

    def block(a, dtype):
        full = np.zeros(E_pad, dtype=np.float64 if dtype.is_floating_point
                        else np.int64)
        full[:E] = a
        return mesh.shard(torch.from_numpy(full)).to(device=dev, dtype=dtype)

    n_ids = R + M
    L = max(1, int(np.ceil(np.log2(max(n_ids, 2)))))
    s_tot, c_tot, r2, ok_row, _ = _lca_sums(
        block(u, torch.int64), block(v, torch.int64), block(s, dt),
        block(c, dt), order, R, L)
    stat = _pooled_stat(mesh.psum(s_tot), mesh.psum(c_tot), r2, ok_row)
    return stat.cpu().numpy()
