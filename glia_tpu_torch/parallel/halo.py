"""Halo exchange for edge-partitioned RAG aggregation (counterpart of
glia_tpu.parallel.halo).

The dense path (rag_shard.py) gathers the whole region table; here the
partition plan (partition.py) drives a routing-planned exchange that
moves only cut-region rows between ranks:

  phase 1 (reduce): each rank segment-sums its edges into per-region
    partials (kernel B2 on the card), then sends the partial rows of
    regions another rank owns to their owner with one ``all_to_all``
    (slabs padded to the plan's largest pair); owners add them into
    their authoritative block.  Both sums run in a fixed order (B2's
    sorted entry), so two runs give the same bits.
  phase 2 (halo fetch): owners send authoritative rows back to every
    rank that listed them as halo, with a second ``all_to_all``.

The routing tables are computed on the host from the Partition, the same
on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segment_csr import segment_order, segment_sum_ordered
from .mesh import Mesh, to_device
from .partition import Partition
from .rag_shard import edge_pixel_stats, incident_order, incident_sums


class HaloPlan:
    """Host-side routing tables for one Partition (a copy of glia_tpu's).

    Vectorized construction (sort/unique over (shard, region) codes):
    O((E + R) log) host work, no per-edge Python loops."""

    def __init__(self, part: Partition, rag):
        n = part.n_shards
        R = rag.n_regions
        owner = part.region_shard.astype(np.int64)
        ui = rag.key_index(rag.edges[:, 0]).astype(np.int64)
        vi = rag.key_index(rag.edges[:, 1]).astype(np.int64)
        es = part.edge_shard.astype(np.int64)

        # unique (shard, region) touch pairs over both endpoints
        codes = np.unique(np.concatenate([es * R + ui, es * R + vi]))
        ts = codes // R           # touching shard
        tr = codes % R            # touched region
        to = owner[tr]            # region owner
        foreign = to != ts
        fs, fr, ft = ts[foreign], tr[foreign], to[foreign]
        # group by (source shard, owner shard); sorted region within group
        grp = fs * n + ft
        order = np.argsort(grp * np.int64(R) + fr, kind="stable")
        fs, fr, ft, grp = fs[order], fr[order], ft[order], grp[order]
        # slot index within each (s, t) group
        if len(grp):
            first = np.concatenate([[True], grp[1:] != grp[:-1]])
            gidx = np.cumsum(first) - 1
            starts = np.nonzero(first)[0]
            slot = np.arange(len(grp)) - starts[gidx]
            H = int(slot.max()) + 1
        else:
            slot = np.zeros(0, np.int64)
            H = 1
        H = max(H, 1)
        self.H = H
        self.n = n
        # send_ids[s, t, :]: global region ids shard s sends to owner t
        self.send_ids = np.full((n, n, H), -1, dtype=np.int32)
        self.send_ids[fs, ft, slot] = fr
        # owners' local numbering
        own_counts = np.bincount(owner, minlength=n)
        self.R_own_max = max(int(own_counts.max()) if R else 1, 1)
        oorder = np.argsort(owner, kind="stable")
        ostart = np.zeros(n + 1, np.int64)
        np.cumsum(own_counts, out=ostart[1:])
        self.own_ids = np.full((n, self.R_own_max), -1, dtype=np.int32)
        self.local_of_global = np.full(R, -1, dtype=np.int32)
        rows = owner[oorder]
        cols = np.arange(R) - ostart[rows]
        self.own_ids[rows, cols] = oorder
        self.local_of_global[oorder] = cols.astype(np.int32)
        # recv_local[t, s, :]: local row in owner t's block per recv slot;
        # the phase 2 fetch uses the same id sets reversed
        self.recv_local = np.full((n, n, H), -1, dtype=np.int32)
        self.recv_local[ft, fs, slot] = self.local_of_global[fr]
        self.halo_ids = self.send_ids          # [s, t, H]: s wants these
        self.fetch_local = self.recv_local

    @property
    def comm_rows(self) -> int:
        """Rows moved per all_to_all (both phases equal)."""
        return int((self.send_ids >= 0).sum())


def _masked_rows(table: torch.Tensor, ids: torch.Tensor, fill=0.0):
    """table[ids] where ids >= 0, ``fill`` elsewhere."""
    rows = table[ids.clamp(min=0)]
    return torch.where((ids >= 0)[:, None], rows, fill)


def fold_order(recv_local: torch.Tensor, n_own: int):
    """The fixed order of ``owner_fold`` for a rank's routing rows
    ``recv_local`` [n, H] (-1 where a slot is empty): the
    ``segment_order`` of the ids [0, 1, .., n_own - 1; recv_local].  The
    stable sort puts each own row first and the rows received for it
    after it in slot order, the order of a sequential ``index_add`` into
    the own block.  Computed once per routing plan."""
    ids = torch.cat([torch.arange(n_own, dtype=torch.int64,
                                  device=recv_local.device),
                     recv_local.reshape(-1).long()])
    return segment_order(ids)


def owner_fold(own: torch.Tensor, recv_rows: torch.Tensor, order):
    """The own rows [n_own, F] plus the received partial rows [n * H, F],
    each added into the own row its slot names (``order`` from
    ``fold_order``; empty slots dropped): one sorted segment sum, so the
    same bits on every run."""
    return segment_sum_ordered(torch.cat([own, recv_rows]), order,
                               own.shape[0])


def halo_exchange(mesh: Mesh, partials, send_ids, fold, own_ids,
                  fetch_local):
    """Both phases on one rank: ``partials`` [R + 1, F] over the global
    region universe; the rank's routing rows send_ids / fetch_local
    [n, H], own_ids [R_own_max] and the ``fold_order`` of its recv_local
    rows.  Returns (own block [R_own_max, F], halo rows [n * H, F]: slot
    t*H + j from owner t)."""
    n, H = send_ids.shape
    F = partials.shape[1]
    # phase 1: partial rows of foreign regions -> owners
    send_rows = _masked_rows(partials, send_ids.reshape(-1))
    recv_rows = mesh.all_to_all(send_rows.reshape(n, H, F)).reshape(n * H, F)
    own = owner_fold(_masked_rows(partials, own_ids), recv_rows, fold)
    # phase 2: authoritative rows back to halo requesters
    out_rows = _masked_rows(own, fetch_local.reshape(-1))
    halo_rows = mesh.all_to_all(out_rows.reshape(n, H, F)).reshape(n * H, F)
    return own, halo_rows


def _rank_routes(mesh: Mesh, send_ids, recv_local, own_ids, fetch_local):
    """The rank's rows of the full routing tables, its recv_local rows as
    their ``fold_order``: the routing arguments of ``halo_exchange``."""
    own = mesh.shard(own_ids)
    return (mesh.shard(send_ids)[0],
            fold_order(mesh.shard(recv_local)[0], own.shape[0]), own,
            mesh.shard(fetch_local)[0])


def make_halo_aggregate(mesh: Mesh, plan: HaloPlan, n_regions: int,
                        n_feat: int):
    """SPMD aggregation with halo exchange.

    f(u, v, ev, send_ids, recv_local, own_ids, halo_ids, fetch_local)
      -> (own blocks [n * R_own_max, F], halo rows [n * n * H, F])
    from the full arrays ``shard_halo_inputs`` sets up."""

    def agg(u, v, ev, send_ids, recv_local, own_ids, halo_ids, fetch_local):
        part = incident_sums(mesh.shard(ev),
                             incident_order(mesh.shard(u), mesh.shard(v)),
                             n_regions + 1)
        own, halo_rows = halo_exchange(
            mesh, part, *_rank_routes(mesh, send_ids, recv_local, own_ids,
                                      fetch_local))
        return mesh.all_gather(own), mesh.all_gather(halo_rows)

    return agg


def local_endpoint_indices(plan: HaloPlan, part: Partition, rag,
                           groups, E_max):
    """Per-shard local row index (into [own_block; halo_rows]) for each
    edge endpoint.  Rows 0..R_own_max-1 are the shard's own regions;
    rows R_own_max + t*H + j are halo slot j from owner t."""
    n, H, R_own = plan.n, plan.H, plan.R_own_max
    R = rag.n_regions
    ui = rag.key_index(rag.edges[:, 0]).astype(np.int64)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int64)
    owner = part.region_shard
    slot_lut = np.full((n, R), -1, np.int64)
    s_i, t_i, j_i = np.nonzero(plan.send_ids >= 0)
    slot_lut[s_i, plan.send_ids[s_i, t_i, j_i]] = t_i * H + j_i
    u_loc = np.zeros((n, E_max), np.int32)
    v_loc = np.zeros((n, E_max), np.int32)
    for s, g in enumerate(groups):
        for arr, ridx in ((u_loc, ui[g]), (v_loc, vi[g])):
            own = owner[ridx] == s
            arr[s, : len(g)] = np.where(
                own, plan.local_of_global[ridx],
                R_own + slot_lut[s, ridx])
    return u_loc, v_loc


def make_halo_edge_forward(mesh: Mesh, plan: HaloPlan, n_regions: int,
                           mlp_dims=(8, 16, 8)):
    """Edge scoring with the routing-planned halo instead of the dense
    gather (compare parallel/train.edge_forward): same math, traffic ~ cut
    size.  score(w, u, v, px, px_mask, edge_valid, u_loc, v_loc, send_ids,
    recv_local, own_ids, fetch_local) -> [n * E_max]."""
    from ..models.mlp import mlp2_forward

    D, N1, N2 = mlp_dims

    def score(w, u, v, px, px_mask, edge_valid, u_loc, v_loc,
              send_ids, recv_local, own_ids, fetch_local):
        mean, mn, mx, cnt = edge_pixel_stats(mesh.shard(px),
                                             mesh.shard(px_mask))
        msgs = torch.stack([torch.ones_like(mean), mean, mn, mx], dim=1)
        msgs = msgs * mesh.shard(edge_valid)[:, None]
        part = incident_sums(msgs,
                             incident_order(mesh.shard(u), mesh.shard(v)),
                             n_regions + 1)
        own, halo_rows = halo_exchange(
            mesh, part, *_rank_routes(mesh, send_ids, recv_local, own_ids,
                                      fetch_local))
        table = torch.cat([own, halo_rows], dim=0)
        ru = table[mesh.shard(u_loc)]
        rv = table[mesh.shard(v_loc)]
        feats = torch.cat([torch.stack([mean, mn, mx, cnt], dim=1),
                           ru[:, :2], rv[:, :2]], dim=1).to(torch.float32)
        return mesh.all_gather(mlp2_forward(w, feats, D, N1, N2))

    return score


def group_edges(part: Partition, n: int):
    """The edges each shard owns, and the padded per-shard row count."""
    groups = [np.nonzero(part.edge_shard == s)[0] for s in range(n)]
    E_max = max(max((len(g) for g in groups), default=1), 1)
    return groups, E_max


def routing_tensors(mesh: Mesh, plan: HaloPlan):
    """The plan's routing tables as int64 tensors on the mesh's device."""
    return {
        "send_ids": to_device(plan.send_ids, mesh, torch.int64),
        "recv_local": to_device(plan.recv_local, mesh, torch.int64),
        "own_ids": to_device(plan.own_ids.reshape(-1), mesh, torch.int64),
        "halo_ids": to_device(plan.halo_ids, mesh, torch.int64),
        "fetch_local": to_device(plan.fetch_local, mesh, torch.int64),
    }


def shard_halo_inputs(mesh: Mesh, plan: HaloPlan, part: Partition, rag, ev):
    """The edge data reordered by owning shard + the routing tables, as
    full tensors on the mesh's device.

    Returns a dict for make_halo_aggregate, plus the edge grouping used
    (edges grouped by shard, padded per shard to E_max)."""
    n = plan.n
    ui = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    ev = np.asarray(ev, np.float32)
    groups, E_max = group_edges(part, n)
    u_p = np.full((n, E_max), rag.n_regions, np.int32)  # pad -> extra seg
    v_p = np.full((n, E_max), rag.n_regions, np.int32)
    ev_p = np.zeros((n, E_max, ev.shape[1]), np.float32)
    for s, g in enumerate(groups):
        u_p[s, : len(g)] = ui[g]
        v_p[s, : len(g)] = vi[g]
        ev_p[s, : len(g)] = ev[g]
    return {
        "u": to_device(u_p.reshape(-1), mesh, torch.int64),
        "v": to_device(v_p.reshape(-1), mesh, torch.int64),
        "ev": to_device(ev_p.reshape(-1, ev.shape[1]), mesh),
        **routing_tensors(mesh, plan),
        "groups": groups,
        "E_max": E_max,
    }
