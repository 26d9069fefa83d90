"""Plain reference of the batched pooled-mean greedy merge and of its exact
merge-time saliencies, in plain PyTorch on the host.

The merge order is defined by supersteps of depth-limited Boruvka chain
contraction (the semantics of glia_tpu_torch.graph.merge_device's
``mode="fused"``, which ``fused_ms`` reproduces row for row):

1. Every live edge's statistic is its pooled mean ``sum / max(count, 1)``
   in the working precision, ordered by the bits of its float32 value
   (values below float32's smallest normal count as 0).
2. Every vertex selects its minimum incident live edge, ties to the lowest
   edge index; its parent is that edge's other end.  The selection forms
   trees, each with one mutual-minimum pair; the lower id of the pair is
   the root.
3. Every vertex within ``dmax`` parent hops of its root attaches this
   superstep.  Attaches are ordered by (root, statistic of the attaching
   vertex's own selected edge, hop, vertex id); each component records a
   chain of rows (r0, r1, r2): the first merges the root with the first
   attached vertex into the fresh id r2, each next one merges the previous
   fresh id with the next vertex.  Fresh ids are R, R + 1, ... in record
   order.  A row's engine saliency is minus its vertex's edge statistic.
4. The selected edges of recorded attaches die; the rest are relabeled to
   their component's last fresh id, self-loops die, and duplicate pairs are
   combined: a stable sort on (lo, hi) (dead edges last, in index order),
   each run's payloads summed in order into its first row, which alone
   stays live.  The edges keep that sorted order.
5. Repeat until no edge is live, R - 1 merges are recorded or
   ``max_supersteps`` supersteps ran.

Sums add in row order with ``index_add_`` in the working precision.  The
exact merge-time saliency of a row is the pooled mean of all base edges
whose endpoints' lowest common ancestor in the merge tree is that row's
fresh id: the boundary between the two merged parts at merge time.  It is
summed here in float64 (``bincount``), independently of any order.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

BIG32 = 2 ** 31 - 1
FLOAT32_TINY = float(np.finfo(np.float32).tiny)


def _stat_bits(stat: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    p = stat.to(torch.float32)
    p = torch.where(p.abs() < FLOAT32_TINY, torch.zeros_like(p), p)
    return torch.where(alive, p.view(torch.int32).long(),
                       torch.full_like(alive, BIG32, dtype=torch.int64))


def batched_merge(u, v, s, c, n_regions, dmax=4, dtype=torch.float32,
                  max_supersteps=256):
    """The merge order of the batched pooled-mean merge.

    u, v: endpoint indices [E] in [0, n_regions); s, c: per-edge boundary
    pb sum and pixel count (cast to ``dtype``).  Returns (rows int64
    [n, 3], engine saliencies [n] in ``dtype``, supersteps)."""
    u = torch.as_tensor(np.asarray(u)).long().clone()
    v = torch.as_tensor(np.asarray(v)).long().clone()
    pay = torch.stack([torch.as_tensor(np.asarray(s)).to(dtype),
                       torch.as_tensor(np.asarray(c)).to(dtype)], dim=1)
    E = u.shape[0]
    R = int(n_regions)
    max_m = max(R - 1, 1)
    n_ids = R + max_m
    vid = torch.arange(n_ids)
    alive = torch.ones(E, dtype=torch.bool)
    rows, sals = [], []
    n_m = steps = 0
    while steps < max_supersteps and bool(alive.any()) and n_m < max_m:
        steps += 1
        idx = torch.arange(E)
        stat = pay[:, 0] / torch.clamp(pay[:, 1], min=1.0)
        bits = _stat_bits(stat, alive)
        # each vertex's minimum incident live edge, ties to the lowest index
        key = torch.where(alive, bits * (E + 1) + idx,
                          torch.full_like(idx, 2 ** 62))
        best = torch.full((n_ids,), 2 ** 62, dtype=torch.int64)
        best.scatter_reduce_(0, u, key, "amin")
        best.scatter_reduce_(0, v, key, "amin")
        has = best < 2 ** 62
        m = torch.where(has, best % (E + 1), 0)
        other = torch.where(u[m] == vid, v[m], u[m])
        parent = torch.where(has, other, vid)
        vbits = torch.where(has, bits[m], BIG32)
        is_root = has & (parent[parent] == vid) & (vid < parent)
        # hop distance to the root, at most dmax; the root of each vertex
        INF = dmax + 1
        hop = torch.where(is_root, 0, INF)
        root = torch.where(is_root, vid, -1)
        for _ in range(dmax):
            hp = hop[parent]
            reach = (hop == INF) & (hp < INF)
            root = torch.where(reach, root[parent], root)
            hop = torch.where(reach, hp + 1, hop)
        attach = has & (hop >= 1) & (hop <= dmax)
        member = attach | is_root
        # (root, statistic, hop, id) order over the vertices of components
        vs = torch.nonzero(member).flatten().numpy()
        keys = (vs, hop[vs].numpy(),
                np.where(attach[vs].numpy(), vbits[vs].numpy(), -1),
                root[vs].numpy())
        vs = torch.as_tensor(vs[np.lexsort(keys)])
        rt_s = root[vs]
        merge_row = attach[vs]
        grank = torch.cumsum(merge_row.long(), 0) - 1
        ok = merge_row & (grank < max_m - n_m)
        new_run = torch.ones_like(merge_row)
        new_run[1:] = rt_s[1:] != rt_s[:-1]
        prev_merge = torch.zeros_like(merge_row)
        prev_merge[1:] = merge_row[:-1]
        first_in_chain = merge_row & (new_run | ~prev_merge)
        r2 = R + n_m + grank
        r0 = torch.where(first_in_chain, rt_s, r2 - 1)
        sel = torch.nonzero(ok).flatten()
        rows.append(torch.stack([r0[sel], vs[sel], r2[sel]], dim=1))
        sals.append(-stat[m[vs[sel]]])
        # each component becomes its last recorded fresh id
        run_id = torch.cumsum(new_run.long(), 0) - 1
        last = torch.full((int(run_id[-1]) + 1 if len(vs) else 0,), -1,
                          dtype=torch.int64)
        last.scatter_reduce_(0, run_id, torch.where(ok, grank, -1), "amax")
        last_v = last[run_id]
        contracted = (last_v >= 0) & (ok | ~merge_row)
        lut = vid.clone()
        lut[vs[contracted]] = R + n_m + last_v[contracted]
        used = torch.zeros(E, dtype=torch.bool)
        used[m[vs[sel]]] = True
        u2, v2 = lut[u], lut[v]
        alive2 = alive & ~used & (u2 != v2)
        # combine duplicate pairs: stable sort on (lo, hi), dead edges last
        lo = torch.where(alive2, torch.minimum(u2, v2), n_ids)
        hi = torch.where(alive2, torch.maximum(u2, v2), idx)
        perm = torch.sort(lo * (max(n_ids, E) + 1) + hi, stable=True).indices
        lo_s, hi_s, alive_s = lo[perm], hi[perm], alive2[perm]
        first = torch.ones(E, dtype=torch.bool)
        first[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
        seg = torch.cumsum(first.long(), 0) - 1
        ps = pay[perm]
        sums = torch.zeros_like(ps).index_add_(
            0, seg, torch.where(alive_s[:, None], ps, 0.0))
        keep = first & alive_s
        pay = torch.where(keep[:, None], sums[seg], ps)
        u, v, alive = u2[perm], v2[perm], keep
        n_m += int(ok.sum())
    if rows:
        return torch.cat(rows).numpy(), torch.cat(sals), steps
    return np.zeros((0, 3), np.int64), torch.zeros(0, dtype=dtype), steps


def exact_saliency(u, v, s, c, rows, n_regions, dtype=torch.float64):
    """Exact merge-time pooled mean of every row of a merge order: per row
    the (sum, count) of the base edges whose endpoints' lowest common
    ancestor in the merge tree is that row's fresh id.  ``dtype``
    float64 sums with ``bincount``; any other dtype sums in that precision
    with ``index_add_`` in edge order (the lower-precision control).
    Returns float64 [n]; NaN where a row's boundary is empty."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    R = int(n_regions)
    n = len(rows)
    n_ids = R + n
    parent = np.arange(n_ids + 1)
    if n:
        parent[rows[:, 0]] = rows[:, 2]
        parent[rows[:, 1]] = rows[:, 2]
    # depth: a fresh id is always above the ids it merges, so a pass from
    # the highest id down fixes every depth
    depth = np.zeros(n_ids + 1, np.int64)
    for x in range(n_ids - 1, -1, -1):
        if parent[x] != x:
            depth[x] = depth[parent[x]] + 1
    a, b = u.copy(), v.copy()
    for _ in range(int(depth.max(initial=0)) * 2 + 2):
        diff = a != b
        if not diff.any():
            break
        da, db = depth[a], depth[b]
        up_a = diff & (da >= db)
        up_b = diff & (db > da)
        a = np.where(up_a, parent[a], a)
        b = np.where(up_b, parent[b], b)
    lca = np.where(a == b, a, n_ids)        # different trees: discarded
    if dtype == torch.float64:
        s_tot = np.bincount(lca, weights=np.asarray(s, np.float64),
                            minlength=n_ids + 1)
        c_tot = np.bincount(lca, weights=np.asarray(c, np.float64),
                            minlength=n_ids + 1)
        sm, cm = s_tot[rows[:, 2]], c_tot[rows[:, 2]]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(cm > 0, sm / np.maximum(cm, 1.0), np.nan)
    key = torch.as_tensor(lca)
    tot = torch.zeros((n_ids + 1, 2), dtype=dtype).index_add_(
        0, key, torch.stack([torch.as_tensor(np.asarray(s)).to(dtype),
                             torch.as_tensor(np.asarray(c)).to(dtype)], 1))
    sm = tot[rows[:, 2], 0]
    cm = tot[rows[:, 2], 1]
    mean = (sm / torch.clamp(cm, min=1.0)).double().numpy()
    return np.where(cm.double().numpy() > 0, mean, np.nan)
