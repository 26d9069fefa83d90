"""Greedy RAG merge engines (a copy of glia_tpu.graph.merge).

Host-exact engine reproducing the reference's serial priority-queue loop
(code/util/struct_merge.hxx:13-33 driving code/type/boundary_table.hxx):

  - pop the edge with the highest *saliency* (= -boundary statistic, so the
    weakest boundary merges first); among equal saliencies the reference's
    multimap reverse scan yields latest-inserted-first, reproduced here via a
    (stat, -seq) heap key;
  - record (r0, r1, new_key) with new_key = max_key + 1 incrementing
    (struct_merge.hxx:20,27-29);
  - rekey both regions' edges to the new region, splicing the two incident
    edges' data when a neighbor touched both (boundary_table.hxx:122-167).

Boundary statistics (struct_merge.hxx policies):
  - "median": upper median sorted[n//2] of boundary pixel values -- exactly
    ``stats::amedian`` (code/util/stats.hxx:83-91); data = spliced pixel
    values (genMergeOrderGreedyUsingPbApproxMedian, struct_merge.hxx:90-136);
  - "mean": pooled (sum, count) weighted mean
    (genMergeOrderGreedyUsingPbMean, struct_merge.hxx:38-85);
  - "median_minsize": -median * min(|r0|, |r1|)
    (...ApproxMedianAndMinSize, struct_merge.hxx:141-185), always merges
    region pixel sets to track sizes.

The device engines live in merge_device.py; this engine is the golden
oracle, and pre_merge(engine="py") runs it.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np

from ..constants import sdivide
from .rag import Rag


def _upper_median(values: np.ndarray) -> float:
    """stats::amedian (code/util/stats.hxx:83-91): sorted[n//2], no averaging."""
    n = len(values)
    if n == 0:
        return -1.0  # DUMMY
    k = n // 2
    return float(np.partition(values, k)[k])


class _Policy:
    """Per-edge data container + statistic for one saliency policy."""

    merges_regions = False

    def init_data(self, values):
        raise NotImplementedError

    def splice(self, d0, d1):
        raise NotImplementedError

    def stat(self, data, ru, rv, sizes):
        raise NotImplementedError


class MedianPolicy(_Policy):
    def init_data(self, values):
        return np.asarray(values, dtype=np.float64)

    def splice(self, d0, d1):
        if d0 is None:
            return d1
        if d1 is None:
            return d0
        return np.concatenate([d0, d1])

    def stat(self, data, ru, rv, sizes):
        return _upper_median(data)


class MeanPolicy(_Policy):
    def init_data(self, values):
        v = np.asarray(values, dtype=np.float64)
        return (float(v.sum()), len(v))

    def splice(self, d0, d1):
        s = c = 0.0
        if d0 is not None:
            s += d0[0]
            c += d0[1]
        if d1 is not None:
            s += d1[0]
            c += d1[1]
        return (s, int(c))

    def stat(self, data, ru, rv, sizes):
        return sdivide(data[0], data[1], 0.0)


class MedianMinSizePolicy(MedianPolicy):
    merges_regions = True

    def stat(self, data, ru, rv, sizes):
        return _upper_median(data) * min(sizes[ru], sizes[rv])


POLICIES = {
    "median": MedianPolicy,
    "mean": MeanPolicy,
    "median_minsize": MedianMinSizePolicy,
}


def greedy_merge_order(
    rag: Rag,
    pb_image,
    policy: str = "median",
    fcond: Optional[Callable] = None,
    track_sizes: bool = False,
    on_merge: Optional[Callable] = None,
):
    """Serial exact greedy merge.

    Parameters
    ----------
    rag : built RAG (edges carry boundary pixel lists).
    pb_image : boundary-probability image (same shape as the label image).
    policy : "median" | "mean" | "median_minsize".
    fcond : optional condition fn(u, v, sizes, pb_means) -> bool; the queue
        is scanned from best saliency until it returns True; the loop stops
        when no candidate passes (boundary_table.hxx:48-53).  ``pb_means``
        is a dict cache for region mean-pb lookups (used by pre_merge).
    track_sizes : also maintain region sizes even if the policy doesn't
        need them (for fcond).
    on_merge : optional callback fn(r0, r1, r2) fired after each committed
        merge (lets fcond closures maintain per-region state, e.g. the
        pre_merge region-mean-pb cache).

    Returns (order [n,3] int64, saliencies [n] float64).  Saliencies are the
    recorded queue keys, i.e. the *negated* statistic, matching the saliency
    file written by merge_order_pb (main_merge_order_pb.cxx:37-38).
    """
    pol = POLICIES[policy]()
    need_sizes = pol.merges_regions or track_sizes or fcond is not None
    pb = np.asarray(pb_image).ravel().astype(np.float64)

    sizes = {}
    if need_sizes:
        if rag.sizes is None or len(rag.sizes) == 0:
            raise ValueError("RAG has no region sizes; build with full init")
        sizes = {int(k): int(s) for k, s in zip(rag.keys, rag.sizes)}

    # table[(u,v)] -> data ; adjacency for O(degree) updates
    table = {}
    entry_seq = {}
    adj = {}
    heap = []
    seq = 0

    def push(u, v, data, stat):
        nonlocal seq
        key = (u, v)
        table[key] = data
        entry_seq[key] = seq
        # heap orders by (stat asc, seq desc): the reference pops the highest
        # saliency (-stat) and, on ties, the latest inserted first.
        heapq.heappush(heap, (stat, -seq, u, v))
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
        seq += 1

    for eid in range(rag.n_edges):
        u, v = int(rag.edges[eid, 0]), int(rag.edges[eid, 1])
        vals = pb[rag.edge_pixels[rag.edge_ptr[eid]:rag.edge_ptr[eid + 1]]]
        data = pol.init_data(vals)
        push(u, v, data, pol.stat(data, u, v, sizes))

    def pop_valid():
        """Highest-saliency live entry, honoring fcond skip semantics.

        A skipped (fcond-failing) candidate is dropped from the heap
        permanently: fcond may only depend on the endpoint regions' state,
        which cannot change without the pair being rekeyed -- and rekeying
        re-pushes a fresh entry.  (The reference rescans its multimap on
        every top() call, boundary_table.hxx:48-53, with identical results
        but O(skipped) extra work per merge.)
        """
        while heap:
            stat, nseq, u, v = heapq.heappop(heap)
            key = (u, v)
            if entry_seq.get(key) != -nseq:
                continue  # stale
            if fcond is not None and not fcond(u, v, sizes, _pb_mean_cache):
                continue  # frozen until rekeyed
            return (stat, u, v)
        return None

    _pb_mean_cache = {}  # fcond scratch: region key -> mean pb (pre_merge use)

    max_key = int(rag.keys.max()) if len(rag.keys) else 0
    next_key = max_key + 1
    order = []
    sals = []

    while table:
        popped = pop_valid()
        if popped is None:
            break
        stat, r0, r1 = popped
        r2 = next_key
        next_key += 1
        order.append((r0, r1, r2))
        sals.append(-stat)

        if need_sizes:
            sizes[r2] = sizes.get(r0, 0) + sizes.get(r1, 0)
        if on_merge is not None:
            on_merge(r0, r1, r2)

        # remove the merged edge
        del table[(r0, r1)]
        del entry_seq[(r0, r1)]
        adj[r0].discard(r1)
        adj[r1].discard(r0)

        neighbors = adj.pop(r0, set()) | adj.pop(r1, set())
        for rs in neighbors:
            k0 = (min(r0, rs), max(r0, rs))
            k1 = (min(r1, rs), max(r1, rs))
            d0 = table.pop(k0, None)
            d1 = table.pop(k1, None)
            entry_seq.pop(k0, None)
            entry_seq.pop(k1, None)
            adj[rs].discard(r0)
            adj[rs].discard(r1)
            data = pol.splice(d0, d1)
            push(rs, r2, data, pol.stat(data, rs, r2, sizes))

    return (
        np.asarray(order, dtype=np.int64).reshape(-1, 3),
        np.asarray(sals, dtype=np.float64),
    )


def apply_merge_order(labels, order, threshold_index=None, saliencies=None,
                      saliency_threshold=None):
    """Replay a merge order onto a label image (transformKeys semantics,
    code/util/struct_merge.hxx:189-210 + gadget/main_apply_merges.cxx).

    Optionally stop after ``threshold_index`` merges or when the recorded
    saliency drops below ``saliency_threshold``.
    Returns the relabeled image (labels merged to final keys).
    """
    order = np.asarray(order)
    n = len(order)
    if threshold_index is None:
        threshold_index = n
    if saliency_threshold is not None and saliencies is not None:
        keep = np.nonzero(np.asarray(saliencies) < saliency_threshold)[0]
        threshold_index = min(threshold_index, keep[0] if len(keep) else n)
    omap = {}
    for i in range(int(threshold_index)):
        r0, r1, r2 = (int(x) for x in order[i])
        omap[r0] = r2
        omap[r1] = r2
    # path-compress to final labels
    final = {}
    for k in list(omap):
        dst = omap[k]
        while dst in omap:
            dst = omap[dst]
        final[k] = dst
    labels = np.asarray(labels)
    out = labels.copy()
    if final:
        keys = np.array(list(final.keys()), dtype=labels.dtype)
        vals = np.array(list(final.values()), dtype=labels.dtype)
        lut_size = int(max(labels.max(), keys.max())) + 1
        lut = np.arange(lut_size, dtype=labels.dtype)
        lut[keys] = vals
        out = lut[labels]
    return out
