"""The volume stage of BASELINE config #5 ("full SNEMI3D-scale volume,
RAG edge-partitioned"), shared by ``run_snemi_e2e`` and
``run_snemi_sharded`` (the first stages of the repository's
tools/run_snemi_e2e.py and tools/run_snemi_sharded.py).

``make_volume``: ``synthetic_em_stack((Z, side, side), n_cells, seed=23)``,
the watershed at ``GLIA_WS_LEVEL`` (default 0.01) and the RAG
(``contour_only=False``), all on the host.  At 100 x 1024 x 1024 (105M
voxels) glia_tpu's run has 1,188,099 regions and 1,409,885 edges.
``edge_labels``: the majority truth body of each region, an edge label
(1 where both ends have the same body) and the region-truth pair table
that every threshold cut is scored from.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

SEED = 23
DEFAULT_LEVEL = 0.01


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peak_gb() -> float:
    """This process's peak resident memory, GB (``ru_maxrss``, kB on
    Linux).  Not asked of the ranks: a spawned process's count starts
    from what its parent held when it forked."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def card_peak_gb(device) -> Optional[float]:
    """The most memory PyTorch's allocator held on ``device`` since the
    last ``torch.cuda.reset_peak_memory_stats``, GB; None off the card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


@dataclass
class Volume:
    """A synthetic stack, its watershed and RAG, with the dense endpoint
    rows ``ui``, ``vi`` of every edge and the seconds of each stage."""
    shape: tuple
    pb: np.ndarray
    intensity: np.ndarray
    truth: np.ndarray
    seg: np.ndarray
    rag: object
    ui: np.ndarray
    vi: np.ndarray
    stages: dict = field(default_factory=dict)


def make_volume(Z: int, side: int, n_cells: int,
                level: Optional[float] = None) -> Volume:
    """Generate (seed SEED), watershed (at ``level``, else
    ``GLIA_WS_LEVEL``, else DEFAULT_LEVEL) and build the RAG of a
    Z x side x side stack."""
    from ..data.synthetic import synthetic_em_stack
    from ..graph.rag import build_rag
    from ..native import watershed_native

    stages = {}
    t0 = time.perf_counter()
    stack = synthetic_em_stack(shape=(Z, side, side), n_cells=n_cells,
                               seed=SEED)
    pb = stack["pb3d"]
    truth = stack["truth3d"]
    intensity = np.stack([s["intensity"] for s in stack["slices"]])
    del stack
    stages["generate"] = time.perf_counter() - t0
    log(f"volume: {Z}x{side}x{side} = {pb.size / 1e6:.0f}M voxels "
        f"({stages['generate']:.1f}s, peak {peak_gb():.1f}GB)")

    if level is None:
        level = float(os.environ.get("GLIA_WS_LEVEL", DEFAULT_LEVEL))
    t0 = time.perf_counter()
    seg = watershed_native(pb, level=level)
    stages["watershed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rag = build_rag(seg, contour_only=False)
    stages["build_rag"] = time.perf_counter() - t0
    log(f"supervoxel RAG: {rag.n_regions} regions, {rag.n_edges} edges "
        f"(ws {stages['watershed']:.1f}s, rag {stages['build_rag']:.1f}s, "
        f"peak {peak_gb():.1f}GB)")
    ui = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    return Volume((Z, side, side), pb, intensity, truth, seg, rag, ui, vi,
                  stages)


def region_majority_truth(rag, truth):
    """Majority truth label per region (packed-key unique counts; the
    tool's copy without its unused per-region best count).

    Also returns the full (region, truth-label, count) sparse pair table
    -- the ONE voxel pass all downstream metrics aggregate from: every
    threshold-cut segmentation is a merge of watershed regions, so its
    voxel-level contingency vs truth is exactly this table grouped by
    merged component (no per-tau voxel rescan)."""
    t = np.asarray(truth).ravel().astype(np.int64)
    rl = np.diff(rag.region_ptr)
    rid = np.repeat(np.arange(rag.n_regions, dtype=np.int64), rl)
    tmax = int(t.max()) + 1
    key = rid * tmax + t[rag.region_pixels]
    uk, cnt = np.unique(key, return_counts=True)
    regs = uk // tmax
    labs = uk % tmax
    maj = np.zeros(rag.n_regions, dtype=np.int64)
    order = np.argsort(cnt, kind="stable")
    maj[regs[order]] = labs[order]
    return maj, (regs, labs, cnt.astype(np.int64))


def resolve_components(okeys, mask, keys, n_keys):
    """Final component key per leaf key under the cut ``mask`` (the
    monotonized cut is prefix-closed, so selected rows form a consistent
    forest); vectorized pointer doubling."""
    parent = np.arange(n_keys, dtype=np.int64)
    sel = np.asarray(okeys)[mask]
    parent[sel[:, 0]] = sel[:, 2]
    parent[sel[:, 1]] = sel[:, 2]
    while True:
        p2 = parent[parent]
        if np.array_equal(p2, parent):
            break
        parent = p2
    return parent[keys]


def edge_labels(vol: Volume):
    """(labels [E] float32, the pair table (regions, truth labels,
    counts)): an edge is labeled 1 where both ends have the same
    majority truth body."""
    maj, pairs = region_majority_truth(vol.rag, vol.truth)
    return (maj[vol.ui] == maj[vol.vi]).astype(np.float32), pairs
