"""The section the cell runs and its boundary maps, made from ``--seed`` by
the benchmark's own code (no module of the program makes an input).

``bench_section``: glia_tpu_torch/bench.py's recipe at commit 28cc36d
(``bench_section``): a synthetic slice of ``side``^2 with (side // 14)^2
cells, blur 1.2, noise 0.12; its watershed at 0.004 after a gaussian of
1.0; the RAG with every boundary; the merge's edge arrays.

``boundary_sums``: the per-edge boundary sums of further boundary maps of
the same section over the same over-segmentation: the same membranes
(the recipe's blurred membrane map) under noise of their own at the
recipe's level, as several boundary predictors would give.  Only the
sums change from map to map; the edges and their pixel counts stay.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

from ..reference.host.native import watershed_native
from ..reference.host.rag import build_rag
from .synthetic import synthetic_em_slice

BENCH_CELL = 14


def sub_seed(seed: int, stream: int) -> list:
    """A seed for numpy's generator that stream ``stream`` of run seed
    ``seed`` draws from (any whole number, also past 64 bits)."""
    return [int(stream), int(seed) % 2 ** 64, int(seed) // 2 ** 64]


def edge_mean_arrays(rag, pb_image):
    """Per-edge (sum, count) of boundary pb and dense endpoint indices
    (copy of glia_tpu_torch/graph/merge_device.py's at commit 28cc36d)."""
    pb = np.asarray(pb_image, dtype=np.float64).ravel()
    E = rag.n_edges
    eid = np.repeat(np.arange(E), np.diff(rag.edge_ptr))
    s = np.bincount(eid, weights=pb[rag.edge_pixels], minlength=E)
    c = np.diff(rag.edge_ptr).astype(np.float64)
    u = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    v = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    return u, v, s, c


def bench_section(side: int, seed, blur=1.2, noise=0.12, smooth=1.0,
                  level=0.004):
    """bench.py's section at ``side``^2: (data, seg, rag, (u, v, s, c))."""
    data = synthetic_em_slice((side, side), n_cells=(side // BENCH_CELL) ** 2,
                              seed=seed, blur=blur, noise=noise)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], smooth),
                           level=level)
    rag = build_rag(seg, contour_only=False)
    return data, seg, rag, edge_mean_arrays(rag, data["pb"])


def membranes(truth, blur):
    """The generator's membrane map before its noise: the pixels whose
    label differs from a 4-neighbour's, blurred and scaled to a peak of 1
    (``synthetic_em_slice``'s own steps)."""
    memb = np.zeros(truth.shape, dtype=np.float32)
    dx = (truth[:, :-1] != truth[:, 1:]).astype(np.float32)
    dy = (truth[:-1, :] != truth[1:, :]).astype(np.float32)
    memb[:, :-1] = np.maximum(memb[:, :-1], dx)
    memb[:, 1:] = np.maximum(memb[:, 1:], dx)
    memb[:-1, :] = np.maximum(memb[:-1, :], dy)
    memb[1:, :] = np.maximum(memb[1:, :], dy)
    pb = ndi.gaussian_filter(memb, blur)
    return pb / max(pb.max(), 1e-6)


def boundary_sums(data, rag, seed, n_maps: int, blur=1.2, noise=0.12):
    """Per-edge boundary pb sums [n_maps, E] (float64) of ``n_maps`` more
    boundary maps of the section ``data``: map k is the membrane map plus
    noise of standard deviation ``noise`` drawn from stream 10 + k of
    ``seed``, clipped to [0, 1] and rounded to float32 as the section's
    own pb is.  Each is drawn at the boundary pixels alone, the only ones
    a sum reads."""
    px = rag.edge_pixels
    clean = membranes(data["truth"], blur).ravel()[px]
    eid = np.repeat(np.arange(rag.n_edges), np.diff(rag.edge_ptr))
    out = np.empty((n_maps, rag.n_edges))
    for k in range(n_maps):
        rng = np.random.default_rng(sub_seed(seed, 10 + k))
        pb = np.clip(clean + rng.normal(0, noise, len(px)), 0, 1)
        out[k] = np.bincount(eid, weights=pb.astype(np.float32),
                             minlength=rag.n_edges)
    return out
