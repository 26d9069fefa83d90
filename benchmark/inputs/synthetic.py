# Frozen copy of glia_tpu_torch/data/synthetic.py (synthetic_em_slice) at
# commit 28cc36d, with one change that gives the same arrays: the KD-tree
# query runs on every core (``workers=-1``).  benchmark/tests/
# test_bm_inputs.py holds it to the port's generator.
"""Synthetic EM-like test data.

No EM volumes ship with the repo, so tests and benchmarks use procedurally
generated data with the same structure as ISBI/SNEMI EM stacks: cell-like
truth regions (Voronoi), a boundary-probability map ("pb", the membrane
detector output the pipeline consumes), and a raw intensity image with dark
membranes.  Shapes/statistics are chosen to exercise the same code paths as
real data (512x512 slices, ~100-2000 superpixels after watershed).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi


def synthetic_em_slice(shape=(512, 512), n_cells=64, seed=0,
                       noise=0.1, blur=1.5):
    """Returns dict(truth, pb, intensity) for one 2D slice.

    truth: int32 labels 1..n_cells (no background)
    pb:    float32 in [0,1], high on membranes
    intensity: float32 in [0,1], dark membranes on bright cells
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    centers = rng.uniform(0, 1, size=(n_cells, 2)) * np.array([h, w])
    # nearest-center labeling via KD-tree (O(P log C)); a per-cell metric
    # warp is approximated by jittering query coordinates for irregularity
    from scipy.spatial import cKDTree

    yy, xx = np.mgrid[0:h, 0:w]
    # spatially-coherent warp field -> irregular but connected cells
    warp = ndi.gaussian_filter(rng.normal(0, 1, size=(2, h, w)),
                               (0, 6, 6)) * 12.0
    pts = np.stack([(yy + warp[0]).ravel(), (xx + warp[1]).ravel()], axis=1)
    # workers=-1: every query is independent, so the labels are the same
    _, idx = cKDTree(centers).query(pts, k=1, workers=-1)
    truth = (idx.reshape(h, w) + 1).astype(np.int32)

    # membrane indicator: pixel differs from +x or +y neighbor
    memb = np.zeros(shape, dtype=np.float32)
    diff_x = truth[:, :-1] != truth[:, 1:]
    diff_y = truth[:-1, :] != truth[1:, :]
    memb[:, :-1] = np.maximum(memb[:, :-1], diff_x.astype(np.float32))
    memb[:, 1:] = np.maximum(memb[:, 1:], diff_x.astype(np.float32))
    memb[:-1, :] = np.maximum(memb[:-1, :], diff_y.astype(np.float32))
    memb[1:, :] = np.maximum(memb[1:, :], diff_y.astype(np.float32))

    pb = ndi.gaussian_filter(memb, blur)
    pb = pb / max(pb.max(), 1e-6)
    pb = np.clip(pb + rng.normal(0, noise, shape), 0, 1).astype(np.float32)

    cell_int = rng.uniform(0.5, 0.9, size=n_cells + 1).astype(np.float32)
    intensity = cell_int[truth]
    intensity = intensity * (1.0 - 0.8 * ndi.gaussian_filter(memb, 1.0))
    intensity = np.clip(
        intensity + rng.normal(0, noise * 0.5, shape), 0, 1
    ).astype(np.float32)
    return {"truth": truth, "pb": pb, "intensity": intensity}
