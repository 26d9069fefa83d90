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
    _, idx = cKDTree(centers).query(pts, k=1)
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


def synthetic_em_stack(shape=(8, 128, 128), n_cells=24, seed=0, **kw):
    """A small 3D stack: per-slice 2D geometry with z-coherent cells.

    Cells are 3D Voronoi regions so consecutive slices link naturally
    (the LINK3D use case).
    """
    rng = np.random.default_rng(seed)
    z, h, w = shape
    centers = rng.uniform(0, 1, size=(n_cells, 3)) * np.array([z * 4, h, w])
    from scipy.spatial import cKDTree

    zz, yy, xx = np.mgrid[0:z, 0:h, 0:w]
    pts = np.stack([zz.ravel() * 4.0, yy.ravel() * 1.0, xx.ravel() * 1.0],
                   axis=1)
    _, idx = cKDTree(centers).query(pts, k=1)
    truth = (idx.reshape(z, h, w) + 1).astype(np.int32)
    # 3D membrane indicator: boundary against any 6-neighbor (so the pb
    # carries z-transition signal too, like a real EM membrane channel)
    memb = np.zeros((z, h, w), dtype=np.float32)
    for ax in range(3):
        d = np.diff(truth, axis=ax) != 0
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = slice(None, -1)
        sl_hi[ax] = slice(1, None)
        memb[tuple(sl_lo)] = np.maximum(memb[tuple(sl_lo)],
                                        d.astype(np.float32))
        memb[tuple(sl_hi)] = np.maximum(memb[tuple(sl_hi)],
                                        d.astype(np.float32))
    pb3 = ndi.gaussian_filter(memb, (0.6, 1.5, 1.5))
    pb3 = pb3 / max(pb3.max(), 1e-6)
    pb3 = np.clip(pb3 + rng.normal(0, 0.08, (z, h, w)), 0, 1
                  ).astype(np.float32)
    slices = []
    for k in range(z):
        s = synthetic_em_slice((h, w), seed=seed + 1000 + k, **kw)
        slices.append({"truth": truth[k], "pb": pb3[k],
                       "intensity": s["intensity"]})
    return {"truth3d": truth, "pb3d": pb3, "slices": slices}
