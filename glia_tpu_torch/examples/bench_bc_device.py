"""The classifier-in-the-loop merge on the device (counterpart of the
repository's tools/bench_bc_device.py): every candidate of every
superstep gets its full-width BC feature row and is scored by a forest
(kernel B1 on the card) inside the merge loop.

    python -m glia_tpu_torch.examples.bench_bc_device [side] [n_cells]
        [n_trees] [--device cpu]

Defaults 512, (side // 17)**2 cells, 120 trees.  The forest is the
port's own CART (``models.forest.train_forest``, sklearn's draws) on the
tool's training section: ``min(side, 256)``^2, seed 1, the serial median
order's BC rows without saliencies and their f1 labels.  The test
section is ``synthetic_em_slice((side, side), n_cells, seed=9, blur=1.2,
noise=0.12)``; the host serial median order (C++) on it is the baseline.
``merge_order_bc_device`` runs twice: a first call, then a steady call.
``compile_s`` keeps the tool's name and definition (first call less the
steady call); here the first call builds the kernels.  The tool's 4th
argument picks one of glia_tpu's JAX scorers; the port has one forest
walk a device (B1 on the card, the plain walk on the CPU), so it has no
such argument.  Quality: the device order's tree resolved greedily
against the watershed (``vi_watershed``, ``vi_bc``).  Prints one JSON
line with the tool's keys, plus the port's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .snemi import log


def training_forest(side: int, n_cells: int, n_trees: int, seed: int = 1):
    """The tool's forest: trained on the median order's BC rows (no
    saliency columns) of a ``min(side, 256)``^2 section."""
    import scipy.ndimage as ndi

    from ..data.synthetic import synthetic_em_slice
    from ..features import FeatureConfig, TreeFeatures, bc_labels
    from ..graph.rag import build_rag
    from ..models.forest import train_forest
    from ..native import greedy_merge_native, watershed_native

    tr = synthetic_em_slice((min(side, 256),) * 2,
                            n_cells=max(n_cells // max(side // 256, 1) ** 2,
                                        20), seed=seed)
    seg_t = watershed_native(ndi.gaussian_filter(tr["pb"], 1.0), level=0.004)
    rag_t = build_rag(seg_t, contour_only=False)
    cfg_t = FeatureConfig.standard(tr["pb"], tr["intensity"], n_bins=16)
    order_t, _ = greedy_merge_native(rag_t, tr["pb"], policy="median")
    X = TreeFeatures(rag_t, order_t, cfg_t, saliencies=None).bc_features()
    y = bc_labels(seg_t, tr["truth"], order_t, rule="f1")[0]
    return train_forest(X, y, n_trees=n_trees, seed=0, n_jobs=-1), X.shape


def bc_test_section(side: int, n_cells: int, seed: int = 9):
    """(section, watershed, RAG, feature config) of the tool's test
    section."""
    from ..features import FeatureConfig
    from ..bench import bench_section

    te, seg0, rag = bench_section(side, n_cells, seed=seed)
    return te, seg0, rag, FeatureConfig.standard(te["pb"], te["intensity"],
                                                 n_bins=16)


def bench_bc_device(side: int = 512, n_cells=None, n_trees: int = 120,
                    device=None) -> dict:
    """The tool's measurement on ``device`` (the CUDA card by default).
    Returns the tool's keys, unrounded, plus the merges, supersteps and
    candidates scored of the steady call, its seconds and the first
    call's, ``steady_equal_first`` (the steady call's order and
    probabilities equal the first call's, bit for bit) and ``device``."""
    from ..device import resolve_device, synchronize
    from ..graph import build_tree, node_potentials
    from ..graph.merge_bc_device import merge_order_bc_device
    from ..infer.greedy import resolve_tree_greedy
    from ..infer.segment import final_segmentation
    from ..metrics import eval_vi
    from ..models.forest import make_label_scorer
    from ..native import greedy_merge_native

    dev = resolve_device(device)
    if n_cells is None:
        n_cells = (side // 17) ** 2
    t0 = time.perf_counter()
    model, shape = training_forest(side, n_cells, n_trees)
    log(f"train: {shape[0]} samples x {shape[1]} feats, {n_trees} trees, "
        f"depth {model.max_depth} ({time.perf_counter() - t0:.1f}s)")
    predict = make_label_scorer(model, label=-1, device=dev)

    t0 = time.perf_counter()
    te, seg0, rag, cfg = bc_test_section(side, n_cells)
    log(f"test RAG: {rag.n_regions} regions, {rag.n_edges} edges "
        f"({time.perf_counter() - t0:.1f}s)")

    # host baseline: the reference's serial greedy loop (C++), same RAG
    t0 = time.perf_counter()
    order_h, _ = greedy_merge_native(rag, te["pb"], policy="median")
    host_dt = time.perf_counter() - t0
    host_edges_s = (rag.n_edges + len(order_h)) / host_dt
    log(f"host serial greedy (median): {host_edges_s:,.0f} edges/s")

    runs = []
    for name in ("first", "steady"):
        stats = {}
        t0 = time.perf_counter()
        order, probs = merge_order_bc_device(rag, cfg, predict, stats=stats,
                                             device=dev)
        synchronize(dev)
        runs.append((order, probs, stats, time.perf_counter() - t0))
        log(f"{name} call: {runs[-1][3]:.2f}s, {len(order)} merges, "
            f"{stats['n_supersteps']} supersteps, {stats['n_scored']} "
            f"scored")
    (order0, probs0, _, first_dt), (order, probs, stats, run_dt) = runs
    scores_s = stats["n_scored"] / run_dt
    merges_s = len(order) / run_dt

    # quality: the device order's tree resolved against the watershed
    tree = build_tree(order)
    picks = resolve_tree_greedy(tree, node_potentials(tree, probs))
    seg = final_segmentation(seg0, tree, picks)
    vi0 = eval_vi(seg0, te["truth"])[2]
    vi = eval_vi(seg, te["truth"])[2]
    log(f"quality: watershed VI {vi0:.3f} -> device BC-HMT VI {vi:.3f}")
    return {"edges": int(rag.n_edges), "feat_dim": int(stats["feat_dim"]),
            "compile_s": first_dt - run_dt, "scores_per_s": scores_s,
            "merges_per_s": merges_s, "host_serial_edges_s": host_edges_s,
            "vi_watershed": vi0, "vi_bc": vi,
            "merges": int(len(order)),
            "supersteps": int(stats["n_supersteps"]),
            "n_scored": int(stats["n_scored"]), "first_s": first_dt,
            "steady_s": run_dt,
            "steady_equal_first": bool(
                np.array_equal(order, order0)
                and np.array_equal(probs, probs0, equal_nan=True)),
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=512)
    ap.add_argument("n_cells", nargs="?", type=int, default=None,
                    help="cells (default: (side // 17)**2)")
    ap.add_argument("n_trees", nargs="?", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = bench_bc_device(args.side, args.n_cells, args.n_trees, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
