"""Mid-cut quality of the device classifier-in-the-loop order against the
serial one (counterpart of the repository's tools/bench_bc_midcut.py).

    python -m glia_tpu_torch.examples.bench_bc_midcut [side] [n_cells]
        [n_trees] [--device cpu]

Full merges give the same components in any order, so the two orders are
compared at mid-cut operating points: at each probability threshold tau
both hierarchies are cut with the monotonized threshold cut (a candidate
merges iff its whole build chain scored P(merge) >= tau) and scored
against the truth.  The serial order is the C++ engine
``native.greedy_merge_bc_native`` (one pop of the most probable
candidate a step, the reference's util/struct_merge_bc.hxx:10-58); the
device order is ``merge_order_bc_device`` with the forest walked on
``device`` (kernel B1 on the card).  The forest, the training section
and the test section are bench_bc_device's, with this tool's defaults
(60 trees).  Prints the rows as one JSON line.

The serial order of a section of more than CACHE_MIN_EDGES edges is kept
on disk, in the repository's root, as ``.cache_midcut_<version>_<side>_
<cells>_<trees>_<seed>.npz`` (``order``, ``probs``; delete it to measure
again): at 2048^2 the serial engine takes hours.  Two switches, read as
the tool reads them (any non-empty value is on): GLIA_MIDCUT_PY_SERIAL
runs the Python serial engine (``graph.merge_bc.greedy_merge_bc``, the
C++ engine's oracle) in place of the C++ one, a diagnostic A/B switch
kept to match the tool (the same order, far slower), and
GLIA_MIDCUT_SERIAL_ONLY
stops after the serial order (cached when large) and returns no rows,
so that a later run reuses it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .bench_bc_device import bc_test_section, training_forest
from .snemi import log

TAUS = (0.9, 0.8, 0.7, 0.6, 0.5)
# serial orders of larger RAGs are cached (test-scale runs stay uncached)
CACHE_MIN_EDGES = 30000
CACHE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the port's own token, so that no cache of glia_tpu's tool is read as
# the port's; a new token whenever the serial engine, the feature config
# or the training recipe changes (a stale order would skew the table)
CACHE_VERSION = "torch1"


def serial_order(rag, cfg, model, side, n_cells, n_trees, seed):
    """The serial classifier-in-the-loop order (order, probs) of the test
    section: from the cache when the RAG is large and the file is there,
    else from the C++ engine (the Python one under GLIA_MIDCUT_PY_SERIAL),
    written to the cache when the RAG is large."""
    from ..graph.merge_bc import greedy_merge_bc
    from ..models.forest import predict_label_fraction
    from ..native import greedy_merge_bc_native

    cache = os.path.join(
        CACHE_DIR, f".cache_midcut_{CACHE_VERSION}_{side}_{n_cells}_"
        f"{n_trees}_{seed}.npz")
    use_cache = rag.n_edges > CACHE_MIN_EDGES
    if use_cache and os.path.exists(cache):
        with np.load(cache) as d:
            order, probs = d["order"], d["probs"]
        log(f"host serial BC order: {len(order)} merges (cached: {cache}, "
            f"mtime {time.ctime(os.path.getmtime(cache))}; delete the file "
            f"to measure again)")
        return order, probs
    t0 = time.perf_counter()
    if os.environ.get("GLIA_MIDCUT_PY_SERIAL"):
        def predict_batch(F):
            return predict_label_fraction(model, F, label=-1)

        order, probs = greedy_merge_bc(
            rag, cfg, lambda f: float(predict_batch(f[None, :])[0]),
            predict_batch=predict_batch)
    else:
        order, probs = greedy_merge_bc_native(rag, cfg, model)
    log(f"host serial BC order: {len(order)} merges "
        f"({time.perf_counter() - t0:.1f}s)")
    if use_cache:
        np.savez(cache, order=np.asarray(order), probs=np.asarray(probs))
    return order, probs


def bc_midcut_compare(side=512, n_cells=None, n_trees=60, seed=9,
                      taus=TAUS, device=None):
    """Rows {tau, vi_serial, regions_serial, vi_device, regions_device,
    dvi} rounded as the tool rounds them, the device order on ``device``
    (the CUDA card by default); [] under GLIA_MIDCUT_SERIAL_ONLY."""
    from ..device import resolve_device
    from ..graph.merge import apply_merge_order
    from ..graph.merge_bc_device import merge_order_bc_device
    from ..graph.merge_device import threshold_cut
    from ..metrics import eval_vi
    from ..models.forest import make_label_scorer

    dev = resolve_device(device)
    if n_cells is None:
        n_cells = (side // 17) ** 2
    t0 = time.perf_counter()
    model, shape = training_forest(side, n_cells, n_trees)
    log(f"train: {shape[0]}x{shape[1]}, {n_trees} trees "
        f"({time.perf_counter() - t0:.1f}s)")
    te, seg0, rag, cfg = bc_test_section(side, n_cells, seed=seed)
    log(f"test RAG: {rag.n_regions} regions, {rag.n_edges} edges")

    order_h, probs_h = serial_order(rag, cfg, model, side, n_cells, n_trees,
                                    seed)
    if os.environ.get("GLIA_MIDCUT_SERIAL_ONLY"):
        log("serial-only pass done; run again without the switch for the "
            "table")
        return []
    t0 = time.perf_counter()
    order_d, probs_d = merge_order_bc_device(
        rag, cfg, make_label_scorer(model, label=-1, device=dev), device=dev)
    log(f"device BC order: {len(order_d)} merges "
        f"({time.perf_counter() - t0:.1f}s)")

    rows = []
    for tau in taus:
        out = {"tau": tau}
        for name, order, probs in [("serial", order_h, probs_h),
                                   ("device", order_d, probs_d)]:
            mask = threshold_cut(np.asarray(order),
                                 -np.asarray(probs, np.float64), -tau)
            seg = apply_merge_order(seg0, np.asarray(order)[mask])
            vi = eval_vi(seg, te["truth"])[2]
            out[f"vi_{name}"] = round(float(vi), 4)
            out[f"regions_{name}"] = int(len(np.unique(seg)))
        out["dvi"] = round(out["vi_device"] - out["vi_serial"], 4)
        rows.append(out)
        log(f"tau={tau}: serial VI {out['vi_serial']:.4f} "
            f"({out['regions_serial']} regions) vs device "
            f"{out['vi_device']:.4f} ({out['regions_device']}) "
            f"dVI {out['dvi']:+.4f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=512)
    ap.add_argument("n_cells", nargs="?", type=int, default=None,
                    help="cells (default: (side // 17)**2)")
    ap.add_argument("n_trees", nargs="?", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = bc_midcut_compare(args.side, args.n_cells, args.n_trees,
                             device=args.device)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
