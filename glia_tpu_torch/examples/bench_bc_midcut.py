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
(60 trees).  The tool caches long serial runs on disk and has switches
for a Python serial engine and a serial-only pass; the port runs the
C++ engine every time.  Prints the rows as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .bench_bc_device import bc_test_section, training_forest
from .snemi import log

TAUS = (0.9, 0.8, 0.7, 0.6, 0.5)


def bc_midcut_compare(side=512, n_cells=None, n_trees=60, seed=9,
                      taus=TAUS, device=None):
    """Rows {tau, vi_serial, regions_serial, vi_device, regions_device,
    dvi} rounded as the tool rounds them, the device order on ``device``
    (the CUDA card by default)."""
    from ..device import resolve_device
    from ..graph.merge import apply_merge_order
    from ..graph.merge_bc_device import merge_order_bc_device
    from ..graph.merge_device import threshold_cut
    from ..metrics import eval_vi
    from ..models.forest import make_label_scorer
    from ..native import greedy_merge_bc_native

    dev = resolve_device(device)
    if n_cells is None:
        n_cells = (side // 17) ** 2
    t0 = time.perf_counter()
    model, shape = training_forest(side, n_cells, n_trees)
    log(f"train: {shape[0]}x{shape[1]}, {n_trees} trees "
        f"({time.perf_counter() - t0:.1f}s)")
    te, seg0, rag, cfg = bc_test_section(side, n_cells, seed=seed)
    log(f"test RAG: {rag.n_regions} regions, {rag.n_edges} edges")

    t0 = time.perf_counter()
    order_h, probs_h = greedy_merge_bc_native(rag, cfg, model)
    log(f"host serial BC order: {len(order_h)} merges "
        f"({time.perf_counter() - t0:.1f}s)")
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
