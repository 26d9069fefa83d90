"""Threshold-cut drift of the device median policies (counterpart of the
repository's tools/bench_median_drift.py).

    python -m glia_tpu_torch.examples.bench_median_drift [side] [policy]
        [n_bins] [--device cpu]

Defaults 1024, ``median`` (or ``median_minsize``), 32 bins.  The device
hist-median order (``merge_batched_device_hist`` /
``merge_batched_device_hist_minsize``, ``mode="fused_ms"``, on
``device``) is cut on (a) its own start-of-superstep sketch medians
(``stale``) and (b) the exact merge-time upper medians of the C++
multiset replay (``replay_exact_saliency_median``; ``exact``), both at
the serial median engine's threshold at n_cells regions, and each cut
scored against the truth beside the serial cut.  The drift is a property
of the algorithm, so any device shows it.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..bench import bench_section
from .snemi import log

POLICIES = ("median", "median_minsize")


def median_drift(side=1024, policy="median", n_bins=32, seed=11,
                 device=None):
    """The tool's dict (rounded as the tool rounds it), the device order
    on ``device`` (the CUDA card by default)."""
    import torch

    from ..device import resolve_device
    from ..graph.merge import apply_merge_order
    from ..graph.merge_device import (
        edge_hist_arrays, merge_batched_device_hist,
        merge_batched_device_hist_minsize, order_to_keys,
        replay_exact_saliency_median, threshold_cut)
    from ..metrics import eval_vi
    from ..native import greedy_merge_native

    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r} ({'|'.join(POLICIES)})")
    dev = resolve_device(device)
    n_cells = (side // 14) ** 2
    data, seg, rag = bench_section(side, n_cells, seed=seed)
    R = rag.n_regions
    log(f"{side}^2: {R} regions, {rag.n_edges} edges, policy={policy}")

    t0 = time.perf_counter()
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy=policy)
    log(f"serial {policy} engine: {len(order_h)} merges "
        f"({time.perf_counter() - t0:.1f}s)")

    u, v, h = edge_hist_arrays(rag, data["pb"], n_bins=n_bins)
    t0 = time.perf_counter()
    sizes = None
    if policy == "median_minsize":
        sizes = rag.sizes
        order_d, sal_d, n_m = merge_batched_device_hist_minsize(
            u, v, h, sizes, R, mode="fused_ms", device=dev)
    else:
        order_d, sal_d, n_m = merge_batched_device_hist(
            u, v, h, R, mode="fused_ms", device=dev)
    log(f"device hist-{policy} fused_ms: {n_m} merges "
        f"({time.perf_counter() - t0:.1f}s)")
    order_np = torch.as_tensor(order_d)[:n_m].cpu().numpy()
    okeys = order_to_keys(order_np, n_m, rag)

    t0 = time.perf_counter()
    pb = np.asarray(data["pb"], np.float64).ravel()
    ex = replay_exact_saliency_median(u, v, rag.edge_ptr,
                                      pb[rag.edge_pixels], order_np,
                                      region_sizes=sizes)
    log(f"exact median replay: {time.perf_counter() - t0:.1f}s")
    stale = -torch.as_tensor(sal_d)[:n_m].cpu().numpy().astype(np.float64)
    ex = np.where(np.isnan(ex), stale, ex)

    k = R - n_cells
    tau = -sal_h[k - 1]
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    vi_h = eval_vi(seg_h, data["truth"])[2]
    out = {"side": side, "policy": policy, "n_bins": n_bins,
           "edges": int(rag.n_edges),
           "vi_serial": round(float(vi_h), 4)}
    for name, stats in (("stale", stale), ("exact", ex)):
        mask = threshold_cut(okeys, stats, tau)
        seg_d = apply_merge_order(seg, okeys[mask])
        vi_d = eval_vi(seg_d, data["truth"])[2]
        out[f"vi_{name}"] = round(float(vi_d), 4)
        out[f"dvi_{name}"] = round(float(vi_d - vi_h), 4)
        log(f"{name} cut: VI {vi_d:.4f} (dVI {vi_d - vi_h:+.4f})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("policy", nargs="?", default="median", choices=POLICIES)
    ap.add_argument("n_bins", nargs="?", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = median_drift(args.side, args.policy, n_bins=args.n_bins,
                       device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
