"""The batched superstep merge engine against the host's serial C++
engine on one section (counterpart of the repository's
tools/bench_merge_device.py).

    python -m glia_tpu_torch.examples.bench_merge_device [side] [n_cells]
        [mode] [--device cpu]

Defaults 1024, (side // 14)**2 cells, mode ``fused`` (``fused_ms``: the
multi-phase engine).  The section is ``synthetic_em_slice((side, side),
n_cells, seed=11, blur=1.2, noise=0.12)``, its watershed at 0.004 after a
gaussian of 1.0, and the RAG.  The host serial greedy order (pooled mean,
``native.greedy_merge_native``) is the baseline; then the first call of
``merge_batched_device`` on the section's arrays, then the best of
STAGED_CALLS calls on inputs staged on ``device`` once.

``compile_s`` keeps the tool's name and definition (the first call's
seconds less the best staged call's).  Here the first call on a shape
builds the kernels it launches and, with ``fused_ms``, discovers the
phase plan; a staged ``fused_ms`` call then replays the plan as one CUDA
graph, captured at the first of them.  ``device_edges_s`` and
``host_edges_s`` are (E + merges) / seconds.  The quality check cuts the
device order at the serial order's threshold at n_cells regions and
scores both cuts against the truth (``vi_serial``, ``vi_batched``).
Prints one JSON line with the tool's keys, plus the port's.
"""

from __future__ import annotations

import argparse
import json
import time

from ..bench import bench_section
from .snemi import log

STAGED_CALLS = 3


def bench_merge_device(side: int = 1024, n_cells=None, mode: str = "fused",
                       device=None) -> dict:
    """The tool's measurement on ``device`` (the CUDA card by default).
    Returns the tool's keys, unrounded, plus ``mode``, ``merges``, the
    first and best staged seconds, the stats of the last staged call
    (supersteps, buckets, fallback, plan_replayed, plan_graph),
    ``cut_merges`` (the merges the quality cut keeps) and ``device``."""
    import torch

    from ..device import default_dtype, resolve_device, synchronize
    from ..graph.merge import apply_merge_order
    from ..graph.merge_device import (edge_mean_arrays,
                                      merge_batched_device, order_to_keys,
                                      threshold_cut)
    from ..metrics import eval_vi
    from ..native import greedy_merge_native

    dev = resolve_device(device)
    if n_cells is None:
        n_cells = (side // 14) ** 2
    t0 = time.perf_counter()
    data, seg, rag = bench_section(side, n_cells)
    pb = data["pb"]
    E, R = rag.n_edges, rag.n_regions
    log(f"setup: {side}x{side}, {R} regions, {E} edges "
        f"({time.perf_counter() - t0:.1f}s)")

    # host baseline: the exact serial greedy order (the reference's loop)
    t0 = time.perf_counter()
    order_h, sal_h = greedy_merge_native(rag, pb, policy="mean")
    host_dt = time.perf_counter() - t0
    host_edges_s = (E + len(order_h)) / host_dt
    log(f"host serial greedy: {len(order_h)} merges in {host_dt:.2f}s -> "
        f"{host_edges_s:,.0f} edges/s")

    u, v, s, c = edge_mean_arrays(rag, pb)
    stats = {}
    t0 = time.perf_counter()
    order_b, sal_b, n_m = merge_batched_device(u, v, s, c, R, stats=stats,
                                               mode=mode, device=dev)
    synchronize(dev)
    first_dt = time.perf_counter() - t0
    log(f"first call (kernel builds, plan discovery, run): {first_dt:.2f}s,"
        f" {n_m} merges, supersteps={stats.get('n_supersteps')}")

    dt = default_dtype(dev)
    staged = (torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev),
              torch.as_tensor(s, device=dev, dtype=dt),
              torch.as_tensor(c, device=dev, dtype=dt))
    synchronize(dev)
    run_dt = float("inf")
    for _ in range(STAGED_CALLS):
        stats = {}
        t0 = time.perf_counter()
        order_b, sal_b, n_m = merge_batched_device(*staged, R, stats=stats,
                                                   mode=mode, device=dev)
        synchronize(dev)
        run_dt = min(run_dt, time.perf_counter() - t0)
    dev_edges_s = (E + n_m) / run_dt
    log(f"staged call: {run_dt:.4f}s -> {dev_edges_s:,.0f} edges/s "
        f"({dev_edges_s / host_edges_s:.1f}x host)")

    # threshold-cut quality against the serial order's cut
    k = R - n_cells
    tau = -sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    mask = threshold_cut(okeys, -sal_b[:n_m].cpu().numpy(), tau)
    seg_b = apply_merge_order(seg, okeys[mask])
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    vi_b = eval_vi(seg_b, data["truth"])[2]
    vi_h = eval_vi(seg_h, data["truth"])[2]
    log(f"threshold-cut VI: serial {vi_h:.4f} vs batched {vi_b:.4f}")
    return {"edges": int(E), "compile_s": first_dt - run_dt,
            "device_edges_s": dev_edges_s, "host_edges_s": host_edges_s,
            "vi_serial": vi_h, "vi_batched": vi_b,
            "mode": mode, "merges": int(n_m), "first_s": first_dt,
            "staged_s": run_dt, "cut_merges": int(mask.sum()),
            "stats": {k: stats[k] for k in (
                "n_supersteps", "buckets", "fallback", "plan_replayed",
                "plan_graph") if k in stats},
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("n_cells", nargs="?", type=int, default=None,
                    help="cells (default: (side // 14)**2)")
    ap.add_argument("mode", nargs="?", default="fused",
                    choices=("fused", "fused_ms"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = bench_merge_device(args.side, args.n_cells, args.mode,
                             args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
