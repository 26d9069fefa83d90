"""Headline benchmark of the port: RAG greedy-merge edges/s on one card
(counterpart of the repository's bench.py; BASELINE.json's metric).

    python -m glia_tpu_torch.bench [--device cpu]

Environment, as bench.py reads it: GLIA_BENCH_SIDE (default 4096),
GLIA_BENCH_MODE (``fused_ms``, the default; ``fused``; ``chunked``) and
GLIA_BENCH_REPS (default 5).

What is timed: the complete merge order of a watershed RAG and its exact
merge-time saliencies, both on the device (``merge_batched_device_exact``
for ``fused_ms``: the multi-phase merge and the LCA saliency sums as one
program; for the other modes ``merge_batched_device`` then
``exact_saliency_device``), REPS calls on inputs staged on the device once,
each synchronized.  One edge processed is one boundary retired (popped or
rekeyed): edges/s = (E + merges) / the median call.  ``vs_baseline`` is
that over the host's exact serial greedy engine on the same RAG
(``native.greedy_merge_native``, pooled mean).

The section is bench.py's (``bench_section``, which the examples, the
card suite and chip_smoke.py share): ``synthetic_em_slice((side, side),
(side // 14)**2 cells, seed=11, blur=1.2, noise=0.12)``, its watershed at
0.004 after a gaussian of 1.0, and the RAG (243,749 regions and 597,140
edges at 4096^2).  Nothing compiles at run time: the first call on a shape
discovers the multi-phase plan; with ``fused_ms`` on the card the first
timed call captures the plan as a CUDA graph and the others replay it.
Both are reported apart from the median, which stays bench.py's median
over all REPS calls.  The device order is cross-checked against the host's
replay of its saliencies and cut at bench.py's threshold (k = R - cells
merges of the serial order): the device saliencies' cut, the engine's
stale start-of-superstep saliencies' cut and the host's cut are scored
(VI) against the truth.

Prints exactly one JSON line on stdout, bench.py's {"metric", "value",
"unit", "vs_baseline"}; diagnostics go to stderr, one line each.  One of
them, ``counts: {...}``, is JSON: R, E, the merges, the timed calls'
seconds, the host serial run and ``launches``, each kernel's launches from
the first call to the stale-saliency merge (graph replays counted by
their tally).  Anything that raises ends the script with a non-zero
status and no JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

METRIC = "rag_merge_edges_per_s_per_chip"
# bench.py's section: one cell per 14 x 14 pixels
CELL = 14


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Section:
    """bench.py's section, its RAG and edge arrays, and the host serial
    baseline on it (order keys, saliencies, seconds)."""

    side: int
    n_cells: int
    data: dict
    seg: np.ndarray
    rag: object
    edges: tuple           # (u, v, s, c) of edge_mean_arrays
    order_h: np.ndarray
    sal_h: np.ndarray
    setup_s: float
    host_s: float

    @property
    def host_edges_s(self) -> float:
        return (self.rag.n_edges + len(self.order_h)) / self.host_s


def bench_section(side: int, n_cells: int, seed: int = 11):
    """(section dict, watershed, RAG) of bench.py's section: the synthetic
    slice, its watershed at 0.004 after a gaussian of 1.0, the RAG with
    every boundary (``contour_only=False``)."""
    import scipy.ndimage as ndi

    from .data.synthetic import synthetic_em_slice
    from .graph.rag import build_rag
    from .native import watershed_native

    data = synthetic_em_slice((side, side), n_cells=n_cells, seed=seed,
                              blur=1.2, noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    return data, seg, build_rag(seg, contour_only=False)


def setup(side: int = 4096) -> Section:
    """bench.py's section at ``side``^2 and its host serial baseline (the
    exact serial greedy merge, the reference's hot loop)."""
    from .graph.merge_device import edge_mean_arrays
    from .native import greedy_merge_native

    t0 = time.perf_counter()
    n_cells = (side // CELL) ** 2
    data, seg, rag = bench_section(side, n_cells)
    setup_s = time.perf_counter() - t0
    log(f"setup: {side}x{side}, {rag.n_regions} regions, {rag.n_edges} "
        f"edges ({setup_s:.1f}s)")
    t0 = time.perf_counter()
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="mean")
    host_s = time.perf_counter() - t0
    sec = Section(side, n_cells, data, seg, rag,
                  edge_mean_arrays(rag, data["pb"]), order_h, sal_h,
                  setup_s, host_s)
    log(f"host exact serial greedy: {len(order_h)} merges in {host_s:.3f}s"
        f" -> {sec.host_edges_s:,.0f} edges/s")
    return sec


def same_run(a, b) -> bool:
    """Two (order, saliencies, n_merges) give the same rows and saliency
    bits."""
    import torch

    n = a[2]
    return (n == b[2] and torch.equal(a[0][:n], b[0][:n])
            and np.array_equal(a[1][:n].cpu().numpy(),
                               b[1][:n].cpu().numpy(), equal_nan=True))


def _check_args(mode, reps):
    from .graph.merge_device import MODES

    if mode not in MODES:
        raise ValueError(f"GLIA_BENCH_MODE {mode!r} ({'|'.join(MODES)})")
    if reps < 1:
        raise ValueError(f"GLIA_BENCH_REPS {reps} (at least 1)")


def run_exact(mode, u, v, s, c, R, device, stats=None):
    """bench.py's timed call: the merge order and its exact saliencies on
    ``device``, as one program for ``fused_ms``
    (``merge_batched_device_exact``), else the merge, then the saliencies
    of its order.  Returns (order, saliencies, merges)."""
    import torch

    from .graph.merge_device import (exact_saliency_device,
                                     merge_batched_device,
                                     merge_batched_device_exact)

    if mode == "fused_ms":
        return merge_batched_device_exact(u, v, s, c, R, stats=stats,
                                          device=device)
    o, sb, n = merge_batched_device(u, v, s, c, R, stats=stats, mode=mode,
                                    device=device)
    ex = exact_saliency_device(u, v, s, c, o, R, device=device)
    return o, torch.where(torch.isnan(ex), sb, -ex), n


def measure(sec: Section, mode: str = "fused_ms", reps: int = 5,
            device=None) -> dict:
    """bench.py's device measurement on ``sec`` in ``mode`` on ``device``
    (the CUDA card by default): a first call, the one-time staging of the
    edge arrays, ``reps`` timed calls, the host replay cross-check and the
    three threshold cuts.  Returns everything printed, with bench.py's
    JSON under ``result``, and under ``outputs`` the (order, saliencies,
    merges) of the first and the last call."""
    import torch

    from .device import (default_dtype, nvidia_smi_line, resolve_device,
                         synchronize)
    from .graph.merge import apply_merge_order
    from .graph.merge_device import (merge_batched_device, order_to_keys,
                                     replay_exact_saliency, threshold_cut)
    from .metrics import eval_vi
    from .ops import cuda as kcuda

    _check_args(mode, reps)
    dev = resolve_device(device)
    rag, seg = sec.rag, sec.seg
    E, R = rag.n_edges, rag.n_regions
    u, v, s, c = sec.edges
    card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if card else str(dev)
    smi = nvidia_smi_line() if card else None
    log(f"device: {name}" + (f" ({smi})" if smi else ""))

    stats = {}
    kcuda.reset_launches()
    t0 = time.perf_counter()
    first = run_exact(mode, u, v, s, c, R, dev, stats)
    synchronize(dev)
    first_s = time.perf_counter() - t0
    log(f"first call (plan discovery; nothing compiles): {first_s:.3f}s, "
        f"{first[2]} merges, {stats['n_supersteps']} supersteps")
    fallback = bool(stats.get("fallback"))

    # inputs staged on the device once (upstream stages would leave the
    # RAG's edge arrays there); a one-time cost, logged
    t0 = time.perf_counter()
    dt = default_dtype(dev)
    u_d = torch.as_tensor(u, device=dev).long()
    v_d = torch.as_tensor(v, device=dev).long()
    s_d = torch.as_tensor(s, device=dev).to(dt)
    c_d = torch.as_tensor(c, device=dev).to(dt)
    synchronize(dev)
    staging_s = time.perf_counter() - t0
    log(f"one-time input staging (host->device): {staging_s:.3f}s")

    reps_s, graphs, same = [], [], True
    for _ in range(reps):
        st = {}
        t0 = time.perf_counter()
        out = run_exact(mode, u_d, v_d, s_d, c_d, R, dev, st)
        synchronize(dev)
        reps_s.append(time.perf_counter() - t0)
        graphs.append(bool(st.get("plan_graph")))
        fallback = fallback or bool(st.get("fallback"))
        same = same and same_run(out, first)
    if fallback:
        log("WARNING: fused_ms capacity plan overflowed on this RAG; "
            "measuring the single-phase fallback engine")
    order_b, sal_b, n_m = out
    run_med = float(np.median(reps_s))
    run_min = float(np.min(reps_s))
    dev_edges_s = (E + n_m) / run_med
    log(f"device merge+saliency reps: "
        f"{' '.join(f'{r:.4f}' for r in sorted(reps_s))}s (median "
        f"{run_med:.4f}, min {run_min:.4f}); identical to the first call: "
        f"{same}")
    capture_s = replay_med = None
    if graphs[0]:
        capture_s = reps_s[0]
        if reps > 1:
            replay_med = float(np.median(reps_s[1:]))
        log(f"plan graph: capture call {capture_s:.4f}s, replays "
            f"{sum(graphs[1:])} of {reps - 1}, replay median {replay_med}s "
            f"(first call {first_s:.3f}s)")
    log(f"device {mode} merge + exact saliency: {n_m} merges in "
        f"{run_med:.4f}s median -> {dev_edges_s:,.0f} edges/s/chip "
        f"({dev_edges_s / sec.host_edges_s:.2f}x host serial; min-rep "
        f"{(E + n_m) / run_min:,.0f}); fallback {fallback}")

    # parity: the host replay cross-checks the device saliencies; the cut
    # at bench.py's threshold on the device saliencies, on the engine's
    # stale start-of-superstep ones, and the serial order's cut
    k = R - sec.n_cells
    tau = -sec.sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    ex = -sal_b[:n_m].double().cpu().numpy()
    t0 = time.perf_counter()
    ex_host = replay_exact_saliency(u, v, s, c,
                                    order_b[:n_m].cpu().numpy())
    replay_s = time.perf_counter() - t0
    okh = np.isfinite(ex_host)
    dmax_sal = float(np.abs(ex[okh] - ex_host[okh]).max()) if okh.any() \
        else 0.0
    log(f"host-replay cross-check: {replay_s:.2f}s, max |device - host| = "
        f"{dmax_sal:.3g}")
    seg_b = apply_merge_order(seg, okeys[threshold_cut(okeys, ex, tau)])
    _, sal_stale, _ = merge_batched_device(u_d, v_d, s_d, c_d, R, mode=mode,
                                           device=dev)
    mask_stale = threshold_cut(
        okeys, -sal_stale[:n_m].double().cpu().numpy(), tau)
    launches = dict(kcuda.launches)
    seg_stale = apply_merge_order(seg, okeys[mask_stale])
    seg_h = apply_merge_order(seg, sec.order_h, threshold_index=k)
    truth = sec.data["truth"]
    vi_b = eval_vi(seg_b, truth)[2]
    vi_s = eval_vi(seg_stale, truth)[2]
    vi_h = eval_vi(seg_h, truth)[2]
    log(f"threshold-cut parity (device saliencies): VI serial {vi_h:.4f} "
        f"vs device {vi_b:.4f} (delta {vi_b - vi_h:+.4f}; stale-saliency "
        f"cut would be {vi_s:.4f}, {vi_s - vi_h:+.4f})")

    result = {"metric": METRIC, "value": round(dev_edges_s, 1),
              "unit": "edges/s",
              "vs_baseline": round(dev_edges_s / sec.host_edges_s, 3)}
    log("counts: " + json.dumps(
        {"side": sec.side, "mode": mode, "R": R, "E": E, "merges": n_m,
         "reps_s": reps_s, "host_s": sec.host_s,
         "host_merges": int(len(sec.order_h)), "launches": launches}))
    return {"result": result, "side": sec.side, "mode": mode,
            "R": R, "E": E, "n_cells": sec.n_cells, "merges": n_m,
            "setup_s": sec.setup_s, "host_s": sec.host_s,
            "host_merges": int(len(sec.order_h)),
            "host_edges_s": sec.host_edges_s, "first_s": first_s,
            "first_stats": stats, "staging_s": staging_s, "reps_s": reps_s,
            "median_s": run_med, "min_s": run_min,
            "edges_per_s": dev_edges_s,
            "edges_per_s_min_rep": (E + n_m) / run_min,
            "plan_graph": graphs, "capture_call_s": capture_s,
            "replay_median_s": replay_med, "fallback": fallback,
            "reps_identical": same, "replay_s": replay_s,
            "replay_max_abs_gap": dmax_sal, "k": k, "tau": float(tau),
            "vi_serial": vi_h, "vi_device": vi_b, "vi_stale": vi_s,
            "device": name, "nvidia_smi": smi, "launches": launches,
            "outputs": {"first": first, "last": out}}


def run(side: int = 4096, mode: str = "fused_ms", reps: int = 5,
        device=None) -> dict:
    """bench.py end to end: ``setup(side)`` then ``measure``; the device,
    the mode and the repetitions are checked before the section is
    built."""
    from .device import resolve_device

    _check_args(mode, reps)
    dev = resolve_device(device)
    return measure(setup(side), mode, reps, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(int(os.environ.get("GLIA_BENCH_SIDE", "4096")),
              os.environ.get("GLIA_BENCH_MODE", "fused_ms"),
              int(os.environ.get("GLIA_BENCH_REPS", "5")), args.device)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
