"""Steady-state walls of the multi-phase merge (mode="fused_ms") on one
CUDA card: every call after the first on a shape, which runs the memoized
plan.

    python3 glia_tpu_torch/examples/merge_steady_state.py \\
        [--root DIR] [--tag NAME] [--inputs FILE] [--reps 20]

imports ``glia_tpu_torch`` from ``--root`` (default: this checkout), so
that one card can time two trees of the package in turns (for example a
``git archive`` of another commit unpacked in a directory; the eager
program reads the plan memo's entries, so a tree whose entries differ is
timed by its own copy of this script).  Cases: the
1024^2 section of ``chip_smoke.py`` (the mean, median and median_minsize
merges; merge_batched_device_exact) and bench.py's 4096^2 section
(merge_batched_device_exact), all in float32; their edge arrays are kept
in ``--inputs`` (made by the first run that finds none).  Each case: three
calls (the first discovers the plan), then ``--reps`` timed calls (median
and extremes in ms).  ``--inputs`` defaults to this checkout's ``.build/``.  A tree whose merge has ``plan_graph_info`` (a plan
captured as a CUDA graph) also times the same plan program run eagerly
on the card, and lists the graphs.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def make_inputs(md, path):
    import scipy.ndimage as ndi

    from glia_tpu_torch.data.synthetic import synthetic_em_slice
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.pipeline import pre_merge, watershed

    d = synthetic_em_slice((1024, 1024), n_cells=(1024 // 17) ** 2, seed=0)
    seg = pre_merge(watershed(d["pb"], 0.05), d["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    u, v, s, c = md.edge_mean_arrays(rag, d["pb"])
    _, _, h = md.edge_hist_arrays(rag, d["pb"], n_bins=32)
    b = synthetic_em_slice((4096, 4096), n_cells=(4096 // 14) ** 2,
                           seed=11, blur=1.2, noise=0.12)
    rag_b = build_rag(watershed(ndi.gaussian_filter(b["pb"], 1.0), 0.004),
                      contour_only=False)
    ub, vb, sb, cb = md.edge_mean_arrays(rag_b, b["pb"])
    np.savez(path, u=u, v=v, s=s, c=c, h=h, sizes=rag.sizes,
             R=rag.n_regions, ub=ub, vb=vb, sb=sb, cb=cb,
             Rb=rag_b.n_regions)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--inputs", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".build",
        "merge_steady_state_inputs.npz"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("merge_steady_state: no CUDA device", file=sys.stderr)
        return 1
    import glia_tpu_torch.graph.merge_device as md

    dev = torch.device("cuda")
    if not os.path.exists(args.inputs):
        os.makedirs(os.path.dirname(os.path.abspath(args.inputs)),
                    exist_ok=True)
        make_inputs(md, args.inputs)
    x = np.load(args.inputs)

    def idx(a):
        return torch.as_tensor(a, device=dev).long()

    def val(a):
        return torch.as_tensor(a, device=dev).float()

    u, v, s, c, h = idx(x["u"]), idx(x["v"]), val(x["s"]), val(x["c"]), \
        val(x["h"])
    sizes, R = x["sizes"], int(x["R"])
    ub, vb, sb, cb, Rb = idx(x["ub"]), idx(x["vb"]), val(x["sb"]), \
        val(x["cb"]), int(x["Rb"])
    kw = dict(mode="fused_ms", device=dev)
    cases = {
        "1024_mean": lambda: md.merge_batched_device(u, v, s, c, R, **kw),
        "1024_median": lambda: md.merge_batched_device_hist(u, v, h, R,
                                                            **kw),
        "1024_median_minsize": lambda: md.merge_batched_device_hist_minsize(
            u, v, h, sizes, R, **kw),
        "1024_exact": lambda: md.merge_batched_device_exact(u, v, s, c, R,
                                                            device=dev),
        "4096_exact": lambda: md.merge_batched_device_exact(ub, vb, sb, cb,
                                                            Rb, device=dev),
    }

    def walls_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t))
        return out

    graphs = hasattr(md, "plan_graph_info")
    res = {"tag": args.tag, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in cases.items():
        w = walls_ms(fn, args.reps + 3)
        line = {"first3_ms": w[:3], "median_ms": float(np.median(w[3:])),
                "min_ms": min(w[3:]), "max_ms": max(w[3:])}
        if graphs:
            line.update(eager_program(md, name, dev, walls_ms, args.reps,
                                      (u, v, s, c, h, sizes, R),
                                      (ub, vb, sb, cb, Rb)))
        res[name] = line
    if graphs:
        res["graphs"] = md.plan_graph_info()
    print(json.dumps(res), flush=True)
    return 0


def eager_program(md, name, dev, walls_ms, reps, small, big):
    """The memoized plan of case ``name`` run as its plan program eagerly
    on the card (what the CUDA graph captures)."""
    import torch

    u, v, s, c, h, sizes, R = small
    if name == "4096_exact":
        u, v, s, c, R = big
    stat = {"1024_median": md._hist_stat(0.0, 1.0),
            "1024_median_minsize": md._minsize_stat(0.0, 1.0)}.get(
                name, md._mean_stat_packed)
    if name == "1024_median":
        inputs = (u, v, (h,), ())
    elif name == "1024_median_minsize":
        inputs = md._initial_state(u, v, (h,), sizes, R, torch.float32, dev)
    else:
        inputs = (u, v, (torch.stack([s, c], 1),), ())
    (key,) = [k for k in md._PLAN_MEMO if k[0] == len(u) and k[1] == R
              and k[2] is stat]
    E, _, _, _, dmax, dt, with_vsz = key
    sal_L = (md._EXACT_SAL_L[(E, max(R - 1, 1), R, dt)]
             if name.endswith("exact") else None)
    plan = md._PLAN_MEMO[key]
    args = (tuple(plan.phases), stat, R, dmax, 256, torch.float32, with_vsz,
            plan.last_steps)

    def run():
        md._plan_program(*args, *inputs, sal_L=sal_L)[-1].tolist()

    w = walls_ms(run, reps + 2)[2:]
    return {"eager_program_median_ms": float(np.median(w))}


if __name__ == "__main__":
    sys.exit(main())
