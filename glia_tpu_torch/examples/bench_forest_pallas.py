"""Kernel B1, the forest vote walk, against the plain walk on one batch
(counterpart of the repository's tools/bench_forest_pallas.py, whose
``xla`` and ``pallas`` walks are here ``plain`` and ``cuda``).

    python -m glia_tpu_torch.examples.bench_forest_pallas [B] [T] [D]
        [plain|cuda|both] [--device cpu]

Defaults 8192 samples, 120 trees, 96 features, both walks.  The forest is
the port's CART (``models.forest.train_forest``, seed 0) on 4,000 random
rows whose label is a noisy linear rule of the first three features, as
the tool trains it; the batch is ``default_rng(0)``'s next B x D uniform
rows.  For each walk: a first call (its ``compile_s``: on the card the
kernel's build and first launch), the first 256 rows held to the host
walk ``predict_votes_np`` (vote fractions more than the tool's 1e-5
apart count as mismatches), then ITERS calls timed to their end on the
device: ms a call, samples/s and tree walks/s.  ``plain`` is
``forest_votes_torch`` on ``device``; ``cuda`` is
``ops.cuda.forest_votes_cuda`` and needs the card.  Prints the results
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .snemi import log

ITERS = 20
CHECK_ROWS = 256
CHECK_ATOL = 1e-5
WALKS = ("plain", "cuda")


def forest_case(B: int, T: int, D: int):
    """(forest, batch [B, D] float32) as the tool makes them."""
    from ..models.forest import train_forest

    rng = np.random.default_rng(0)
    Xtr = rng.random((4000, D)).astype(np.float32)
    ytr = (Xtr[:, 0] + 0.5 * Xtr[:, 1] - 0.2 * Xtr[:, 2]
           + 0.1 * rng.standard_normal(4000) > 0.65).astype(np.int32)
    model = train_forest(Xtr, ytr, n_trees=T, seed=0, n_jobs=-1)
    return model, rng.random((B, D)).astype(np.float32)


def bench_forest(B: int = 8192, T: int = 120, D: int = 96,
                 which: str = "both", device=None) -> dict:
    """Both walks (or the one ``which`` names) on ``device`` (the CUDA card
    by default).  Returns {"B", "T", "D", "depth", and per walk
    {"compile_s", "mismatches", "ms_per_iter", "samples_per_s",
    "tree_walks_per_s"}}, with ``cuda_over_plain`` when both ran."""
    import torch

    from ..device import resolve_device, synchronize
    from ..models.forest import (ForestTables, forest_votes_torch,
                                 predict_votes_np)
    from ..ops.cuda import forest_votes_cuda

    if which not in (*WALKS, "both"):
        raise ValueError(f"walk {which!r} (plain|cuda|both)")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model, X = forest_case(B, T, D)
    log(f"forest: {T} trees, {model.feature.shape[1]} max nodes, depth "
        f"{model.max_depth} (trained {time.perf_counter() - t0:.1f}s)")
    want = predict_votes_np(model, X[:CHECK_ROWS])
    tables = ForestTables.from_model(model, dev)
    Xd = torch.as_tensor(X, device=dev)
    walks = {"plain": forest_votes_torch, "cuda": forest_votes_cuda}
    out = {"B": B, "T": T, "D": D, "depth": int(model.max_depth),
           "device": str(dev)}
    for name in WALKS:
        if which not in ("both", name):
            continue
        fn = walks[name]
        t0 = time.perf_counter()
        votes = fn(Xd, tables)
        synchronize(dev)
        compile_s = time.perf_counter() - t0
        got = votes[:CHECK_ROWS, : want.shape[1]].cpu().numpy()
        mismatches = int((np.abs(got - want) > CHECK_ATOL).sum())
        t0 = time.perf_counter()
        for _ in range(ITERS):
            votes = fn(Xd, tables)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / ITERS
        out[name] = {"compile_s": compile_s, "mismatches": mismatches,
                     "ms_per_iter": dt * 1e3, "samples_per_s": B / dt,
                     "tree_walks_per_s": B * T / dt}
        log(f"{name:6s}: compile {compile_s:6.2f}s, {dt * 1e3:8.3f} ms/iter,"
            f" {B / dt:,.0f} samples/s ({B * T / dt:,.0f} tree-walks/s), "
            f"{mismatches} mismatches in {CHECK_ROWS} rows")
    if "plain" in out and "cuda" in out:
        out["cuda_over_plain"] = (out["cuda"]["samples_per_s"]
                                  / out["plain"]["samples_per_s"])
        log(f"cuda/plain speedup: {out['cuda_over_plain']:.2f}x")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=8192)
    ap.add_argument("T", nargs="?", type=int, default=120)
    ap.add_argument("D", nargs="?", type=int, default=96)
    ap.add_argument("which", nargs="?", default="both",
                    choices=(*WALKS, "both"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = bench_forest(args.B, args.T, args.D, args.which, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
