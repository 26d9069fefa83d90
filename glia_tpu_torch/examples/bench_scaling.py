"""Scaling of the full-width halo train step with the number of ranks
(counterpart of the repository's tools/bench_scaling.py).

    python -m glia_tpu_torch.examples.bench_scaling [side] [n_cells]
        [--device cpu]

Defaults 512, 900 cells: ``synthetic_em_slice((side, side), n_cells,
seed=9, blur=1.2, noise=0.12)``, its watershed at 0.004 and RAG, random
edge labels (``default_rng(0)``).  For each of 1, 2, 4 and 8 shards the
RAG is edge-partitioned (``partition_rag``, ``HaloPlan``), and the halo
train step (2 images, 32 boundary pixels, 16 bins) runs on that many
``spawn_ranks`` ranks, each sent its own block of the inputs: a first
step, then ITERS steps timed to their end on the device.  The ranks are
gloo ranks: on the card they share it (NCCL refuses two ranks on one
GPU), with ``--device cpu`` they are CPU processes, the counterpart of
the tool's virtual CPU mesh.  So the curve shows partition balance,
traffic and collectives, not the speed of more cards.  Per world the
tool's keys, plus the first step's loss, which is the same in every
world (one set of weights, one loss over every edge).  Prints the rows
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .snemi import log

WORLDS = (1, 2, 4, 8)
ITERS = 10
K_PIXELS, N_BINS = 32, 16
TIMEOUT_S = 600.0


def scaling_rank(mesh, plan, n_regions, block):
    """One rank: its batch, a first halo train step, then ITERS steps
    timed to their end on the device.  Returns the seconds a step, the
    first step's loss, the widths and the rank's kernel launches."""
    from ..device import synchronize
    from ..ops import cuda as kcuda
    from ..parallel.train import halo_train_batch, make_halo_train_step

    kcuda.reset_launches()
    batch = halo_train_batch(mesh, block)
    init, step, (edge_w, D) = make_halo_train_step(
        mesh, plan, n_regions, n_images=2, k_pixels=K_PIXELS, n_bins=N_BINS)
    w, opt = init()
    w, opt, loss = step(w, opt, batch)
    first_loss = float(loss)
    synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        w, opt, loss = step(w, opt, batch)
    float(loss)
    synchronize(mesh.device)
    return {"step_s": (time.perf_counter() - t0) / ITERS,
            "loss_first": first_loss, "edge_w": edge_w, "D": D,
            "launches": dict(kcuda.launches)}


def scaling_section(side: int, n_cells: int):
    """(section dict, RAG) of the tool's section."""
    from ..bench import bench_section

    data, _, rag = bench_section(side, n_cells, seed=9)
    return data, rag


def bench_scaling(side: int = 512, n_cells: int = 900, worlds=WORLDS,
                  device=None, timeout_s: float = TIMEOUT_S) -> list:
    """One row a world in ``worlds``, the ranks on ``device`` (the CUDA
    card by default).  A row has the tool's keys (unrounded), then
    ``loss_first``, ``launches`` (summed over the ranks) and
    ``spawn_wall_s``."""
    from ..device import resolve_device
    from ..parallel.halo import HaloPlan
    from ..parallel.launch import spawn_ranks
    from ..parallel.partition import partition_rag
    from ..parallel.train import halo_rank_block, halo_train_host_inputs

    dev = resolve_device(device)
    data, rag = scaling_section(side, n_cells)
    labels = np.random.default_rng(0).integers(0, 2, rag.n_edges).astype(
        np.float32)
    images = [data["pb"], data["intensity"]]
    log(f"RAG: {rag.n_regions} regions, {rag.n_edges} edges")
    rows = []
    for n in worlds:
        part = partition_rag(rag, n)
        plan = HaloPlan(part, rag)
        host = halo_train_host_inputs(plan, part, rag, images, labels,
                                      K_PIXELS)
        blocks = [(halo_rank_block(host, r),) for r in range(n)]
        t0 = time.perf_counter()
        res = spawn_ranks(scaling_rank, n, "gloo",
                          "cpu" if dev.type == "cpu" else "cuda",
                          args=(plan, rag.n_regions), rank_args=blocks,
                          timeout_s=timeout_s)
        spawn_s = time.perf_counter() - t0
        dt = res[0]["step_s"]
        dense_rows = n * rag.n_regions
        launches = {}
        for r in res:
            for k, c in r["launches"].items():
                launches[k] = launches.get(k, 0) + c
        rows.append({
            "shards": n, "step_ms": dt * 1e3,
            "edges_per_s": rag.n_edges / dt,
            "cut_fraction": part.cut_fraction, "balance": part.balance(),
            "halo_rows": plan.comm_rows, "dense_rows": dense_rows,
            "comm_ratio_vs_dense": plan.comm_rows / max(dense_rows, 1),
            "feat_dim": res[0]["D"], "loss_first": res[0]["loss_first"],
            "launches": launches, "spawn_wall_s": spawn_s})
        log({k: rows[-1][k] for k in ("shards", "step_ms", "edges_per_s",
                                      "halo_rows", "loss_first")})
    base = rows[0]["edges_per_s"]
    for r in rows:
        r["efficiency_vs_1shard"] = r["edges_per_s"] / (base * r["shards"])
        # the ranks share one host (and here one card), so also the
        # wall-clock speedup against the first world
        r["speedup"] = r["edges_per_s"] / base
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=512)
    ap.add_argument("n_cells", nargs="?", type=int, default=900)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = bench_scaling(args.side, args.n_cells, device=args.device)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
