"""BASELINE config #5's partition and halo counters at SNEMI3D scale, and
the steady time of the halo train step (counterpart of the repository's
tools/run_snemi_sharded.py).

    python -m glia_tpu_torch.examples.run_snemi_sharded [Z] [side]
        [n_cells] [shards] [--device cpu]

A synthetic 100 x 1024 x 1024 volume by default (``snemi.make_volume``),
its RAG edge-partitioned over ``shards`` (8) shards: ``partition_rag``
and ``HaloPlan`` are host numpy, so the cut fraction, balance and halo
rows are glia_tpu's for the same shard count.  Then the full-width halo
train step (random labels, seed 0) runs on ``world`` ranks of its own
partition: one rank per visible card (NCCL, each on its card), 1 on the
CPU.  ``edges_per_s`` is E over the median of the steady steps (the
BASELINE metric "RAG aggregation edges/s/chip" at world 1).  A rank is
sent its own block of the step's inputs
(``parallel.train.halo_rank_block``): at SNEMI scale and world 1 about
0.45 GB, the boundary pixels of both images (361 MB) dominating.

Prints one JSON line with the tool's keys, plus ``world``, ``backend``,
``steps_s`` (each steady step) and the card's peak in the ranks.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .snemi import card_peak_gb, log, make_volume, peak_gb

K_PIXELS, N_BINS = 32, 16
STEADY_STEPS = 3
TIMEOUT_S = 3000.0


def step_rank(mesh, plan, n_regions, block):
    """One rank: its batch on the device (the block uploaded, its orders
    of addition sorted once), a first halo train step (CUDA start, the
    kernel's first load), then STEADY_STEPS steps, each timed to its end
    on the device."""
    import torch

    from ..device import synchronize
    from ..parallel.train import halo_train_batch, make_halo_train_step

    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    batch = halo_train_batch(mesh, block)
    synchronize(mesh.device)
    batch_s = time.perf_counter() - t0
    init, step, (edge_w, D) = make_halo_train_step(
        mesh, plan, n_regions, n_images=2, k_pixels=K_PIXELS, n_bins=N_BINS)
    w, opt = init()
    t0 = time.perf_counter()
    w, opt, loss = step(w, opt, batch)
    first_loss = float(loss)
    first_s = time.perf_counter() - t0
    steps_s = []
    for _ in range(STEADY_STEPS):
        t0 = time.perf_counter()
        w, opt, loss = step(w, opt, batch)
        synchronize(mesh.device)
        steps_s.append(time.perf_counter() - t0)
    return {"batch_s": batch_s, "first_s": first_s, "steps_s": steps_s,
            "loss_first": first_loss, "loss_after": float(loss),
            "edge_w": edge_w, "D": D, "E_max": batch["E_max"],
            "card_peak_gb": card_peak_gb(mesh.device)}


def snemi_sharded(vol, shards=8, device=None, timeout_s=TIMEOUT_S) -> dict:
    """The counters of ``shards`` shards and the halo step's time on one
    rank a visible card (1 on the CPU) for the volume ``vol``
    (``snemi.make_volume``); returns the result dict."""
    import torch

    from ..device import resolve_device
    from ..dryrun import default_backend
    from ..parallel.halo import HaloPlan
    from ..parallel.launch import spawn_ranks
    from ..parallel.partition import partition_rag
    from ..parallel.train import halo_rank_block, halo_train_host_inputs

    dev = resolve_device(device)
    world = torch.cuda.device_count() if dev.type == "cuda" else 1
    backend = default_backend(world, dev)
    rag = vol.rag
    E, R = rag.n_edges, rag.n_regions
    stages = {k: vol.stages[k] for k in ("generate", "watershed",
                                         "build_rag")}

    # edge partition + ragged halo plan of the tool's shard count
    t0 = time.perf_counter()
    part = partition_rag(rag, shards)
    plan = HaloPlan(part, rag)
    stages["partition_plan"] = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, E).astype(np.float32)
    t0 = time.perf_counter()
    part_w = partition_rag(rag, world)
    plan_w = HaloPlan(part_w, rag)
    host = halo_train_host_inputs(plan_w, part_w, rag,
                                  [vol.pb, vol.intensity], labels, K_PIXELS)
    blocks = [(halo_rank_block(host, r),) for r in range(world)]
    stages["shard_inputs"] = time.perf_counter() - t0
    log(f"partition: {shards} shards, halo H {plan.H}, comm rows "
        f"{plan.comm_rows}; the step's {world} ranks ({backend}): E_max "
        f"{host['E_max']}/rank ({stages['shard_inputs']:.1f}s, peak "
        f"{peak_gb():.1f}GB)")
    del host

    t0 = time.perf_counter()
    res = spawn_ranks(step_rank, world, backend,
                      "cpu" if dev.type == "cpu" else "cuda",
                      args=(plan_w, R), rank_args=blocks,
                      timeout_s=timeout_s)
    spawn_s = time.perf_counter() - t0
    r0 = res[0]
    stages["rank_batch"] = r0["batch_s"]
    stages["compile_first_step"] = r0["first_s"]
    step_s = float(np.median(r0["steps_s"]))
    stages["steady_step"] = step_s
    edge_w = r0["edge_w"]
    dense_rows = shards * R
    row_bytes = 4 * (1 + edge_w)
    Z, side, _ = vol.shape
    return {
        "config": f"SNEMI-scale sharded {Z}x{side}x{side} @ {shards}",
        "voxels": int(vol.pb.size), "regions": int(R), "edges": int(E),
        "shards": shards, "world": world, "backend": backend,
        "feat_dim": int(r0["D"]), "edge_feat_w": int(edge_w),
        "cut_fraction": part.cut_fraction, "balance": part.balance(),
        "halo_rows": int(plan.comm_rows), "dense_rows": int(dense_rows),
        "comm_ratio_vs_dense": plan.comm_rows / max(dense_rows, 1),
        "halo_bytes_per_step": int(2 * plan.comm_rows * row_bytes),
        "step_s": step_s, "steps_s": r0["steps_s"],
        "edges_per_s": E / step_s,
        "loss_first": r0["loss_first"], "loss_after": r0["loss_after"],
        "stages_s": stages, "wall_s": sum(stages.values()),
        "spawn_wall_s": spawn_s,
        "peak_rss_gb": peak_gb(),
        "rank_card_peak_gb": [r["card_peak_gb"] for r in res],
        "device": str(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("Z", nargs="?", type=int, default=100)
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("n_cells", nargs="?", type=int, default=400)
    ap.add_argument("shards", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)
    vol = make_volume(args.Z, args.side, args.n_cells)
    out = snemi_sharded(vol, args.shards, dev)
    log(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
