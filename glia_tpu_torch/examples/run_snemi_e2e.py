"""BASELINE config #5 end to end at SNEMI3D scale (counterpart of the
repository's tools/run_snemi_e2e.py, stage for stage):

  generate -> watershed supervoxels -> RAG (~1.2M regions / 1.4M edges
  at 100 x 1024 x 1024) -> truth-derived edge labels -> sharded halo
  training of the edge classifier -> full-width edge scoring ->
  classifier-guided sharded merge-tree construction -> sharded exact
  saliencies -> threshold cuts -> VI / adapted Rand against the truth.

    python -m glia_tpu_torch.examples.run_snemi_e2e [Z] [side] [n_cells]
        [shards] [steps] [--device cpu]

Defaults: 100, 1024, 400 cells, one shard a visible card (1 on the
CPU), 40 steps; environment switches ``GLIA_WS_LEVEL`` (watershed level,
0.01) and ``GLIA_E2E_HOST_CHECK`` (the voxel-level host oracle at tau
0.7).  ``snemi_e2e`` returns the result dict; ``main`` prints it as one
JSON line with the tool's keys.

The merge statistic is the boundary-pixel-weighted mean of (1 - p_merge)
over the spliced boundary (additive payload s = (1 - p) * cnt, c = cnt);
the cut at tau merges what the classifier scores above 1 - tau after
the exact saliency replay.

Where each stage runs: the volume, the labels and the pair table on the
host; the train step and then the merge with its exact saliencies in
``spawn_ranks`` ranks (``shards`` of them: NCCL when every rank has a
card, gloo otherwise); the scoring (``edge_forward_full``) and the pair
metrics (``metrics.device``) on ``device`` in this process.  What a rank
receives: for training, its block of the halo step's inputs
(``halo_rank_block``: boundary pixels of both images, mask, endpoints,
labels, routing rows; at SNEMI scale and one rank about 0.45 GB) and the
halo plan (about 10 MB); for the merge, the endpoints and the float64
payload of every edge, which ``merge_batched_sharded`` takes whole on
each rank (1.41M edges: 34 MB).  No rank receives the volume.

The merge and the replay run in float64, the tool's dtype (it runs
with ``jax_enable_x64``): at SNEMI scale the pooled boundary counts pass
2**24.  The scoring weights stay float32, as glia_tpu's.  glia_tpu's
sharded gradient is ``shards`` times the true one (ROADMAP F5, copied),
so under the step's global-norm clip the weights, and VI, depend on the
shard count.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from .snemi import (card_peak_gb, edge_labels, log, make_volume, peak_gb,
                    resolve_components)

K_PIXELS, N_BINS, N1, N2 = 32, 16, 64, 16
LR = 3e-3
DMAX, MAX_SUPERSTEPS = 4, 64
TAUS = (0.3, 0.5, 0.7)
HOST_CHECK_TAU = 0.7
# the voxel-level oracle against the pair-table metrics
HOST_CHECK_TOL = 1e-9
TIMEOUT_S = 3000.0


def _launches():
    from ..ops import cuda as kcuda

    return dict(kcuda.launches)


def _reset(device, peak=True):
    """Launch counts to 0, and with ``peak`` the card's peak memory."""
    from ..ops import cuda as kcuda

    kcuda.reset_launches()
    if peak and device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)


def train_rank(mesh, cfg, block):
    """One rank of the sharded training: its batch on the card, then
    ``cfg["steps"]`` clipped-Adam steps of the halo step from
    ``mlp2_init``.  Returns the losses of every step, rank 0's weights,
    seconds, launches and the card's peak."""
    from ..device import synchronize
    from ..parallel.train import halo_train_batch, make_halo_train_step

    _reset(mesh.device)
    t0 = time.perf_counter()
    batch = halo_train_batch(mesh, block)
    init, step, _ = make_halo_train_step(
        mesh, cfg["plan"], cfg["R"], n_images=2, k_pixels=K_PIXELS,
        n_bins=N_BINS, n1=N1, n2=N2, lr=LR)
    w, opt = init()
    synchronize(mesh.device)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = []
    for _ in range(cfg["steps"]):
        w, opt, loss = step(w, opt, batch)
        losses.append(float(loss))
    synchronize(mesh.device)
    return {"w": w.detach().cpu().numpy() if mesh.rank == 0 else None,
            "losses": losses, "inputs_s": inputs_s,
            "train_s": time.perf_counter() - t0, "launches": _launches(),
            "card_peak_gb": card_peak_gb(mesh.device)}


def merge_rank(mesh, case):
    """One rank of the sharded merge (float64) and of the exact
    saliencies of its order.  Returns rank 0's rows and saliencies, the
    merge stats, seconds, launches of each stage and the card's peak."""
    import torch

    from ..device import synchronize
    from ..parallel.merge_shard import (exact_saliency_sharded,
                                        merge_batched_sharded)

    u, v, s, c, R = (case[k] for k in ("u", "v", "s", "c", "R"))
    out = {"launches": {}}
    _reset(mesh.device)
    t0 = time.perf_counter()
    stats = {}
    order, _, n_m = merge_batched_sharded(
        u, v, s, c, R, mesh, dmax=DMAX, max_supersteps=MAX_SUPERSTEPS,
        dtype=torch.float64, stats=stats)
    rows = order[:n_m].cpu().numpy()
    synchronize(mesh.device)
    out["merge_s"] = time.perf_counter() - t0
    out["launches"]["merge"] = _launches()
    _reset(mesh.device, peak=False)
    t0 = time.perf_counter()
    exact = exact_saliency_sharded(u, v, s, c, rows, R, mesh,
                                   dtype=torch.float64)
    out["replay_s"] = time.perf_counter() - t0
    out["launches"]["replay"] = _launches()
    first = mesh.rank == 0
    out.update(rows=rows if first else None, n=n_m, stats=stats,
               exact=exact if first else None,
               card_peak_gb=card_peak_gb(mesh.device))
    return out


def _edge_pixels(vol):
    """px [E, 2, K] and mask [E, K] of both images, edge order."""
    from ..ops.pack import pack_csr_values

    px_imgs, mask = [], None
    for img in (vol.pb, vol.intensity):
        flat = np.asarray(img, np.float32).ravel()
        vals, mask = pack_csr_values(flat[vol.rag.edge_pixels],
                                     vol.rag.edge_ptr, K_PIXELS)
        px_imgs.append(vals)
    return np.stack(px_imgs, axis=1), mask


def score_edges(vol, w, device):
    """Merge probabilities [E] (float32) of every edge by the full-width
    single-process forward (``edge_forward_full``) with weights ``w``."""
    import torch

    from ..parallel.train import edge_forward_full

    px, mask = _edge_pixels(vol)
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)  # noqa
    with torch.no_grad():
        probs = edge_forward_full(
            t(w, torch.float32), t(vol.ui, torch.int64),
            t(vol.vi, torch.int64), t(px, torch.float32),
            t(mask, torch.float32),
            torch.ones(vol.rag.n_edges, dtype=torch.float32, device=device),
            vol.rag.n_regions, n_bins=N_BINS, n1=N1, n2=N2)
    return probs.cpu().numpy()


def eval_pairs(comp_of_region, pairs, T, device):
    """Scores of the segmentation whose regions join into components
    ``comp_of_region`` from the region-truth pair table: the cells summed
    on ``device`` (``cell_counts_device``) and held to the host's int64
    counts, exactly, or AssertionError; then the sparse-pair VI and
    adapted Rand on ``device``.  Returns (vi_split, vi_merge, vi,
    precision, recall, rand_error, S)."""
    from ..metrics.device import (adapted_rand_from_pairs_device,
                                  cell_counts_device, vi_from_pairs_device)

    rt_regs, rt_labs, rt_cnt = pairs
    keep = rt_labs != 0                          # truth BG excluded
    comp = comp_of_region[rt_regs[keep]]
    lab = rt_labs[keep]
    c_host = rt_cnt[keep]
    uc, sid = np.unique(comp, return_inverse=True)
    S = len(uc)
    # host exact aggregation (int64), the yardstick of the device's
    agg_host = np.bincount(sid * T + lab, weights=c_host,
                           minlength=S * T).astype(np.int64)
    agg_dev = cell_counts_device(sid, lab, c_host, S, T,
                                 device=device).cpu().numpy()
    if not np.array_equal(agg_dev.astype(np.int64), agg_host):
        raise AssertionError("device pair counts != host int64 counts")
    nz = np.nonzero(agg_host)[0]
    del agg_dev
    sidn = (nz // T).astype(np.int32)
    tidn = (nz % T).astype(np.int32)
    cn = agg_host[nz]
    del agg_host
    fs, fm, vi = (float(x) for x in vi_from_pairs_device(
        sidn, tidn, cn, S, T, itk_quirk=True, device=device))
    pr, rc, er = (float(x) for x in adapted_rand_from_pairs_device(
        sidn, tidn, cn, S, T, device=device))
    return fs, fm, vi, pr, rc, er, S


def snemi_e2e(vol, shards: Optional[int] = None, steps: int = 40,
              device=None, host_check: bool = False,
              timeout_s: float = TIMEOUT_S, train_fn=train_rank,
              merge_fn=merge_rank, arrays: Optional[dict] = None) -> dict:
    """The chain after the volume stage on ``vol`` (``snemi.make_volume``).

    ``shards``: ranks of the sharded stages (default one a visible card,
    1 on the CPU).  ``host_check``: also score the cut at tau 0.7 voxel
    by voxel on the host (``eval_vi`` / ``eval_ri``); a gap above
    HOST_CHECK_TOL to the pair-table VI or adapted Rand error raises.
    ``train_fn`` / ``merge_fn``: what each rank runs (``train_rank``,
    ``merge_rank``, or a wrapper of it that adds keys to its result).
    ``arrays`` (optional dict) receives the arrays of the run: labels,
    the weights, probabilities, the merge payload (u, v, s, c), rows,
    exact saliencies and okeys, and the ranks' own results
    (``train_ranks``, ``merge_ranks``).  Returns the result dict: the
    tool's keys, unrounded, plus the port's (backend, launches by stage,
    seconds inside the ranks, peaks)."""
    import torch

    from ..device import resolve_device, synchronize
    from ..dryrun import default_backend
    from ..graph.merge_device import order_to_keys, threshold_cut
    from ..parallel.halo import HaloPlan
    from ..parallel.launch import spawn_ranks
    from ..parallel.partition import partition_rag
    from ..parallel.train import halo_rank_block, halo_train_host_inputs

    dev = resolve_device(device)
    if shards is None:
        shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    backend = default_backend(shards, dev)
    rank_dev = "cpu" if dev.type == "cpu" else "cuda"
    rag, R, E = vol.rag, vol.rag.n_regions, vol.rag.n_edges
    stages = {k: vol.stages[k] for k in ("generate", "watershed",
                                         "build_rag")}
    launches, card_peaks = {}, {}

    # ---- truth-derived edge labels (merge iff same majority body) ----
    t0 = time.perf_counter()
    labels, pairs = edge_labels(vol)
    stages["labels"] = time.perf_counter() - t0
    log(f"edge labels: {labels.mean():.3f} merge fraction "
        f"({stages['labels']:.1f}s)")

    # ---- sharded training ----
    t0 = time.perf_counter()
    part = partition_rag(rag, shards)
    plan = HaloPlan(part, rag)
    host = halo_train_host_inputs(plan, part, rag, [vol.pb, vol.intensity],
                                  labels, K_PIXELS)
    blocks = [(halo_rank_block(host, r),) for r in range(shards)]
    del host
    stages["partition_shard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = spawn_ranks(train_fn, shards, backend, rank_dev,
                     args=({"plan": plan, "R": R, "steps": steps},),
                     rank_args=blocks, timeout_s=timeout_s)
    del blocks
    wall = time.perf_counter() - t0
    stages["train"] = tr[0]["train_s"]
    stages["train_ranks"] = wall - tr[0]["train_s"]
    launches["train"] = _sum_launches(r["launches"] for r in tr)
    card_peaks["train"] = [r["card_peak_gb"] for r in tr]
    losses = tr[0]["losses"]
    loss_trace = [losses[i] for i in range(steps)
                  if i % 10 == 0 or i == steps - 1]
    log(f"sharded training {steps} steps on {shards} ranks ({backend}): "
        f"loss {loss_trace} ({stages['train']:.1f}s in the ranks, "
        f"{wall:.1f}s spawn wall)")

    # ---- full-width edge scoring (same features as the halo step) ----
    _reset(dev)
    t0 = time.perf_counter()
    probs = score_edges(vol, tr[0]["w"], dev)
    synchronize(dev)
    stages["score"] = time.perf_counter() - t0
    launches["score"] = _launches()
    card_peaks["score"] = card_peak_gb(dev)
    edge_acc = float(((probs > 0.5) == (labels > 0.5)).mean())
    log(f"edge scoring: acc@0.5 {edge_acc:.3f} ({stages['score']:.1f}s)")

    # ---- classifier-guided sharded merge and exact saliencies ----
    cnt = np.diff(rag.edge_ptr).astype(np.float64)
    s_arr = (1.0 - probs.astype(np.float64)) * cnt
    t0 = time.perf_counter()
    mr = spawn_ranks(merge_fn, shards, backend, rank_dev,
                     args=({"u": vol.ui, "v": vol.vi, "s": s_arr, "c": cnt,
                            "R": R},), timeout_s=timeout_s)
    wall = time.perf_counter() - t0
    m0 = mr[0]
    n_m, mstats = m0["n"], m0["stats"]
    stages["sharded_merge"] = m0["merge_s"]
    stages["replay"] = m0["replay_s"]
    stages["merge_ranks"] = wall - m0["merge_s"] - m0["replay_s"]
    for stage in ("merge", "replay"):
        launches[stage] = _sum_launches(r["launches"][stage] for r in mr)
    card_peaks["merge"] = [r["card_peak_gb"] for r in mr]
    rows, ex = m0["rows"], m0["exact"]
    log(f"sharded merge: {n_m} merges, {mstats['n_supersteps']} "
        f"supersteps, routed {mstats['routed_rows']} (moved "
        f"{mstats['moved_rows']}), C={mstats['capacity']} "
        f"({stages['sharded_merge']:.1f}s); exact saliencies "
        f"{stages['replay']:.1f}s")
    t0 = time.perf_counter()
    okeys = order_to_keys(rows, n_m, rag)
    stages["replay"] += time.perf_counter() - t0

    # ---- evaluation from the one region-truth pair table ----
    _reset(dev)
    t0 = time.perf_counter()
    _, rt_labs, rt_cnt = pairs
    if int(rt_cnt.sum()) != int(vol.truth.size):
        raise AssertionError("the pair table does not cover every voxel")
    n_keys = int(okeys[:, 2].max(initial=int(rag.keys.max()))) + 1
    T = int(rt_labs.max()) + 1
    keys = rag.keys.astype(np.int64)
    _, _, vi0, _, _, e0, S0 = eval_pairs(keys, pairs, T, dev)
    cuts = []
    for tau in TAUS:
        m = threshold_cut(okeys, ex, tau)
        comp = resolve_components(okeys, m, keys, n_keys)
        fs, fm, vi_t, _, _, er, S_t = eval_pairs(comp, pairs, T, dev)
        cuts.append({"tau": tau, "n_merged": int(m.sum()), "vi": vi_t,
                     "vi_split": fs, "vi_merge": fm, "rand_error": er,
                     "n_segments": S_t})
        log(f"tau {tau}: VI {vi_t:.4f} (ws {vi0:.4f}), ARE {er:.4f} "
            f"(ws {e0:.4f}), {int(m.sum())} merges, {S_t} regions")
    synchronize(dev)
    stages["cut_eval"] = time.perf_counter() - t0
    launches["eval"] = _launches()
    card_peaks["eval"] = card_peak_gb(dev)
    log(f"pair-table eval (device sparse metrics): "
        f"{stages['cut_eval']:.1f}s for watershed + {len(TAUS)} taus")

    check = None
    if host_check:
        check = host_oracle(vol, okeys, ex, cuts[TAUS.index(HOST_CHECK_TAU)])
        stages["host_check"] = check["seconds"]

    Z, side, _ = vol.shape
    out = {
        "config": f"SNEMI-scale e2e {Z}x{side}x{side} @ {shards}",
        "voxels": int(vol.pb.size), "regions": int(R), "edges": int(E),
        "shards": shards, "backend": backend,
        "device": str(dev), "train_steps": steps, "loss_trace": loss_trace,
        "losses": losses, "edge_acc": edge_acc,
        "watershed_vi": vi0, "watershed_rand_error": e0,
        "watershed_segments": S0, "cuts": cuts,
        "merges": int(n_m),
        "merge_stats": {k: int(v) for k, v in mstats.items()},
        "stages_s": stages, "wall_s": sum(stages.values()),
        "rank_s": {"train_inputs": tr[0]["inputs_s"]},
        "peak_rss_gb": peak_gb(),
        "card_peak_gb": card_peaks, "launches": launches,
        "host_check": check,
    }
    if arrays is not None:
        arrays.update(labels=labels, w=tr[0]["w"], probs=probs, u=vol.ui,
                      v=vol.vi, s=s_arr, c=cnt, rows=rows, exact=ex,
                      okeys=okeys, train_ranks=tr, merge_ranks=mr)
    return out


def host_oracle(vol, okeys, ex, cut):
    """The cut at HOST_CHECK_TAU scored voxel by voxel on the host
    (``apply_merge_order``, ``eval_vi``, ``eval_ri``) against the
    pair-table row ``cut``; AssertionError past HOST_CHECK_TOL."""
    from ..graph.merge import apply_merge_order
    from ..graph.merge_device import threshold_cut
    from ..metrics import eval_ri, eval_vi

    t0 = time.perf_counter()
    m = threshold_cut(okeys, ex, HOST_CHECK_TAU)
    seg_t = apply_merge_order(vol.seg, okeys[m])
    _, _, hvi = eval_vi(seg_t, vol.truth)
    _, _, her = eval_ri(seg_t, vol.truth)
    res = {"tau": HOST_CHECK_TAU, "vi": hvi, "rand_error": her,
           "vi_gap": abs(hvi - cut["vi"]),
           "rand_error_gap": abs(her - cut["rand_error"]),
           "seconds": time.perf_counter() - t0}
    log(f"HOST CHECK tau {HOST_CHECK_TAU}: VI {hvi!r} vs pairs "
        f"{cut['vi']!r}, ARE {her!r} vs {cut['rand_error']!r}")
    if max(res["vi_gap"], res["rand_error_gap"]) > HOST_CHECK_TOL:
        raise AssertionError(f"the voxel-level oracle differs from the "
                             f"pair-table metrics: {res}")
    return res


def _sum_launches(per_rank):
    out = {}
    for counts in per_rank:
        for k, n in counts.items():
            out[k] = out.get(k, 0) + n
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("Z", nargs="?", type=int, default=100)
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("n_cells", nargs="?", type=int, default=400)
    ap.add_argument("shards", nargs="?", type=int, default=None,
                    help="ranks (default: one a visible card, 1 on the "
                         "CPU)")
    ap.add_argument("steps", nargs="?", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)
    vol = make_volume(args.Z, args.side, args.n_cells)
    out = snemi_e2e(vol, args.shards, args.steps, dev,
                    host_check=bool(os.environ.get("GLIA_E2E_HOST_CHECK")))
    log(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
