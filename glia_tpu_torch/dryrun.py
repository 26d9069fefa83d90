"""Entry points that drive the port's flagship forward and its sharded
path (counterpart of the repository's ``__graft_entry__.py``).

``entry(device)`` -> (fn, example_args): the single-process full-width
edge-scoring forward (boundary-pixel stats -> region-context aggregation
-> MLP2 merge probabilities) on a real 512^2 watershed RAG.

``dryrun_multichip(n_devices, device, backend)`` starts ``n_devices``
ranks (parallel/launch.py) and runs, on a 512^2 RAG partitioned over
them, the halo train step, the sharded merge-tree construction with its
exact saliencies, and the sharded BC tree features scored by a forest;
it holds each against the single-process path, as __graft_entry__'s
dryrun does, and returns what it measured.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .device import DeviceLike, resolve_device, synchronize

N_BINS, N1, N2, K_PIXELS = 16, 64, 16, 32
# halo train steps after the first, which must lower the loss
DRYRUN_STEPS = 10


def _dryrun_section():
    """The 512^2 section of glia_tpu's dryrun, its watershed and RAG."""
    import scipy.ndimage as ndi

    from .data.synthetic import synthetic_em_slice
    from .graph.rag import build_rag
    from .native import watershed_native

    data = synthetic_em_slice((512, 512), n_cells=900, seed=9,
                              blur=1.2, noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    return data, seg, build_rag(seg, contour_only=False)


def _edge_pixels(rag, images):
    """px [E, n_img, K], mask [E, K] of the boundary pixels of each edge."""
    from .ops.pack import pack_csr_values

    px_imgs, mask = [], None
    for img in images:
        flat = np.asarray(img, np.float32).ravel()
        vals, mask = pack_csr_values(flat[rag.edge_pixels], rag.edge_ptr,
                                     K_PIXELS)
        px_imgs.append(vals)
    return np.stack(px_imgs, axis=1), mask


def entry(device: DeviceLike = None):
    """The flagship single-process forward on a real 512^2 watershed RAG
    (the CUDA card unless ``device`` names another): returns (fn, args)
    with fn(w, u, v, px, px_mask, edge_valid) -> probabilities [E]."""
    from .models.mlp import mlp2_init
    from .parallel.train import edge_forward_full, halo_feat_dims

    dev = resolve_device(device)
    data, _, rag = _dryrun_section()
    u = rag.key_index(rag.edges[:, 0])
    v = rag.key_index(rag.edges[:, 1])
    px, mask = _edge_pixels(rag, (data["pb"], data["intensity"]))
    valid = np.ones(rag.n_edges, dtype=np.float32)
    _, D = halo_feat_dims(2, N_BINS)
    w = mlp2_init(D, N1, N2, 0)
    n_regions = rag.n_regions

    def fn(w, u, v, px, px_mask, edge_valid):
        return edge_forward_full(w, u, v, px, px_mask, edge_valid,
                                 n_regions, n_bins=N_BINS, n1=N1, n2=N2)

    as_t = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)  # noqa
    return fn, (as_t(w, torch.float32), as_t(u, torch.int64),
                as_t(v, torch.int64), as_t(px, torch.float32),
                as_t(mask, torch.float32), as_t(valid, torch.float32))


def _merge_labels(rag, pb):
    """Supervision of the dryrun: a weak boundary (below-median mean pb)
    is a merge."""
    vals = np.asarray(pb).ravel()[rag.edge_pixels]
    eids = np.repeat(np.arange(rag.n_edges), np.diff(rag.edge_ptr))
    mean_pb = np.bincount(eids, weights=vals, minlength=rag.n_edges)
    mean_pb /= np.maximum(np.bincount(eids, minlength=rag.n_edges), 1)
    return (mean_pb < np.median(mean_pb)).astype(np.float32)


def _bc_case(n_devices):
    """glia_tpu's dryrun BC case: a 128^2 section, its host merge tree and
    features, a 16-tree forest trained on them, the shard plan and the
    median merge level."""
    import scipy.ndimage as ndi

    from .data.synthetic import synthetic_em_slice
    from .features.config import FeatureConfig
    from .features.hierarchical import TreeFeatures
    from .graph.merge import greedy_merge_order
    from .graph.rag import build_rag
    from .models.forest import train_forest
    from .native import watershed_native
    from .parallel.bc_tree_shard import TreeShardPlan
    from .parallel.partition import partition_rag

    sub = synthetic_em_slice((128, 128), n_cells=36, seed=5)
    seg = watershed_native(ndi.gaussian_filter(sub["pb"], 1.0), 0.01)
    rag = build_rag(seg, contour_only=False)
    cfg = FeatureConfig.standard(sub["pb"], sub["intensity"], n_bins=16)
    order, _ = greedy_merge_order(rag, sub["pb"], policy="mean")
    want = TreeFeatures(rag, order, cfg, saliencies=None).bc_features()
    y = (want[:, 0] > np.median(want[:, 0])).astype(int) * 2 - 1
    model = train_forest(want, y, n_trees=16, seed=0)
    plan = TreeShardPlan(rag, order, cfg, partition_rag(rag, n_devices))
    return want, model, plan, int(np.median(plan.merge_level))


def _counted(fn, device):
    """(fn(), its kernel launches in this process, seconds)."""
    from .ops import cuda as kcuda

    kcuda.reset_launches()
    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, dict(kcuda.launches), time.perf_counter() - t


def _dryrun_rank(mesh, case):
    """One rank of dryrun_multichip: the three sharded stages."""
    from .models.forest import make_label_scorer
    from .parallel.bc_tree_shard import sharded_level_features
    from .parallel.merge_shard import (exact_saliency_sharded,
                                       merge_batched_sharded)
    from .parallel.train import (make_halo_train_step,
                                 shard_halo_train_inputs)

    out = {"launches": {}, "seconds": {}}

    def train():
        init, step, _ = make_halo_train_step(
            mesh, case["plan"], case["rag"].n_regions, n_images=2,
            k_pixels=K_PIXELS, n_bins=N_BINS, n1=N1, n2=N2)
        batch = shard_halo_train_inputs(
            mesh, case["plan"], case["part"], case["rag"], case["images"],
            case["labels"], k_pixels=K_PIXELS, n_bins=N_BINS)
        w, opt = init()
        loss0, g0 = step.loss_and_grad(w, batch)
        losses = []
        for _ in range(1 + DRYRUN_STEPS):
            w, opt, loss = step(w, opt, batch)
            losses.append(float(loss))
        return {"loss0": float(loss0), "grad0": g0.cpu().numpy(),
                "losses": losses}

    def merge():
        stats = {}
        u, v, s, c = case["uvsc"]
        order, sal, n_m = merge_batched_sharded(u, v, s, c, case["R"], mesh,
                                                dmax=4, stats=stats)
        order = order[:n_m].cpu().numpy()
        ex = exact_saliency_sharded(u, v, s, c, order, case["R"], mesh)
        return {"order": order, "sal": sal[:n_m].cpu().numpy(),
                "n_merges": n_m, "exact": ex, "stats": stats}

    def bc():
        scorer = make_label_scorer(case["model"], label=-1,
                                   device=mesh.device)
        _, feats, scores, order_idx = sharded_level_features(
            mesh, case["tplan"], case["level"], scorer=scorer)
        return {"feats": feats, "scores": scores, "order_idx": order_idx}

    for name, fn in (("train", train), ("merge", merge), ("bc", bc)):
        out[name], out["launches"][name], out["seconds"][name] = \
            _counted(fn, mesh.device)
    out["host_staged_bytes"] = mesh.stats["host_staged_bytes"]
    return out


def dryrun_case(n_devices: int):
    """The inputs every rank of dryrun_multichip gets (host data and
    plans: the 512^2 RAG, its partition and halo plan, images, labels,
    the merge arrays, the BC case), the watershed and the host's BC rows
    of the BC case."""
    from .graph.merge_device import edge_mean_arrays
    from .parallel.halo import HaloPlan
    from .parallel.partition import partition_rag

    data, seg, rag = _dryrun_section()
    part = partition_rag(rag, n_devices)
    want, model, tplan, lvl = _bc_case(n_devices)
    case = {"rag": rag, "part": part, "plan": HaloPlan(part, rag),
            "images": (data["pb"], data["intensity"]),
            "labels": _merge_labels(rag, data["pb"]),
            "uvsc": edge_mean_arrays(rag, data["pb"]), "R": rag.n_regions,
            "model": model, "tplan": tplan, "level": lvl}
    return case, seg, want


def default_backend(n_devices: int, device: torch.device) -> str:
    """nccl when every rank has a card of its own, gloo otherwise (ranks
    sharing a card, or on the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return "nccl"
    return "gloo"


def _same_on_every_rank(results, key):
    """Every rank's result of stage ``key`` equals rank 0's."""
    ref = results[0][key]
    for r, res in enumerate(results[1:], start=1):
        for k, val in ref.items():
            got = res[key][k]
            same = (np.array_equal(got, val, equal_nan=True)
                    if isinstance(val, np.ndarray) else got == val)
            if not same:
                raise AssertionError(f"rank {r} returned another {key}.{k} "
                                     "than rank 0")


def _single_process_loss_and_grad(rag, images, labels, w0, dev):
    """Loss and gradient of the full-width forward over every edge in one
    process (edge_forward_full), the yardstick of the halo step."""
    from .parallel.train import _cross_entropy, edge_forward_full

    px, mask = _edge_pixels(rag, images)
    t = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)  # noqa
    u = t(rag.key_index(rag.edges[:, 0]), torch.int64)
    v = t(rag.key_index(rag.edges[:, 1]), torch.int64)
    valid = torch.ones(rag.n_edges, dtype=torch.float32, device=dev)
    w = t(w0, torch.float32).requires_grad_(True)
    p = edge_forward_full(w, u, v, t(px, torch.float32),
                          t(mask, torch.float32), valid, rag.n_regions,
                          n_bins=N_BINS, n1=N1, n2=N2)
    loss = _cross_entropy(p, t(labels, torch.float32), valid).mean()
    (g,) = torch.autograd.grad(loss, w)
    return float(loss.detach()), g.cpu().numpy()


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: str = None, timeout_s: float = 900.0,
                     rank_fn=_dryrun_rank) -> dict:
    """The sharded path on ``n_devices`` ranks, each on ``device`` (the
    CUDA card by default; ranks share the cards when there are fewer;
    ``"cpu"`` for the plain path).  ``backend``: the process group's,
    by default ``default_backend``.  ``rank_fn(mesh, case)``: what each
    rank runs, ``_dryrun_rank`` or a wrapper of it that returns its
    result with keys of its own added.

    On glia_tpu's dryrun RAG (512^2): one halo train step from
    ``mlp2_init`` (loss finite and within 1e-4 of the single-process
    loss; the gradient ``n_devices`` times the single-process gradient
    within 1e-5, glia_tpu's factor, ROADMAP F5) and DRYRUN_STEPS more that
    lower the loss; the sharded merge (rows equal to
    merge_batched_device's, exact saliencies equal to the host replay
    within 1e-6, threshold-cut VI 0); the sharded BC features at the
    median level of a 128^2 section (allclose to TreeFeatures at float32
    tolerance, scores equal to the host walk's).  Every rank must return
    the same results.  Raises AssertionError on any failed check; returns
    a report of the results, seconds and kernel launches per rank, and
    the ranks' own results (``ranks``)."""
    from .graph.merge import apply_merge_order
    from .graph.merge_device import (merge_batched_device, order_to_keys,
                                     replay_exact_saliency, threshold_cut)
    from .metrics import eval_vi
    from .models.forest import predict_votes_np
    from .models.mlp import mlp2_init
    from .parallel.launch import spawn_ranks
    from .parallel.train import halo_feat_dims

    dev = resolve_device(device)
    backend = backend or default_backend(n_devices, dev)
    rank_device = "cpu" if dev.type == "cpu" else "cuda"
    print(f"dryrun_multichip({n_devices}): backend {backend}, ranks on "
          f"{rank_device}", flush=True)
    case, seg, want = dryrun_case(n_devices)
    rag, plan, images, labels = (case["rag"], case["plan"], case["images"],
                                 case["labels"])
    u, v, s, c = case["uvsc"]
    model, lvl = case["model"], case["level"]
    t = time.perf_counter()
    results = spawn_ranks(rank_fn, n_devices, backend, rank_device,
                          args=(case,), timeout_s=timeout_s)
    wall = time.perf_counter() - t
    for key in ("train", "merge", "bc"):
        _same_on_every_rank(results, key)
    res = results[0]

    # ---- halo train step ----
    tr = res["train"]
    loss = tr["losses"][0]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    _, D = halo_feat_dims(2, N_BINS)
    loss1, g1 = _single_process_loss_and_grad(
        rag, images, labels, mlp2_init(D, N1, N2, 0), dev)
    loss_rel = abs(tr["loss0"] - loss1) / abs(loss1)
    grad_rel = float(np.abs(tr["grad0"] - n_devices * g1).max()
                     / np.abs(n_devices * g1).max())
    if loss_rel > 1e-4 or abs(loss - tr["loss0"]) > 0:
        raise AssertionError(f"halo step loss {loss} against the "
                             f"single-process {loss1} (rel {loss_rel})")
    if grad_rel > 1e-5:
        raise AssertionError(f"halo step gradient is not {n_devices} x the "
                             f"single-process gradient (rel {grad_rel})")
    if not tr["losses"][-1] < loss:
        raise AssertionError(f"{DRYRUN_STEPS} steps did not lower the loss: "
                             f"{tr['losses']}")
    print(f"dryrun_multichip({n_devices}): halo train step ok on "
          f"{rag.n_regions}-region/{rag.n_edges}-edge 512^2 RAG, feat "
          f"width {D}, halo rows {plan.comm_rows} (dense would move "
          f"{n_devices * rag.n_regions}), loss={loss:.4f} (single-process "
          f"{loss1:.4f}), gradient {n_devices} x the single-process one "
          f"(rel {grad_rel:.2e}), {DRYRUN_STEPS} more steps -> "
          f"{tr['losses'][-1]:.4f}", flush=True)

    # ---- sharded merge-tree construction ----
    mg = res["merge"]
    n_sh, o_sh = mg["n_merges"], mg["order"]
    o_1c, _, n_1c = merge_batched_device(u, v, s, c, rag.n_regions, dmax=4,
                                         device=dev)
    o_1c = o_1c[:n_1c].cpu().numpy()
    if n_sh != n_1c or not np.array_equal(o_sh, o_1c):
        raise AssertionError(f"sharded merge ({n_sh} merges) differs from "
                             f"the single-process fused engine ({n_1c})")
    ex_host = replay_exact_saliency(u, v, s, c, o_sh)
    okh = np.isfinite(ex_host)
    np.testing.assert_allclose(mg["exact"][okh], ex_host[okh], rtol=1e-6,
                               atol=1e-9)
    tau = float(np.nanpercentile(ex_host, 65.0))
    okeys = order_to_keys(o_sh, n_sh, rag)
    seg_sh = apply_merge_order(seg, okeys[threshold_cut(okeys, ex_host,
                                                        tau)])
    okeys1 = order_to_keys(o_1c, n_1c, rag)
    ex1 = replay_exact_saliency(u, v, s, c, o_1c)
    seg_1c = apply_merge_order(seg, okeys1[threshold_cut(okeys1, ex1, tau)])
    _, _, vi_cross = eval_vi(seg_sh, seg_1c)
    if vi_cross != 0.0:
        raise AssertionError(f"sharded vs single-process cut VI {vi_cross}")
    st = mg["stats"]
    print(f"dryrun_multichip({n_devices}): sharded merge-tree construction "
          f"ok -- {n_sh} merges identical to the single-process fused "
          f"engine (rows + threshold-cut components), sharded exact "
          f"saliencies == host replay; {st['n_supersteps']} supersteps, "
          f"routed {st['routed_rows']} touched rows ({st['moved_rows']} "
          f"cross-rank), padded wire {st['a2a_wire_bytes'] / 1e6:.1f} MB, "
          f"allreduce {st['allreduce_bytes'] / 1e6:.1f} MB", flush=True)

    # ---- sharded BC tree features ----
    bcr = res["bc"]
    feats, scores, order_idx = bcr["feats"], bcr["scores"], bcr["order_idx"]
    feats_err = float(np.abs(feats - want[order_idx]).max())
    np.testing.assert_allclose(feats, want[order_idx], rtol=1e-3, atol=1e-4)
    li = int(np.nonzero(model.classes == -1)[0][0])
    np.testing.assert_allclose(scores, predict_votes_np(model, feats)[:, li],
                               atol=1e-5)
    print(f"dryrun_multichip({n_devices}): sharded BC tree features ok -- "
          f"full width {feats.shape[1]} + {model.n_trees}-tree forest, "
          f"level {lvl} activations allclose across the {n_devices} ranks "
          f"({len(order_idx)} merges)", flush=True)
    return {
        "backend": backend, "world": n_devices, "device": str(dev),
        "n_regions": rag.n_regions, "n_edges": rag.n_edges,
        "halo_rows": plan.comm_rows, "wall_s": wall,
        "loss": loss, "loss_single": loss1, "loss_rel": loss_rel,
        "losses": tr["losses"], "grad_rel": grad_rel,
        "merges": n_sh, "merge_stats": st, "cut_vi": vi_cross,
        "bc_level": lvl, "bc_merges": int(len(order_idx)),
        "bc_feats_max_abs_err": feats_err, "bc_feats": feats,
        "bc_scores": scores, "model": model,
        "seconds_by_rank": [r["seconds"] for r in results],
        "launches_by_rank": [r["launches"] for r in results],
        "host_staged_bytes": [r["host_staged_bytes"] for r in results],
        "ranks": results,
    }

