"""Rank functions of the port's sharded-path tests.

``glia_tpu_torch.parallel.launch.spawn_ranks`` starts each rank with the
``spawn`` method and imports the function it runs by name, so the
functions live here, in a module that imports neither JAX nor glia_tpu
(a rank needs only the port).  Each takes the rank's Mesh and a case
dict of numpy inputs made by the test, runs every port-side call of its
test file, and returns numpy results.
"""

import numpy as np
import torch

from glia_tpu_torch.models.mlp import mlp2_init


def _np(t):
    return t.detach().cpu().numpy()


def _steps(step, w, opt, batch, n):
    losses = []
    for _ in range(n):
        w, opt, loss = step(w, opt, batch)
        losses.append(float(loss))
    return w, losses


def parallel_rank(mesh, case):
    """tests/test_torch_parallel.py: dense aggregation, edge scoring and
    train step, halo aggregation, halo forward, halo train step."""
    from glia_tpu_torch.parallel.halo import (HaloPlan,
                                              local_endpoint_indices,
                                              make_halo_aggregate,
                                              make_halo_edge_forward,
                                              shard_halo_inputs)
    from glia_tpu_torch.parallel.mesh import to_device
    from glia_tpu_torch.parallel.partition import partition_rag
    from glia_tpu_torch.parallel.rag_shard import (make_edge_scoring_step,
                                                   make_region_aggregate,
                                                   shard_edges)
    from glia_tpu_torch.parallel.train import (MLP_DIMS, make_train_step)

    out = {}
    t = lambda a, dt=None: to_device(a, mesh, dt)  # noqa: E731

    # dense aggregation, float64
    agg = make_region_aggregate(mesh, case["agg_R"])
    u, v, ev = case["agg"]
    out["aggregate"] = _np(agg(t(u, torch.int64), t(v, torch.int64),
                               t(ev)))

    # edge scoring forward on a real RAG
    rag = case["rag"]
    b = shard_edges(rag, case["pb"], mesh, max_pixels_per_edge=8)
    R_pad = -(-rag.n_regions // mesh.world) * mesh.world
    score = make_edge_scoring_step(mesh, R_pad)
    w = t(mlp2_init(*MLP_DIMS, 0), torch.float32)
    out["scoring"] = _np(score(b["u"], b["v"], b["px"], b["px_mask"],
                               b["edge_valid"], w))

    # the dense train step on the toy batch
    init, step = make_train_step(mesh, case["toy_R"], lr=5e-2)
    toy = case["toy"]
    batch = {"u": t(toy["u"], torch.int64), "v": t(toy["v"], torch.int64)}
    batch.update({k: t(toy[k]) for k in ("px", "px_mask", "edge_valid",
                                         "labels")})
    w, opt = init()
    w, out["train_losses"] = _steps(step, w, opt, batch, case["n_steps"])
    out["train_w"] = _np(w)

    # halo aggregation and halo forward
    part = partition_rag(rag, mesh.world)
    plan = HaloPlan(part, rag)
    inp = shard_halo_inputs(mesh, plan, part, rag, case["halo_ev"])
    agg = make_halo_aggregate(mesh, plan, rag.n_regions, 3)
    own, halo = agg(inp["u"], inp["v"], inp["ev"], inp["send_ids"],
                    inp["recv_local"], inp["own_ids"], inp["halo_ids"],
                    inp["fetch_local"])
    out["halo_own"], out["halo_rows"] = _np(own), _np(halo)

    from glia_tpu_torch.ops.pack import pack_edge_pixels

    hu, hv, px, mask = pack_edge_pixels(rag, case["halo_pb"], 8)
    groups, E_max = inp["groups"], inp["E_max"]
    n = plan.n
    u_p = np.full((n, E_max), rag.n_regions, np.int64)
    v_p = np.full((n, E_max), rag.n_regions, np.int64)
    px_p = np.zeros((n, E_max, px.shape[1]), np.float32)
    mask_p = np.zeros((n, E_max, px.shape[1]), np.float32)
    valid_p = np.zeros((n, E_max), np.float32)
    for s, g in enumerate(groups):
        u_p[s, : len(g)] = hu[g]
        v_p[s, : len(g)] = hv[g]
        px_p[s, : len(g)] = px[g]
        mask_p[s, : len(g)] = mask[g]
        valid_p[s, : len(g)] = 1.0
    u_loc, v_loc = local_endpoint_indices(plan, part, rag, groups, E_max)
    fwd = make_halo_edge_forward(mesh, plan, rag.n_regions)
    w = t(mlp2_init(*MLP_DIMS, 0), torch.float32)
    out["halo_forward"] = _np(fwd(
        w, t(u_p.reshape(-1)), t(v_p.reshape(-1)),
        t(px_p.reshape(-1, px.shape[1])),
        t(mask_p.reshape(-1, px.shape[1])), t(valid_p.reshape(-1)),
        t(u_loc.reshape(-1), torch.int64), t(v_loc.reshape(-1), torch.int64),
        inp["send_ids"], inp["recv_local"], inp["own_ids"],
        inp["fetch_local"]))
    out["halo_groups"] = groups
    out.update(halo_train_rank(mesh, case))
    return out


def halo_train_rank(mesh, case):
    """The halo train step: loss and gradient at the initial weights,
    then ``n_steps`` steps."""
    from glia_tpu_torch.parallel.halo import HaloPlan
    from glia_tpu_torch.parallel.partition import partition_rag
    from glia_tpu_torch.parallel.train import (make_halo_train_step,
                                               shard_halo_train_inputs)

    rag, K, BINS = case["rag"], case["K"], case["BINS"]
    part = partition_rag(rag, mesh.world)
    plan = HaloPlan(part, rag)
    init, step, dims = make_halo_train_step(
        mesh, plan, rag.n_regions, n_images=2, k_pixels=K, n_bins=BINS,
        n1=16, n2=8)
    batch = shard_halo_train_inputs(mesh, plan, part, rag, case["images"],
                                    case["labels"], k_pixels=K, n_bins=BINS)
    w, opt = init()
    loss0, g0 = step.loss_and_grad(w, batch)
    w, losses = _steps(step, w, opt, batch, case["n_steps"])
    return {"halo_loss0": float(loss0), "halo_grad0": _np(g0),
            "halo_losses": losses, "halo_w": _np(w), "halo_dims": dims}


def merge_rank(mesh, case):
    """tests/test_torch_parallel_merge.py: the sharded merge with default
    and forced small route capacity, and the sharded exact saliencies."""
    from glia_tpu_torch.parallel.merge_shard import (exact_saliency_sharded,
                                                     merge_batched_sharded)

    u, v, s, c, R = case["u"], case["v"], case["s"], case["c"], case["R"]
    out = {}
    for name, cap in (("default", None), *case["caps"].items()):
        stats = {}
        order, sal, n_m = merge_batched_sharded(u, v, s, c, R, mesh, dmax=4,
                                                stats=stats, route_cap=cap)
        out[name] = {"order": _np(order), "sal": _np(sal), "n_m": n_m,
                     "stats": stats}
    n_m = out["default"]["n_m"]
    out["exact"] = exact_saliency_sharded(
        u, v, s, c, out["default"]["order"][:n_m], R, mesh)
    return out


def bc_rank(mesh, case):
    """tests/test_torch_parallel_bc.py: sharded level features of both
    feature configurations, the first scored by the forest."""
    from glia_tpu_torch.models.forest import make_label_scorer
    from glia_tpu_torch.parallel.bc_tree_shard import (TreeShardPlan,
                                                       sharded_level_features)
    from glia_tpu_torch.parallel.partition import partition_rag

    out = {}
    part = partition_rag(case["rag"], mesh.world)
    for name, cfg, levels, forest in case["configs"]:
        plan = TreeShardPlan(case["rag"], case["order"], cfg, part)
        scorer = None
        if forest is not None:
            scorer = make_label_scorer(forest, label=-1, device=mesh.device)
        out[name] = {l: sharded_level_features(mesh, plan, l, scorer=scorer)
                     for l in levels}
    return out


def halo_grad_rank(mesh, case):
    """The halo step's loss and gradient at the initial weights."""
    out = halo_train_rank(mesh, dict(case, n_steps=0))
    return {k: out[k] for k in ("halo_loss0", "halo_grad0")}


def rank_info(mesh, fail_rank=None, sleep_rank=None):
    """The mesh each rank sees; rank ``fail_rank`` raises, rank
    ``sleep_rank`` never returns (the others wait in a collective)."""
    import time

    if mesh.rank == fail_rank:
        raise ValueError(f"rank {mesh.rank} fails on purpose")
    if mesh.rank == sleep_rank:
        time.sleep(3600)
    total = mesh.psum(torch.tensor([mesh.rank], dtype=torch.int64))
    return {"rank": mesh.rank, "world": mesh.world,
            "device": str(mesh.device), "backend": mesh.backend,
            "psum": int(total[0]), "threads": torch.get_num_threads()}


def snemi_merge_rank(mesh, case, glia_s):
    """tests/test_torch_snemi.py: run_snemi_e2e.merge_rank on the port's
    payload, then again with glia_tpu's ``s`` on the same counts
    (``on_glia_s``)."""
    from glia_tpu_torch.examples import run_snemi_e2e as e2e

    res = e2e.merge_rank(mesh, case)
    res["on_glia_s"] = e2e.merge_rank(mesh, dict(case, s=glia_s))
    return res
