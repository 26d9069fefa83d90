#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (glia_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--side 1024] [--seed 0]

Drives the port's main path, ``pipeline.hmt_segment(engine="device_bc")``,
on a synthetic EM slice (1024 x 1024 by default, the SNEMI3D section size)
with a seeded random forest in the reference's shape (255 trees, classes
{-1, 1}, depth up to 24).  Phases, one JSON line each:

  env     torch / CUDA versions, the card's name and power limit
  build   the CUDA kernels (nvcc, sm_90a) and the C++ host runtime (g++),
          all compiled in parallel from the checkout's sources
  data    the slice, its RAG and initial candidate features on the card
          (held against the same features computed in float64 on the
          CPU), and the random forest
  kernel  every kernel of the path against its plain PyTorch version on
          the card at the slice's shapes; then the ``kernels`` line
  slice   hmt_segment on the card with launch counts, stage times, VI /
          adapted Rand, a merge-forest validity check, and a second merge
          loop run to count the order rows two card runs agree on

Any failed phase raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the rest of
the repository; it imports nothing of JAX or glia_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi})
    return smi


def phase_build():
    from glia_tpu_torch.native import get_lib, native_build
    from glia_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    builds = {"glia_native": native_build().start()}
    builds.update({name: kcuda.kernel_build(name).start()
                   for name in kcuda.SOURCES})
    for b in builds.values():
        b.wait()
    get_lib()
    seconds = time.perf_counter() - t
    ptxas = {name: [ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, b in builds.items() if name in kcuda.SOURCES}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: b.path for n, b in builds.items()},
          "ptxas": ptxas})


def random_forest(X, n_trees, max_depth, rng, n_sub=2048, min_leaf=4,
                  leaf_rate=0.02):
    """A seeded random forest in the reference's node-array shape.

    Each tree grows from a bootstrap sample of the rows of ``X``: a node
    splits on a random feature halfway between the values of two random
    samples reaching it (so splits divide the data, and sit between data
    values as CART's do), and becomes a leaf of a random class
    when too few samples reach it, at ``max_depth``, or with a chance that
    grows with depth (so samples finish at different depths)."""
    from glia_tpu_torch.models.forest import ForestModel

    X = np.asarray(X, np.float32)
    B, D = X.shape
    trees, depth_seen = [], 0
    for _ in range(n_trees):
        feat, thr, left, right, cls = [], [], [], [], []

        def new_node():
            for a, v in ((feat, -1), (thr, 0.0), (left, 0), (right, 0),
                         (cls, 0)):
                a.append(v)
            return len(feat) - 1

        stack = [(new_node(), rng.integers(0, B, min(n_sub, B)), 0)]
        while stack:
            n, idx, d = stack.pop()
            depth_seen = max(depth_seen, d)
            if (d >= max_depth or len(idx) < 2 * min_leaf
                    or rng.random() < leaf_rate * d):
                cls[n] = int(rng.integers(0, 2))
                continue
            f = int(rng.integers(0, D))
            a, b = X[idx[rng.integers(0, len(idx), 2)], f]
            t = np.float32((a + b) / np.float32(2))
            go_left = X[idx, f] <= t
            ln, rn = new_node(), new_node()
            feat[n], thr[n], left[n], right[n] = f, t, ln, rn
            stack.append((rn, idx[~go_left], d + 1))
            stack.append((ln, idx[go_left], d + 1))
        trees.append((feat, thr, left, right, cls))
    N = max(len(t[0]) for t in trees)
    arrs = [np.zeros((n_trees, N), dt) for dt in
            (np.int32, np.float32, np.int32, np.int32, np.int32)]
    arrs[0][:] = -1
    for i, t in enumerate(trees):
        for a, v in zip(arrs, t):
            a[i, :len(v)] = v
    return ForestModel.from_arrays(*arrs, n_classes=2, max_depth=depth_seen,
                                   classes=np.array([-1, 1]))


def phase_data(side, seed, n_trees, max_depth, dev):
    from glia_tpu_torch.data.synthetic import synthetic_em_slice
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.graph.merge_bc_device import (
        build_state, candidate_features, state_to_device)
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.pipeline import pre_merge, watershed

    t = time.perf_counter()
    data = synthetic_em_slice((side, side), n_cells=(side // 17) ** 2,
                              seed=seed)
    seg = pre_merge(watershed(data["pb"], 0.05), data["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    cfg = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=16)
    state_np, static = build_state(rag, cfg)
    feats, valid = candidate_features(
        state_to_device(state_np, dev, torch.float32), static)
    feats = feats.contiguous()
    ref, _ = candidate_features(
        state_to_device(state_np, torch.device("cpu"), torch.float64),
        static)
    got = feats.double().cpu()
    scaled = ((got - ref).abs() / (1e-3 + 1e-3 * ref.abs())).max().item()
    if not bool(torch.isfinite(feats).all()) or scaled > 1.0:
        raise AssertionError(
            f"card float32 features disagree with CPU float64 ones: max "
            f"|d| / (1e-3 + 1e-3 |ref|) = {scaled}")
    rng = np.random.default_rng(seed)
    model = random_forest(feats.cpu().numpy(), n_trees, max_depth, rng)
    _, inner, leaves = node_shape(model)
    emit({"phase": "data", "side": side, "seed": seed,
          "R": static.R, "E": static.E, "D": static.feat_dim,
          "valid": int(valid.sum()),
          "feature_err_vs_f64": scaled,
          "forest": {"trees": model.n_trees,
                     "nodes_padded": int(model.feature.shape[1]),
                     "nodes": inner + leaves, "inner": inner,
                     "leaves": leaves, "max_depth": model.max_depth},
          "seconds": time.perf_counter() - t})
    return data, feats, model


def node_shape(model):
    """Depth of every node [T, N] (0 at the root), and the number of real
    inner nodes and leaves: the root and every child of a split (the
    padding after each tree's last node is never a child)."""
    depth = np.zeros(model.feature.shape, np.int64)
    real = np.zeros(model.feature.shape, bool)
    real[:, 0] = True
    t, n = np.nonzero(model.feature >= 0)
    for _ in range(model.max_depth):
        for child in (model.left[t, n], model.right[t, n]):
            depth[t, child] = depth[t, n] + 1
            real[t, child] = True
    inner = len(t)
    return depth, inner, int(real.sum()) - inner


def phase_kernel(feats, model, seed):
    from glia_tpu_torch.models.forest import (
        ForestTables, forest_leaves_torch, forest_votes_torch)
    from glia_tpu_torch.ops.cuda import forest_votes_cuda

    tables = ForestTables.from_model(model, feats.device)
    # a batch whose features sit exactly on split thresholds: ties must
    # go left in both versions
    rng = np.random.default_rng(seed + 1)
    ties = feats[:4096].clone()
    ti, ni = np.nonzero(model.feature >= 0)
    pick = rng.integers(0, len(ti), (ties.shape[0], 32))
    rows = np.repeat(np.arange(ties.shape[0]), 32)
    cols = model.feature[ti[pick], ni[pick]].ravel()
    vals = model.threshold[ti[pick], ni[pick]].ravel()
    ties[torch.as_tensor(rows, device=feats.device),
         torch.as_tensor(cols, device=feats.device)] = torch.as_tensor(
             vals, device=feats.device)
    mismatches, max_err = 0, 0.0
    for X in (feats, ties):
        got = forest_votes_cuda(X, tables)
        want = forest_votes_torch(X, tables)
        torch.cuda.synchronize()
        mismatches += int((got != want).sum())
        max_err = max(max_err, float((got - want).abs().max()))
    if mismatches:
        raise AssertionError(f"forest_votes: {mismatches} vote fractions "
                             f"differ from the plain walk")

    B, D = feats.shape
    T, N, C = tables.n_trees, tables.n_nodes, tables.n_classes
    ms = cuda_time_ms(lambda: forest_votes_cuda(feats, tables), reps=20)
    plain_ms = cuda_time_ms(lambda: forest_votes_torch(feats, tables),
                            reps=5)
    # the bound: each real node read once (an inner node's feature,
    # threshold, left and right, a leaf's feature and class), X read once,
    # the output written once; one fp32 compare per step this data takes,
    # a walk's steps being the depth of the leaf it ends on
    depth, inner, leaves = node_shape(model)
    steps = torch.as_tensor(depth.reshape(-1), device=feats.device)[
        forest_leaves_torch(feats, tables)]
    gathers = int(steps.sum())
    bytes_moved = 4 * B * D + 16 * inner + 8 * leaves + 4 * B * C
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = gathers / FP32_OPS_PER_S * 1e3
    emit({"phase": "kernel", "name": "forest_votes", "B": B, "D": D,
          "T": T, "N": N, "C": C, "max_depth": tables.max_depth,
          "mean_steps": gathers / (B * T), "gathers": gathers,
          "bytes": bytes_moved, "mismatches": mismatches,
          "tie_rows": int(ties.shape[0]), "ms": ms, "plain_ms": plain_ms})
    # the kernel's path under both keys its readers look up
    return {"name": "forest_votes", "route": "cuda",
            "source": "glia_tpu_torch/ops/cuda/forest_votes.cu",
            "src": "glia_tpu_torch/ops/cuda/forest_votes.cu",
            "replaces": "glia_tpu/ops/pallas/forest.py:108",
            "launches": None, "mismatches": mismatches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def check_order(order, probs, n_regions, max_key):
    """A valid merge forest: every id merged at most once, new ids
    consecutive from max_key + 1, probabilities in [0, 1]."""
    n = len(order)
    if n == 0 or n > n_regions - 1:
        raise AssertionError(f"{n} merges for {n_regions} regions")
    merged = order[:, :2].ravel()
    if len(np.unique(merged)) != len(merged):
        raise AssertionError("an id is merged twice")
    if not np.array_equal(order[:, 2], max_key + 1 + np.arange(n)):
        raise AssertionError("new ids are not consecutive")
    if (order[:, 0] >= order[:, 2]).any() or (order[:, 1] >= order[:, 2]).any():
        raise AssertionError("a merge uses an id not yet created")
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise AssertionError("merge probabilities outside [0, 1]")


def profile_merge_loop(rag, cfg, scorer, dev):
    """One merge loop under torch.profiler: device kernel time by name,
    kernels launched, and the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glia_tpu_torch.graph.merge_bc_device import merge_order_bc_device

    stats = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        merge_order_bc_device(rag, cfg, scorer, stats=stats, device=dev)
        torch.cuda.synchronize()
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kern) / 1e3
    return {"supersteps": stats["n_supersteps"],
            "wall_ms_profiled": stats["t_merge_loop"] * 1e3,
            "device_busy_ms": busy_ms,
            "kernels_launched": sum(k[2] for k in kern),
            "top": [{"name": k[0][:90], "ms": k[1] / 1e3, "count": k[2]}
                    for k in kern[:10]]}


def agreement(order1, probs1, order2, probs2):
    """How far two merge orders agree: rows equal at the same position,
    the length of the common prefix, and whether the runs are identical."""
    n = min(len(order1), len(order2))
    same = (order1[:n] == order2[:n]).all(1)
    return {"merges": [int(len(order1)), int(len(order2))],
            "rows_equal": int(same.sum()),
            "common_prefix": int(n if same.all() else np.argmin(same)),
            "identical": bool(np.array_equal(order1, order2)
                              and np.array_equal(probs1, probs2))}


def phase_slice(data, model, dev):
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.graph.merge_bc_device import merge_order_bc_device
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.models.forest import make_label_scorer
    from glia_tpu_torch.ops import cuda as kcuda
    from glia_tpu_torch.pipeline import HmtModel, evaluate, hmt_segment

    hmt = HmtModel(forest=model, n_bins=16)
    stats = {}
    kcuda.reset_launches()
    t = time.perf_counter()
    seg, info = hmt_segment(data["pb"], data["intensity"], hmt, device=dev,
                            stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kcuda.launches)
    t = time.perf_counter()
    ev = evaluate(seg, data["truth"])
    stats["t_evaluate"] = time.perf_counter() - t

    seg0 = info["seg0"]
    keys = np.unique(seg0)
    check_order(info["order"], info["probs"], len(keys), int(keys.max()))
    if seg.shape != data["pb"].shape:
        raise AssertionError(f"segmentation shape {seg.shape}")
    if not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite metrics {ev}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    if launches["forest_votes"] != stats["n_supersteps"]:
        raise AssertionError("forest_votes should launch once per superstep")

    # second merge loop on the same RAG: kernel time per superstep and the
    # order rows two card runs agree on (index_add_ on CUDA adds in no
    # fixed order)
    rag = build_rag(seg0, contour_only=False)
    cfg = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=16)
    scorer = make_label_scorer(model, label=-1, device=dev)
    events = []

    def timed_scorer(X):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = scorer(X)
        end.record()
        events.append((start, end))
        return out

    stats2 = {}
    order2, probs2 = merge_order_bc_device(rag, cfg, timed_scorer,
                                           stats=stats2, device=dev)
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for s, e in events]
    prof = profile_merge_loop(rag, cfg, scorer, dev)
    prof["busy_share_of_unprofiled_wall"] = (
        prof["device_busy_ms"] / (stats2["t_merge_loop"] * 1e3))

    # the same two runs with PyTorch's deterministic algorithms: do the
    # runs then agree, and at what cost to the merge loop
    runs, det_stats = [], {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for _ in range(2):
                runs.append(merge_order_bc_device(
                    rag, cfg, scorer, stats=det_stats, device=dev))
        finally:
            torch.use_deterministic_algorithms(False)
    deterministic = agreement(*runs[0], *runs[1])
    deterministic["merge_loop_s"] = det_stats["t_merge_loop"]
    deterministic["nondeterministic_ops"] = sorted(
        {str(w.message).split(" does not have")[0][:80] for w in caught
         if "deterministic" in str(w.message)})
    emit({"phase": "slice", "wall_s": wall,
          "stages_s": {k: v for k, v in stats.items() if k.startswith("t_")},
          "R": int(len(keys)), "E": stats["E"], "D": stats["feat_dim"],
          "supersteps": stats["n_supersteps"], "scored": stats["n_scored"],
          "merges": int(len(info["order"])), "n_picks": info["n_picks"],
          "launches": launches,
          "scorer_ms_per_superstep": float(np.mean(kernel_ms)),
          "merge_loop_s_run2": stats2["t_merge_loop"],
          "merge_loop_profile": prof,
          "rerun": agreement(info["order"], info["probs"], order2, probs2),
          "rerun_deterministic": deterministic,
          "eval": ev})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=255)
    ap.add_argument("--depth", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    import glia_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda")
    smi = phase_env()
    phase_build()
    data, feats, model = phase_data(args.side, args.seed, args.trees,
                                    args.depth, dev)
    kernels = [phase_kernel(feats, model, args.seed)]
    launches = phase_slice(data, model, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
