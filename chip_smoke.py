#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (glia_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--side 1024] [--seed 0]

Drives the port's main paths on synthetic EM slices (1024 x 1024 by
default, the SNEMI3D section size): ``pipeline.hmt_segment`` with
``engine="device_bc"`` and with ``engine="device"`` (policies mean and
median) with seeded random forests in the reference's shape (255 trees,
classes {-1, 1}, depth up to 24); then training, ``hmt_train(classifier=
"mlp")`` and ``hmt_train_sshmt``, and segmenting with the trained models
and on ``engine="host"``; then forests trained by the port's CART trainer
on every engine; then bench.py's merge flow on its 4096 x 4096 section
through glia_tpu_torch.bench, its script at 2048 x 2048 and the port's
card suite; then glia_tpu's tools/ scripts as the port's examples;
then the sharded path (BASELINE config #5) on torch.distributed ranks,
and config #5 end to end on a cut SNEMI3D-scale volume;
then the stack paths at BASELINE config #2's scale (3D HMT on a volume of
512 x 512 sections, LINK3D across its sections) and the file-bus CLI.
Phases, one JSON line each:

  env     torch / CUDA versions, the card's name and power limit
  build   the CUDA kernels (nvcc, sm_90a) and the C++ host runtime (g++),
          all compiled in parallel from the checkout's sources
  data    the slice, its RAG and initial candidate features on the card
          (held against the same features computed in float64 on the
          CPU), and the random forest
  kernel  every kernel of the paths against its plain PyTorch version on
          the card at the slice's shapes: the forest walk (0 mismatching
          vote fractions on each path's batch, a batch set onto
          thresholds, a batch that ends inside a sample tile, 2 and 8
          classes, both instantiations, a forest too large for shared
          memory); the segment sum, both entry points, at the shapes the
          merge engines give it (the sorted entry must give the CPU's
          index_add_ bits, in float32 and float64)
  slice   hmt_segment(engine="device_bc") on the card with launch counts,
          stage times, VI / adapted Rand, a merge-forest validity check,
          and a second merge loop run that must give the same order rows
          and the same probabilities, bit for bit
  slice_device
          hmt_segment(engine="device") on the card for the policies mean
          and median with the device forest walk: launch counts of both
          kernels, stage times, the merge loop's profile, the exact
          saliencies against the serial replay, and two more runs of the
          merge that must replay its plan's CUDA graph and give the main
          path's rows and identical saliencies
  slice_train
          four more sections: MLP2 (16, 8) trained on two, then
          hmt_segment(engine="device") with it; SSHMT Logsig trained on
          one labeled and one unlabeled, then hmt_segment(engine="host",
          mode="ccm") with it; hmt_segment(engine="host",
          backend="device") with the engine="device" phase's forest.
          Each training runs on the card in float64, again on the card
          (identical weights or the script fails), on the CPU in float64
          (Logsig: weights within 1e-6 of the largest or the script fails;
          MLP2, whose trajectory is chaotic under glia_tpu's schedule:
          the same within 3 rounds of 50 Adam steps) and in the card's
          default dtype (printed); the MLP2's probabilities resolved with
          mode="ccm" (more than one pick, at the optimum's energy); stage
          seconds, steps/s, sigmas, VI and Rand of each segmentation
          beside the watershed baseline's
  slice_forest
          forests of 100 trees trained by the port (train_forest) on the
          MLP sections' samples: trained again and on one thread
          (identical arrays, or the script fails), its held-out error on
          the SSHMT labeled section (below the majority class's), then
          hmt_segment(engine="host" and "device", backend="device"); a
          forest on the same merges' 143-wide features, then
          hmt_segment(engine="device_bc") twice (identical rows and
          probabilities, and kernel B1 equal to the plain walk on every
          batch of the loop), and the serial C++ BC engine with it beside
          device_bc on the section's BC_SIDE^2 corner;
          hmt_train(classifier="rf_ensemble"), then engine="host" with
          it; kernel B1 against the plain walk at each trained forest's
          batch (plan, ms, bound)
  slice_merge
          bench.py's merge flow at 4096^2 (its section: 243,749 regions
          and 597,140 edges in glia_tpu) through glia_tpu_torch.bench:
          the host serial baseline, then merge_batched_device_exact
          (mode="fused_ms", the multi-phase engine, and the exact
          saliencies on the card) and the same flow with mode="fused",
          each a first call and timed repeats (bench.py's JSON line,
          edges/s, supersteps, buckets, kernels per superstep, busy share,
          the three cut VIs); the fused_ms repeats replay the plan's CUDA
          graph (capture seconds, pool bytes, B2 launches a replay, replay
          wall against the first call's); GLIA_MERGE_DEBUG's per-phase
          walls and alive counts on the memoized plan and
          GLIA_MERGE_NOPACK64's graph beside the packed one; bench.py's
          keys and value, both modes' threshold cuts at VI 0 to each
          other, repeats identical, float64 exact saliencies within 1e-12
          of the C++ replay, no fallback, the switches' rows and saliency
          bits equal to the replay's and no graph of the other setting
          replayed, or the script fails; kernel B2 at the engine's shapes;
          the sparse-pair metrics of the cut against the host's.  On the
          data section: merge_serial_device (float64, card
          = CPU bit for bit), mode="chunked" (card rows = CPU rows), the
          plan store across two processes (the second's first call
          replays the stored plan with the first's rows), the dense
          device metrics and the tree scan against the host's
  bench_cli
          python -m glia_tpu_torch.bench in a child process at
          GLIA_BENCH_SIDE=2048: exit 0 and one stdout line with bench.py's
          four keys, or the script fails; kernel B2 at that section's
          shapes
  card_suite
          python -m pytest --noconftest tests/test_torch_on_card.py in a
          child process (the counterpart of tests_tpu/test_real_tpu.py):
          all ten tests pass, none skipped, or the script fails
  slice_tools
          glia_tpu's scripts under tools/ as the port's examples, at the
          tools' default arguments: bench_merge_device (fused_ms: no
          fallback, graph replays; its cut's merge count equal to
          fused's), bench_bc_device (B1 in the loop, the steady order
          equal to the first), bench_forest_pallas (0 mismatches on both
          walks; B1 held and timed at its batch), bench_bc_midcut (the
          serial and device orders' mid-cut VI gaps within
          tests/test_bc_midcut.py's bounds), bench_median_drift (both
          policies, finite cut VIs), bench_scaling (1 and 2 gloo ranks
          sharing the card, TOOLS_SCALING_WORLDS: the host plan's halo
          rows and cut, one first loss); hard checks each
  slice_parallel
          the sharded path (glia_tpu_torch.parallel) on torch.distributed:
          dryrun.dryrun_multichip(4) on four gloo ranks sharing the card
          (halo train step, sharded merge and exact saliencies, sharded
          BC features, each held to the single-process path; the
          gradient 4 x the single-process one, glia_tpu's factor); the
          sharded merge at 4096^2 on four gloo ranks and on one NCCL rank
          (rows equal to mode="fused"'s, float64 exact saliencies within
          1e-12 of the C++ replay, the median wall of three calls); rank
          0's B2 sums and B1 batches held to the plain versions; the
          dryrun's stages once more in the same ranks, with the first
          run's bits on every rank, or the script fails
  slice_snemi
          BASELINE config #5 end to end (tools/run_snemi_e2e.py's flow,
          glia_tpu_torch.examples.run_snemi_e2e) at SNEMI_Z_RUN sections
          of 1024^2 with 4 cells a section (seed 23): watershed, RAG,
          truth-derived labels, 40 halo train steps on one NCCL rank,
          full-width scoring, the sharded merge and exact saliencies in
          float64, threshold cuts scored from the region-truth pair table
          on the card; hard: rows equal to mode="fused"'s in float64 and
          again on a second call, exact saliencies within 1e-12 of the
          C++ replay, device pair counts equal to the host's int64
          counts, the voxel-level oracle within 1e-9 of the pair-table VI
          and adapted Rand error, the first loss within 1e-4 of the
          single-process loss and the last below it, B2 launched on every
          stage and one sum of each kind held to the plain sum; two runs
          with the same bits (the loss of every step, the weights, the
          probabilities, the merge rows at every tau); then the
          partition and halo counters of 8 shards and edges/s of the halo
          step (run_snemi_sharded) on the same volume
  slice_3d
          BASELINE config #2 (tools/run_3d_hmt.py's flow, through the
          example glia_tpu_torch.examples.run_3d_hmt): a synthetic
          volume of VOL_Z_RUN (36) sections of 512^2 with 4 cells a
          section (seed 17), a forest of 80 trees trained by hmt_train on
          a (z // 4) x 256^2 subvolume (seed 31); pipeline3d.hmt3d_segment
          with its defaults (the host engine, the forest walked on the
          card), then hmt_segment(
          engine="device", backend="device") on the whole volume (no
          fallback of the multi-phase engine, B1 equal to the plain walk
          at the volume's batch, two more runs of the device merge with
          the same rows and saliency bits, float64 exact saliencies of
          the mean flow within 1e-12 of the C++ replay, or the script
          fails; B2 at the volume's shapes), then engine="device_bc" on
          the training subvolume with a forest at its BC width (every
          B1 batch and every B2 sum of its loop held to the plain
          versions, or the script fails; B2 timed at its first
          superstep's sums);
          supervoxels, RAG edges, merges, stage seconds, VI / adapted
          Rand against the truth beside the watershed baseline's
  slice_link3d
          link3d_train on the subvolume's sections (their truth as the
          segmentations), link3d_segment on the volume's sections with
          the link forest walked on the card (B1 equal to the plain walk
          at the link rows, or the script fails); pairs, links, seconds,
          the linking error
  slice_cli
          python -m glia_tpu_torch.cli's main, subcommand by subcommand,
          on the data section through .npy images: watershed, pre_merge,
          merge_order_pb --engine device, bc_feat, bc_label, train_rf,
          pred_rf, merge_order_bc --engine device, segment_greedy,
          eval_vi, eval_ri, then the LINK3D subcommands on two sections
          of the volume; every output equal to what the library call it
          wraps gives, or the script fails; then the ``kernels`` line

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
from dataclasses import replace

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def cuda_burst_time_ms(fn, inner=20, reps=5):
    """Device milliseconds of one ``fn()`` from bursts of ``inner`` calls
    between two CUDA events: for a kernel that runs longer than the host
    takes to enqueue it, so that the device never waits for the host."""
    def burst():
        for _ in range(inner):
            fn()

    return cuda_time_ms(burst, reps, warmup=1) / inner


def cuda_graph_time_ms(fn, inner=20, reps=20):
    """Device milliseconds of one ``fn()``: ``inner`` calls are captured
    into one CUDA graph and the graph's replays are timed, so that the
    host's time to enqueue a call (tens of microseconds, more than a small
    kernel runs) does not count.  The calls run back to back on the same
    tensors, so they find them in the L2 cache, as a superstep of the
    merge loop finds the tensors its previous kernels wrote."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_time_ms(graph.replay, reps) / inner


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    import importlib.util

    from glia_tpu_torch.device import nvidia_smi_line

    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          # io/image.py needs imageio for every suffix but .npy
          "imageio": importlib.util.find_spec("imageio") is not None,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi})
    return smi


def phase_build():
    from glia_tpu_torch.native import (forest_build, get_forest_lib,
                                       get_lib, native_build)
    from glia_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    builds = {"glia_native": native_build().start(),
              "glia_forest": forest_build().start()}
    builds.update({name: kcuda.kernel_build(name).start()
                   for name in kcuda.SOURCES})
    for b in builds.values():
        b.wait()
    get_lib()
    get_forest_lib()
    seconds = time.perf_counter() - t
    ptxas = {name: [ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, b in builds.items() if name in kcuda.SOURCES}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: b.path for n, b in builds.items()},
          "ptxas": ptxas})


def random_forest(X, n_trees, max_depth, rng, n_sub=2048, min_leaf=4,
                  leaf_rate=0.02, n_classes=2):
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
                cls[n] = int(rng.integers(0, n_classes))
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
    classes = np.array([-1, 1]) if n_classes == 2 else np.arange(n_classes)
    return ForestModel.from_arrays(*arrs, n_classes=n_classes,
                                   max_depth=depth_seen, classes=classes)


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
    return data, seg, rag, feats, model


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


# kernel B1's time per launch before its redesign (one thread per sample
# walking the flat tables in L2), NVIDIA H100 80GB HBM3 at 700 W: printed
# beside the new time on the ``kernel`` lines, never on the ``kernels`` line
# (every time there is one this run measured)
B1_PREV_MS = {"device_bc": 1.512, "device": 1.517}


def tie_batch(X, model, rng, per_row=32):
    """A copy of ``X`` whose rows each sit exactly on ``per_row`` split
    thresholds of ``model``: ties must go left in both versions."""
    ties = X.clone()
    ti, ni = np.nonzero(model.feature >= 0)
    pick = rng.integers(0, len(ti), (ties.shape[0], per_row))
    rows = np.repeat(np.arange(ties.shape[0]), per_row)
    cols = model.feature[ti[pick], ni[pick]].ravel()
    vals = model.threshold[ti[pick], ni[pick]].ravel()
    ties[torch.as_tensor(rows, device=X.device),
         torch.as_tensor(cols, device=X.device)] = torch.as_tensor(
             vals, device=X.device)
    return ties


def forest_mismatches(X, tables, global_memory=False):
    """(vote fractions that differ between the kernel and the plain walk,
    their largest difference); two launches must give the same bits.
    ``global_memory``: through the kernel's global-memory instantiation."""
    from glia_tpu_torch.models.forest import forest_votes_torch
    from glia_tpu_torch.ops.cuda import forest_votes_cuda

    got = forest_votes_cuda(X, tables, global_memory)
    again = forest_votes_cuda(X, tables, global_memory)
    want = forest_votes_torch(X, tables)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("forest_votes: two launches gave different bits")
    return int((got != want).sum()), float((got - want).abs().max())


def phase_kernel(feats, model, seed, path="device_bc"):
    """Kernel B1 (forest vote walk) against the plain walk at one path's
    batch: ``feats`` [B, D] float32 on the card, ``model`` the forest."""
    from glia_tpu_torch.models.forest import (
        ForestTables, forest_leaves_torch, forest_votes_torch)
    from glia_tpu_torch.ops import cuda as kcuda

    tables = ForestTables.from_model(model, feats.device)
    rng = np.random.default_rng(seed + 1)
    # the path's batch, a batch on thresholds, a batch that ends inside a
    # sample tile; each through both instantiations of the kernel
    batches = {"path": feats, "ties": tie_batch(feats[:4096], model, rng),
               "ragged": feats[:1000 + 37].contiguous()}
    mismatches, max_err = 0, 0.0
    for name, X in batches.items():
        n, err = forest_mismatches(X, tables)
        n2, err2 = forest_mismatches(X, tables, global_memory=True)
        mismatches += n + n2
        max_err = max(max_err, err, err2)
    if mismatches:
        raise AssertionError(f"forest_votes: {mismatches} vote fractions "
                             f"differ from the plain walk")

    B, D = feats.shape
    T, N, C = tables.n_trees, tables.n_nodes, tables.n_classes
    ms = cuda_burst_time_ms(lambda: kcuda.forest_votes_cuda(feats, tables))
    global_ms = cuda_burst_time_ms(
        lambda: kcuda.forest_votes_cuda(feats, tables, global_memory=True))
    plain_ms = cuda_time_ms(lambda: forest_votes_torch(feats, tables),
                            reps=5)
    plan = kcuda.forest_plan_on(tables, B, D, feats.device)
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
    emit({"phase": "kernel", "name": "forest_votes", "path": path,
          "B": B, "D": D,
          "T": T, "N": N, "C": C, "max_depth": tables.max_depth,
          "mean_steps": gathers / (B * T), "gathers": gathers,
          "bytes": bytes_moved, "mismatches": mismatches,
          "batches": {k: int(v.shape[0]) for k, v in batches.items()},
          "plan": plan, "ms": ms, "prev_ms": B1_PREV_MS.get(path),
          "global_memory_ms": global_ms, "plain_ms": plain_ms})
    return {"name": "forest_votes", "route": "cuda",
            "source": "glia_tpu_torch/ops/cuda/forest_votes.cu",
            "replaces": "glia_tpu/ops/pallas/forest.py:108",
            "path": path, "shape": {"B": B, "D": D, "T": T, "N": N, "C": C},
            "launches": None, "mismatches": mismatches,
            "max_abs_err": max_err, "ms": ms,
            "global_memory_ms": global_ms, "plain_ms": plain_ms,
            "plan": plan, "mean_steps": gathers / (B * T),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_kernel_forest_shapes(feats, seed):
    """Kernel B1 on forests the paths do not have: 8 classes, and trees too
    large for a shared-memory buffer (the kernel then walks global
    memory)."""
    from glia_tpu_torch.models.forest import ForestTables
    from glia_tpu_torch.ops import cuda as kcuda

    X_np = feats.cpu().numpy()
    rng = np.random.default_rng(seed + 4)
    cases = {
        "classes_8": random_forest(X_np, 64, 12, rng, n_classes=8),
        "large_trees": random_forest(X_np, 4, 24, rng, n_sub=4096,
                                     min_leaf=1, leaf_rate=0.0),
    }
    for name, model in cases.items():
        tables = ForestTables.from_model(model, feats.device)
        n = sum(forest_mismatches(X, tables)[0]
                for X in (feats, tie_batch(feats[:4096], model, rng)))
        plan = kcuda.forest_plan_on(tables, *feats.shape, feats.device)
        if n:
            raise AssertionError(f"forest_votes[{name}]: {n} vote fractions "
                                 f"differ from the plain walk")
        if name == "large_trees" and plan["staged"]:
            raise AssertionError("the large forest fits shared memory: the "
                                 "global-memory branch was not taken")
        emit({"phase": "kernel", "name": "forest_votes", "case": name,
              "T": tables.n_trees, "C": tables.n_classes,
              "max_depth": tables.max_depth,
              "largest_tree": int(tables.n_real.max()), "plan": plan,
              "mismatches": n,
              "ms": cuda_burst_time_ms(
                  lambda: kcuda.forest_votes_cuda(feats, tables), inner=5)})


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


def profile_run(fn):
    """``fn()`` under torch.profiler: device kernel time by name, kernels
    launched, and the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda k: -k[1])
    return {"device_busy_ms": sum(k[1] for k in kern) / 1e3,
            "kernels_launched": sum(k[2] for k in kern),
            "top": [{"name": k[0][:90], "ms": k[1] / 1e3, "count": k[2]}
                    for k in kern[:10]]}


def profile_merge_loop(rag, cfg, scorer, dev):
    """One device_bc merge loop under torch.profiler."""
    from glia_tpu_torch.graph.merge_bc_device import merge_order_bc_device

    stats = {}
    prof = profile_run(lambda: merge_order_bc_device(
        rag, cfg, scorer, stats=stats, device=dev))
    return {"supersteps": stats["n_supersteps"],
            "wall_ms_profiled": stats["t_merge_loop"] * 1e3, **prof}


def agreement(order1, probs1, order2, probs2):
    """How far two merge orders agree: rows equal at the same position,
    the length of the common prefix, and whether the runs are identical."""
    n = min(len(order1), len(order2))
    same = (order1[:n] == order2[:n]).all(1)
    return {"merges": [int(len(order1)), int(len(order2))],
            "rows_equal": int(same.sum()),
            "common_prefix": int(n if same.all() else np.argmin(same)),
            "identical": bool(np.array_equal(order1, order2)
                              and np.array_equal(probs1, probs2,
                                                 equal_nan=True))}


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
    seg, info = hmt_segment(data["pb"], data["intensity"], hmt,
                            engine="device_bc", device=dev, stats=stats)
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
    if launches["forest_votes"] == 0:
        raise AssertionError("kernel forest_votes never launched on the "
                             "device_bc path")
    if launches["forest_votes"] != stats["n_supersteps"]:
        raise AssertionError("forest_votes should launch once per superstep")
    if launches["segment_sum"] < 5 * stats["n_supersteps"]:
        raise AssertionError("segment_sum should launch for every sum of "
                             "every superstep of the device_bc path")

    # second merge loop on the same RAG: kernel time per superstep, and the
    # same rows and probabilities as the first (every float sum of the loop
    # adds in a fixed order)
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

    prof["kernels_per_superstep"] = (prof["kernels_launched"]
                                     / prof["supersteps"])
    rerun = agreement(info["order"], info["probs"], order2, probs2)
    if not rerun["identical"]:
        raise AssertionError(f"two card runs of the device_bc merge loop "
                             f"differ: {rerun}")
    # a whole loop with every sorted=True call's ids checked on the card
    # (by lower endpoint, by upper endpoint after the stable sort, dedupe)
    checked = len(capture_segment_sums(
        lambda: merge_order_bc_device(rag, cfg, scorer, device=dev),
        keep=False))
    emit({"phase": "slice", "wall_s": wall,
          "stages_s": {k: v for k, v in stats.items() if k.startswith("t_")},
          "R": int(len(keys)), "E": stats["E"], "D": stats["feat_dim"],
          "supersteps": stats["n_supersteps"], "scored": stats["n_scored"],
          "merges": int(len(info["order"])), "n_picks": info["n_picks"],
          "launches": launches,
          "scorer_ms_per_superstep": float(np.mean(kernel_ms)),
          "merge_loop_s_run2": stats2["t_merge_loop"],
          "merge_loop_profile": prof,
          "rerun": rerun, "segment_sums_with_ids_checked": checked,
          "eval": ev})
    return launches


SEGMENT_SUM_RTOL = 1e-5


def capture_segment_sums(fn, keep=True, first=None, outputs=None):
    """Run ``fn()`` and return the (values, ids, n_segments, sorted) of
    every segment sum the merge engines asked for meanwhile.  Every call
    that states ``sorted=True`` is checked on the card: its ids must be
    non-decreasing (the kernel takes the caller's word for it).
    ``keep=False`` only checks and counts: the list holds None.
    ``first``: only the first so many calls are checked and listed.
    ``outputs``: a list that receives a copy of each listed call's sum.
    The memoized merge plans are forgotten first, so that a multi-phase
    merge in ``fn`` runs its discovery supersteps eagerly, as Python calls
    (a plan's CUDA graph replays its sums without any; the checks above
    read the card from the host and cannot be captured)."""
    import glia_tpu_torch.graph.merge_bc_device as mbd
    import glia_tpu_torch.graph.merge_device as md
    import glia_tpu_torch.metrics.device as mdev
    import glia_tpu_torch.ops.segment_csr as csr
    import glia_tpu_torch.parallel.merge_shard as msh

    # csr: segment_sum_ordered, the fixed-order sums of parallel/
    callers = (md, mbd, msh, mdev, csr)
    calls = []
    real = md.segment_sum_auto

    def record(values, seg_ids, n_segments, sorted=False):
        if torch.cuda.is_current_stream_capturing():
            raise AssertionError("a segment sum to record inside a CUDA "
                                 "graph capture")
        if first is not None and len(calls) >= first:
            return real(values, seg_ids, n_segments, sorted=sorted)
        if sorted and bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise AssertionError(
                f"segment sum number {len(calls)} states sorted=True but "
                f"its ids decrease (values {tuple(values.shape)})")
        calls.append((values.contiguous(), seg_ids.long().contiguous(),
                      int(n_segments), bool(sorted)) if keep else None)
        out = real(values, seg_ids, n_segments, sorted=sorted)
        if outputs is not None:
            outputs.append(out.clone())
        return out

    # the memoized plans, last-phase counts and depth capacities go: each
    # shape's next merge discovers again (the captured graphs stay)
    for memo in (md._PLAN_MEMO, md._PLAN_LAST_STEPS, md._EXACT_SAL_L):
        memo.clear()
    for m in callers:
        m.segment_sum_auto = record
    try:
        fn()
    finally:
        for m in callers:
            m.segment_sum_auto = real
    return calls


def run_lengths(ids, S):
    """(mean, longest) run of equal kept ids in a sorted id tensor."""
    kept = ids[(ids >= 0) & (ids < S)]
    if kept.numel() == 0:
        return 0.0, 0
    counts = torch.unique_consecutive(kept, return_counts=True)[1]
    return float(counts.double().mean()), int(counts.max())


def sum_rel_err(got, want):
    """The largest error relative to each sum, with a floor of 1e-6 of the
    largest sum so that empty segments (0 on both sides) divide by
    something."""
    if want.numel() == 0:
        return 0.0
    floor = 1e-6 * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / (want.abs() + floor)).max())


def hold_segment_sums(name, calls, outputs):
    """Every segment sum of a run (``calls`` and ``outputs`` as
    capture_segment_sums lists them) against the plain sum on the card,
    within SEGMENT_SUM_RTOL, or the script fails."""
    from glia_tpu_torch.ops.segment_csr import segment_sum_torch

    worst = 0.0
    for i, ((values, ids, S, _), got) in enumerate(zip(calls, outputs)):
        rel = sum_rel_err(got, segment_sum_torch(values, ids, S))
        if not bool(torch.isfinite(got).all()) or rel > SEGMENT_SUM_RTOL:
            raise AssertionError(f"segment_sum[{name}, call {i}]: max "
                                 f"relative error {rel} above "
                                 f"{SEGMENT_SUM_RTOL}")
        worst = max(worst, rel)
    return {"sums": len(calls), "max_rel_err": worst}


def check_segment_sum(name, values, ids, S, is_sorted, prev_ms=None):
    """One shape of kernel B2 against the plain version on the card; the
    sorted entry must also give the bits of the CPU's ``index_add_``, for
    these values and for their float64 copies.  ``prev_ms``: the time at
    this shape before the sorted entry's redesign."""
    from glia_tpu_torch.ops import cuda as kcuda
    from glia_tpu_torch.ops.cuda import segment_sum_cuda
    from glia_tpu_torch.ops.segment_csr import segment_sum_torch

    got = segment_sum_cuda(values, ids, S, sorted=is_sorted)
    again = segment_sum_cuda(values, ids, S, sorted=is_sorted)
    want = segment_sum_torch(values, ids, S)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    rel = sum_rel_err(got, want)
    if not bool(torch.isfinite(got).all()) or rel > SEGMENT_SUM_RTOL:
        raise AssertionError(f"segment_sum[{name}]: max relative error "
                             f"{rel} above {SEGMENT_SUM_RTOL}")
    stable = bool(torch.equal(got, again))
    if is_sorted and not stable:
        raise AssertionError(f"segment_sum[{name}]: two launches of the "
                             f"sorted entry point gave different bits")
    on_cpu = segment_sum_torch(values.cpu(), ids.cpu(), S)
    cpu_bits = bool(torch.equal(got.cpu(), on_cpu))
    if is_sorted:
        other = torch.float32 if values.dtype == torch.float64 \
            else torch.float64
        cast = values.to(other)
        cpu_bits_other = bool(torch.equal(
            segment_sum_cuda(cast, ids, S, sorted=True).cpu(),
            segment_sum_torch(cast.cpu(), ids.cpu(), S)))
        if not (cpu_bits and cpu_bits_other):
            raise AssertionError(
                f"segment_sum[{name}]: the sorted entry point differs from "
                f"the CPU's index_add_ ({values.dtype}: {cpu_bits}, "
                f"{other}: {cpu_bits_other})")
    B = values.shape[0]
    F = values.shape[1] if values.ndim == 2 else 1
    w = values.element_size()
    lib_ids = torch.where((ids >= 0) & (ids < S), ids, S)
    out_shape = (S + 1,) + tuple(values.shape[1:])

    def kernel():
        return segment_sum_cuda(values, ids, S, sorted=is_sorted)

    def library():
        return torch.zeros(out_shape, dtype=values.dtype,
                           device=values.device).index_add_(0, lib_ids,
                                                            values)

    # device time from CUDA graph replays; call_ms is one eager call as
    # the merge loop makes it (zeroing, launch and the host's time to
    # enqueue them)
    ms = cuda_graph_time_ms(kernel)
    plain_ms = cuda_graph_time_ms(lambda: segment_sum_torch(values, ids, S))
    library_ms = cuda_graph_time_ms(library)
    call_ms = cuda_time_ms(kernel, reps=50)
    library_call_ms = cuda_time_ms(library, reps=50)
    # the bound: B2's byte model (every id and the values of the rows
    # this run's ids keep read once, the output rows they reach written
    # once); one add per kept value
    kept = int(((ids >= 0) & (ids < S)).sum())
    bytes_moved = kcuda.segment_sum_bytes(B, F, S, w, kept=kept)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = kept * F / FP32_OPS_PER_S * 1e3
    res = {"shape": name, "entry": "sorted" if is_sorted else "atomic",
           "B": B, "F": F, "S": S, "dtype": str(values.dtype),
           "dropped_rows": B - kept,
           "max_rel_err": rel, "max_abs_err": float(diff.max()),
           "same_bits_two_launches": stable,
           "same_bits_as_cpu_index_add": cpu_bits,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "call_ms": call_ms, "library_call_ms": library_call_ms,
           "bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if is_sorted:
        res["mean_run"], res["longest_run"] = run_lengths(ids, S)
    # the earlier time goes on this line only: ``res`` feeds the
    # ``kernels`` line, whose times are all this run's
    earlier = {} if prev_ms is None else {"prev_ms": prev_ms}
    emit({"phase": "kernel", "name": "segment_sum", **res, **earlier})
    return res


# the sorted entry's device time before its redesign (one thread walking
# each run from global memory), NVIDIA H100 80GB HBM3 at 700 W
B2_PREV_MS = {"dedupe_median": 0.00665, "dedupe_mean": 0.00368,
              "random_sorted": 0.02722}


# the segment sums of one device_bc superstep by call site, in call
# order, with whether each states sorted ids; B2 is timed at the first
# three and the last
BC_SUMS = (("bc_by_lower", True), ("bc_by_upper", True),
           ("bc_count_min_u", False), ("bc_count_min_v", False),
           ("bc_count_max_u", False), ("bc_count_max_v", False),
           ("bc_dedupe", True))
BC_SUMS_TIMED = ("bc_by_lower", "bc_by_upper", "bc_count_min_u",
                 "bc_dedupe")


def bc_superstep_sums(calls, step, prefix=""):
    """The segment sums B2 is timed at, of superstep ``step`` of the
    device_bc loop whose sums capture_segment_sums listed in ``calls``,
    named by their call site."""
    n = len(BC_SUMS)
    if len(calls) % n:
        raise AssertionError(f"{len(calls)} segment sums in a device_bc "
                             f"loop, not a multiple of {n}")
    block = calls[n * step:n * (step + 1)]
    if [c[3] for c in block] != [srt for _, srt in BC_SUMS]:
        raise AssertionError("the device_bc loop's segment sums are not "
                             "the ones this phase expects")
    return [(prefix + name, *c) for (name, _), c in zip(BC_SUMS, block)
            if name in BC_SUMS_TIMED]


def device_bc_segment_sums(data, rag, model, dev, supersteps=12):
    """The segment sums of the last of ``supersteps`` supersteps of the
    device_bc merge loop on this section, named by their call site."""
    import glia_tpu_torch.graph.merge_bc_device as mbd
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.models.forest import make_label_scorer

    cfg = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=16)
    scorer = make_label_scorer(model, label=-1, device=dev)
    calls = capture_segment_sums(lambda: mbd.merge_order_bc_device(
        rag, cfg, scorer, max_supersteps=supersteps, device=dev))
    if len(calls) != supersteps * len(BC_SUMS):
        raise AssertionError(f"{len(calls)} segment sums in {supersteps} "
                             f"device_bc supersteps, expected "
                             f"{supersteps * len(BC_SUMS)}")
    return bc_superstep_sums(calls, supersteps - 1)


def phase_kernel_segment(data, rag, model, dev, seed):
    """Kernel B2 (segment sum), both entry points, at the shapes the
    engine="device" path and the device_bc loop give it on this section
    (taken from the merge engines' own calls), at [200000, 8] ->
    [4096, 8] with random ids, with and without padding ids, and with one
    run much longer than a tile."""
    import glia_tpu_torch.graph.merge_device as md

    pb, R = data["pb"], rag.n_regions
    u, v, s, c = md.edge_mean_arrays(rag, pb)
    _, _, h = md.edge_hist_arrays(rag, pb, n_bins=32)
    one = dict(max_supersteps=1, device=dev)
    mean = capture_segment_sums(
        lambda: md.merge_batched_device(u, v, s, c, R, **one))
    median = capture_segment_sums(
        lambda: md.merge_batched_device_hist(u, v, h, R, **one))
    minsize = capture_segment_sums(
        lambda: md.merge_batched_device_hist_minsize(u, v, h, rag.sizes, R,
                                                     **one))
    exact = capture_segment_sums(
        lambda: md.merge_batched_device_exact(u, v, s, c, R, device=dev))
    cases = [("dedupe_mean", *mean[0]), ("dedupe_median", *median[0]),
             ("vertex_sizes", *minsize[1]), ("lca_keys", *exact[-2])]
    if not (mean[0][3] and median[0][3] and exact[-2][3]) or minsize[1][3]:
        raise AssertionError("the merge engine's segment sums are not the "
                             "ones this phase expects")
    cases += device_bc_segment_sums(data, rag, model, dev)

    rng = np.random.default_rng(seed + 2)
    B, F, S = 200000, 8, 4096
    vals = torch.as_tensor(rng.random((B, F), np.float32), device=dev)
    ids = torch.as_tensor(rng.integers(0, S, B), device=dev)
    padded = ids.clone()
    padded[torch.as_tensor(rng.random(B) < 0.1, device=dev)] = S + 5
    padded[:1000] = -1
    ids_sorted = torch.sort(ids).values
    sorted_padded = ids_sorted.clone()
    sorted_padded[:1000] = -1
    sorted_padded[-10000:] = S
    # short runs, one run of 30,000 rows (many tiles), short runs again
    long_run = torch.sort(ids[:50000] % 512).values
    long_run[10000:40000] = long_run[10000]
    cases += [("random", vals, ids, S, False),
              ("random_padded", vals, padded, S, False),
              ("random_sorted", vals, ids_sorted, S, True),
              ("random_sorted_padded", vals, sorted_padded, S, True),
              ("long_run", vals[:50000].contiguous(), long_run, 512, True)]
    return [check_segment_sum(*case, prev_ms=B2_PREV_MS.get(case[0]))
            for case in cases]


def segment_sum_line(shapes):
    """Kernel B2's entry of the ``kernels`` line: the headline numbers are
    those of the default policy's superstep (the median sketch's dedupe on
    the data section); every shape is listed beside them."""
    head = next(r for r in shapes if r["shape"] == "dedupe_median")
    return {"name": "segment_sum", "route": "cuda",
            "source": "glia_tpu_torch/ops/cuda/segment_sum.cu",
            "replaces": "glia_tpu/ops/pallas/segment_csr.py:47",
            "launches": None, "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "max_rel_err": max(r["max_rel_err"] for r in shapes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "call_ms": head["call_ms"],
            "library_call_ms": head["library_call_ms"], "shapes": shapes}


def phase_slice_device(data, seg, rag, dev, seed, n_trees, max_depth):
    """hmt_segment(engine="device") on the card for the policies mean and
    median, forest probabilities by the device walk.  Returns the launch
    counts of each run and kernel B1's check at this path's batch."""
    import glia_tpu_torch.graph.merge_device as md
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.features.hierarchical import TreeFeatures
    from glia_tpu_torch.ops import cuda as kcuda
    from glia_tpu_torch.pipeline import HmtModel, evaluate, hmt_segment

    pb, intensity, R = data["pb"], data["intensity"], rag.n_regions
    # set-up: a forest on this path's own features, the 148 columns of
    # bc_features() with the saliencies
    t = time.perf_counter()
    order, sals = md.greedy_merge_device(rag, pb, policy="mean", device=dev)
    cfg = FeatureConfig.standard(pb, intensity, n_bins=16)
    X = TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()
    forest = random_forest(X, n_trees, max_depth,
                           np.random.default_rng(seed + 3))
    setup_s = time.perf_counter() - t
    b1 = phase_kernel(torch.as_tensor(X, device=dev).to(torch.float32)
                      .contiguous(), forest, seed, path="device")

    u, v, s, c = md.edge_mean_arrays(rag, pb)
    _, _, h = md.edge_hist_arrays(rag, pb, n_bins=32)
    paths = {}
    for policy in ("mean", "median"):
        hmt = HmtModel(forest=forest, n_bins=16, policy=policy)
        stats = {}
        kcuda.reset_launches()
        t = time.perf_counter()
        out, info = hmt_segment(pb, intensity, hmt, engine="device",
                                backend="device", device=dev, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(kcuda.launches)
        ev = evaluate(out, data["truth"])

        if not np.array_equal(info["seg0"], seg):
            raise AssertionError("hmt_segment's over-segmentation differs "
                                 "from the data phase's")
        check_order(info["order"], info["probs"], R, int(rag.keys.max()))
        if out.shape != pb.shape:
            raise AssertionError(f"segmentation shape {out.shape}")
        if not all(np.isfinite(x) for x in ev.values()):
            raise AssertionError(f"non-finite metrics {ev}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"device path (policy {policy})")
        if launches["forest_votes"] != 1:
            raise AssertionError("forest_votes should launch once")
        if launches["segment_sum"] < stats["n_supersteps"]:
            raise AssertionError("segment_sum should launch in every "
                                 "superstep")

        # the merge alone, twice more, after the main path's call on this
        # shape: both run its memoized plan as a CUDA graph (the first may
        # capture it); do they agree, and with the main path's order
        rerun_stats = [{}, {}]
        runs = [md.greedy_merge_device(rag, pb, policy=policy, device=dev,
                                       stats=st) for st in rerun_stats]
        rerun = agreement(*runs[0], *runs[1])
        rerun["order_equals_main_path"] = all(
            np.array_equal(o, info["order"]) for o, _ in runs)
        rerun["plan_graph"] = [st.get("plan_graph") for st in rerun_stats]
        if not (rerun["identical"] and rerun["order_equals_main_path"]):
            raise AssertionError(f"card runs of engine=\"device\" (policy "
                                 f"{policy}) differ in rows or saliencies: "
                                 f"{rerun}")
        if rerun["plan_graph"] != [True, True]:
            raise AssertionError(f"engine=\"device\" (policy {policy}): a "
                                 f"merge after the first on its shape did "
                                 f"not replay a CUDA graph: {rerun}")

        # the merge loop alone, in the path's mode="fused_ms": wall, then
        # kernels and busy time profiled
        def merge_loop(st):
            kw = dict(mode="fused_ms", device=dev, stats=st)
            if policy == "mean":
                md.merge_batched_device(u, v, s, c, R, **kw)
            else:
                md.merge_batched_device_hist(u, v, h, R, **kw)
            torch.cuda.synchronize()

        loop_stats = {}
        merge_loop({})           # the merge alone's graph, captured once
        t = time.perf_counter()
        merge_loop(loop_stats)
        loop_s = time.perf_counter() - t
        prof = profile_run(lambda: merge_loop({}))
        n_steps = loop_stats["n_supersteps"]
        prof.update(
            supersteps=n_steps, buckets=loop_stats["buckets"],
            plan_graph=loop_stats["plan_graph"],
            wall_ms_unprofiled=loop_s * 1e3,
            kernels_per_superstep=prof["kernels_launched"] / n_steps,
            busy_share_of_unprofiled_wall=prof["device_busy_ms"]
            / (loop_s * 1e3))

        line = {"phase": "slice_device", "policy": policy, "wall_s": wall,
                "stages_s": {k: x for k, x in stats.items()
                             if k.startswith("t_")},
                "R": R, "E": int(len(u)), "D": int(X.shape[1]),
                "supersteps": stats["n_supersteps"],
                "merges": int(len(info["order"])),
                "n_picks": info["n_picks"], "launches": launches,
                "merge_loop_profile": prof, "rerun": rerun, "eval": ev}
        if policy == "mean":
            # exact saliencies on the card (float32) against the serial
            # host replay (float64) of the same order
            o, _, n_m = md.merge_batched_device(u, v, s, c, R,
                                                mode="fused_ms", device=dev)
            ex = md.exact_saliency_device(u, v, s, c, o, R, device=dev)
            ex = ex[:n_m].double().cpu().numpy()
            host = md.replay_exact_saliency(u, v, s, c,
                                            o[:n_m].cpu().numpy())
            if not np.array_equal(np.isnan(ex), np.isnan(host)):
                raise AssertionError("exact saliencies: NaN rows differ "
                                     "from the serial replay's")
            ok = ~np.isnan(host)
            rel = float(np.max(np.abs(ex[ok] - host[ok])
                               / np.maximum(np.abs(host[ok]), 1e-12)))
            if rel > 1e-4:
                raise AssertionError(f"exact saliencies differ from the "
                                     f"serial replay by {rel} relative")
            line["exact_saliency"] = {"sal_L": stats["sal_L"],
                                      "nan_rows": int((~ok).sum()),
                                      "max_rel_err_vs_replay": rel}
        emit(line)
        paths[f"device_{policy}"] = launches
    emit({"phase": "slice_device", "setup_s": setup_s,
          "forest": {"trees": forest.n_trees,
                     "nodes_padded": int(forest.feature.shape[1]),
                     "max_depth": forest.max_depth}})
    return paths, b1, forest


# weights of a training on the card in float64 against the same training on
# the CPU in float64: the tolerance of the CPU parity tests (port against
# glia_tpu), relative to the largest weight
TRAIN_RTOL = 1e-6
# Adam steps per EM round of the MLP2 trainings held to TRAIN_RTOL. Under
# glia_tpu's schedule (3 rounds of 500) the MLP2 trajectory is chaotic: any
# two summation orders end on unrelated weights (the CPU tests hold the port
# to glia_tpu for 3 rounds of 50, as here); the full training's card-CPU
# gap is printed, not gated
MLP_HORIZON_STEPS = (25, 50, 100)
MLP_GATED_STEPS = 50


def weight_gap(w, ref):
    return float(np.max(np.abs(w - ref)) / max(np.max(np.abs(ref)), 1e-300))


def resolve_with(model, feats, order, seg0, mode, dev, dtype=None):
    """The final segmentation ``model`` gives on merge features already
    computed: probabilities on the card, tree resolution, relabeling."""
    from glia_tpu_torch.graph.tree import build_tree, node_potentials
    from glia_tpu_torch.infer.ccm import segment_ccm_picks
    from glia_tpu_torch.infer.greedy import resolve_tree_greedy
    from glia_tpu_torch.infer.segment import final_segmentation

    probs = model.predict_merge_prob(feats, device=dev, dtype=dtype)
    tree = build_tree(order)
    picks = (segment_ccm_picks(tree, probs) if mode == "ccm" else
             resolve_tree_greedy(tree, node_potentials(tree, probs)))
    return final_segmentation(seg0, tree, picks), probs


def retrain_checks(train, model, feats, order, seg0, mode, main_seg, dev,
                   gate_cpu=True):
    """The training of ``model`` (on the card in float64) three more times
    on the same samples: on the card in float64 (the same weights, bit for
    bit), on the CPU in float64 (weights within TRAIN_RTOL if
    ``gate_cpu``), in the card's default dtype (printed only).  Each
    model's largest relative weight gap, its largest probability gap on the
    test section's merges (float64 on the card) and the VI between its
    final segmentation and the main model's.  Returns (runs, failures)."""
    from glia_tpu_torch.metrics import eval_vi

    seg, _ = resolve_with(model, feats, order, seg0, mode, dev)
    if not np.array_equal(seg, main_seg):
        raise AssertionError("resolving the main model's probabilities "
                             "again does not give the main path's "
                             "segmentation")
    seg_main, p_main = resolve_with(model, feats, order, seg0, mode, dev,
                                    torch.float64)
    runs, failures = {}, []
    for run, kw in (("card_f64_again", {"device": dev,
                                        "dtype": torch.float64}),
                    ("cpu_f64", {"device": "cpu", "dtype": torch.float64}),
                    ("card_default", {"device": dev})):
        st = {}
        t = time.perf_counter()
        other = train(stats=st, **kw)
        seconds = time.perf_counter() - t
        seg, p = resolve_with(other, feats, order, seg0, mode, dev,
                              torch.float64)
        w, w0 = other.extra["w"], model.extra["w"]
        runs[run] = {"seconds": seconds, "t_optimizer": st["t_optimizer"],
                     "steps_per_s": st["n_steps"] / st["t_optimizer"],
                     "identical_weights": bool(np.array_equal(w, w0)),
                     "max_rel_weight_gap": weight_gap(w, w0),
                     "max_prob_gap": float(np.max(np.abs(p - p_main))),
                     "vi_to_main_segmentation": eval_vi(seg, seg_main)[2]}
    if not runs["card_f64_again"]["identical_weights"]:
        failures.append("two float64 trainings on the card gave different "
                        "weights")
    if gate_cpu and runs["cpu_f64"]["max_rel_weight_gap"] > TRAIN_RTOL:
        failures.append(f"card and CPU float64 weights differ by "
                        f"{runs['cpu_f64']['max_rel_weight_gap']} relative "
                        f"(limit {TRAIN_RTOL})")
    return runs, failures


def mlp_horizon(samples, dev):
    """MLP2 (16, 8) trainings of MLP_HORIZON_STEPS Adam steps a round on
    the same samples, twice on the card and once on the CPU in float64:
    how far the card and the CPU agree as the trajectory lengthens."""
    from glia_tpu_torch.models.train_ensemble import train_mlp_supervised

    out = {}
    for steps in MLP_HORIZON_STEPS:
        w = [train_mlp_supervised(*samples, hidden=(16, 8), steps=steps,
                                  device=d, dtype=torch.float64)["w"]
             for d in (dev, dev, "cpu")]
        out[str(steps)] = {"adam_steps": 3 * steps,
                           "card_identical": bool(np.array_equal(w[0], w[1])),
                           "max_rel_weight_gap": weight_gap(w[2], w[0])}
    return out


def capture_calls(module, name, fn):
    """Run ``fn()`` with ``module.<name>`` wrapped; return (its result, the
    (arguments, result) of every call of ``module.<name>`` it made)."""
    calls = []
    real = getattr(module, name)

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out

    setattr(module, name, record)
    try:
        return fn(), calls
    finally:
        setattr(module, name, real)


def labeling_energy(tree, picks, em, es):
    """The CCM energy of the labeling ``picks``, summed node by node
    (infer/ccm.py's model): ``em`` of every node at or below a pick, ``es``
    of every node above one, over the root's subtree.  Raises unless every
    leaf of that subtree lies under exactly one pick."""
    n = tree.n_nodes
    picked = np.zeros(n, dtype=np.int64)
    picked[np.asarray(picks, dtype=np.int64)] = 1
    cover = np.zeros(n, dtype=np.int64)   # picks at or above the node
    under = np.zeros(n, dtype=bool)       # in the root's subtree
    for i in range(n - 1, -1, -1):        # a parent comes after its children
        p = int(tree.parent[i])
        cover[i] = picked[i] + (cover[p] if p >= 0 else 0)
        under[i] = i == tree.root or (p >= 0 and under[p])
    if not np.all(cover[under & tree.is_leaf] == 1):
        raise AssertionError("picks do not cover each leaf once")
    return float(em[under & (cover == 1)].sum()
                 + es[under & (cover == 0)].sum())


def ccm_check(model, feats, order, seg0, truth, dev):
    """mode="ccm" on ``model``'s probabilities (not near-constant): the
    picks must be more than one, cover each leaf once, and have the energy
    of the dynamic programme's optimum (min(EM, ES) at the root, to 1e-9
    relative), no larger than the greedy picks' energy."""
    from glia_tpu_torch.graph.tree import build_tree, node_potentials
    from glia_tpu_torch.infer import ccm
    from glia_tpu_torch.infer.greedy import resolve_tree_greedy
    from glia_tpu_torch.infer.segment import final_segmentation
    from glia_tpu_torch.pipeline import evaluate

    probs = model.predict_merge_prob(feats, device=dev)
    tree = build_tree(order)
    t = time.perf_counter()
    picks = ccm.segment_ccm_picks(tree, probs)
    seconds = time.perf_counter() - t
    em, es = ccm.node_energies(tree, probs)
    EM, ES = ccm.compute_energy_tuples(tree, em, es)
    best = float(min(EM[tree.root], ES[tree.root]))
    energy = labeling_energy(tree, picks, em, es)
    greedy = labeling_energy(
        tree, resolve_tree_greedy(tree, node_potentials(tree, probs)), em,
        es)
    out = {"n_picks": len(picks), "seconds": seconds, "energy": energy,
           "optimum": best, "greedy_energy": greedy,
           "prob_quartiles": np.quantile(probs, [0.25, 0.5, 0.75]).tolist(),
           "eval": evaluate(final_segmentation(seg0, tree, picks), truth)}
    if len(picks) < 2:
        raise AssertionError(f"CCM merged everything: {out}")
    if abs(energy - best) > 1e-9 * max(abs(best), 1.0) or not (
            energy <= greedy):
        raise AssertionError(f"CCM picks are not the optimum: {out}")
    return out


def segment_section(name, model, data, seg, rag, dev, paths, **kw):
    """hmt_segment on the data section with ``model`` and ``kw``: launch
    counts into ``paths[name]``; the over-segmentation must be the data
    phase's, the order a valid merge forest and the metrics finite.
    Returns (segmentation, info, the forest_votes_cuda calls made, the
    fields of its JSON line)."""
    import glia_tpu_torch.pipeline as tp
    from glia_tpu_torch.ops import cuda as kcuda

    pb, intensity, truth = data["pb"], data["intensity"], data["truth"]
    stats = {}
    kcuda.reset_launches()
    t = time.perf_counter()
    (out, info), calls = capture_calls(
        kcuda, "forest_votes_cuda", lambda: tp.hmt_segment(
            pb, intensity, model, device=dev, stats=stats, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    paths[name] = dict(kcuda.launches)
    if not np.array_equal(info["seg0"], seg):
        raise AssertionError(f"{name}: over-segmentation differs from the "
                             f"data phase's")
    check_order(info["order"], info["probs"], rag.n_regions,
                int(rag.keys.max()))
    ev = tp.evaluate(out, truth)
    if out.shape != pb.shape or not all(np.isfinite(x) for x in ev.values()):
        raise AssertionError(f"{name}: segmentation {out.shape}, metrics "
                             f"{ev}")
    return out, info, calls, {
        "wall_s": wall, "launches": paths[name],
        "stages_s": {k: x for k, x in stats.items() if k.startswith("t_")},
        "merges": int(len(info["order"])), "n_picks": info["n_picks"],
        "eval": ev}


def phase_slice_train(data, seg, rag, forest, dev, side, seed):
    """Training at full size, then segmenting with the trained models:

    - hmt_train(classifier="mlp", mlp_hidden=(16, 8)) on two labeled
      sections, then hmt_segment(engine="device") with it (kernel B2);
    - hmt_train_sshmt on one section labeled at label_fraction 0.5 and one
      unlabeled (glia_tpu's defaults: 5 EM rounds of 150 Adam steps,
      lr 0.2), then hmt_segment(engine="host", mode="ccm") with it;
    - hmt_segment(engine="host", backend="device") with ``forest`` (kernel
      B1 on the serial merge order's features).

    Both trainings run on the card in float64, and again three times (see
    retrain_checks).  Returns (launch counts per path, kernel B1's check
    at the host path's batch)."""
    import glia_tpu_torch.graph.merge_device as md
    import glia_tpu_torch.pipeline as tp
    from glia_tpu_torch.data.synthetic import synthetic_em_slice
    from glia_tpu_torch.learn.sshmt import train_sshmt
    from glia_tpu_torch.models.train_ensemble import train_mlp_supervised
    from glia_tpu_torch.native import greedy_merge_native

    t_phase = time.perf_counter()
    pb, intensity, truth = data["pb"], data["intensity"], data["truth"]
    baseline = tp.evaluate(seg, truth)
    t = time.perf_counter()
    sections = [synthetic_em_slice((side, side), n_cells=(side // 17) ** 2,
                                   seed=seed + 11 + i) for i in range(4)]
    data_s = time.perf_counter() - t
    paths = {}

    def segment(name, model, **kw):
        return segment_section(name, model, data, seg, rag, dev, paths, **kw)

    # MLP2, supervised, on two labeled sections; the samples hmt_train
    # computed are kept to train again on them, and with the sections'
    # merges (the arguments of _features_for) for slice_forest
    st = {}
    (mlp, calls), merges = capture_calls(
        tp, "_features_for", lambda: capture_calls(
            tp, "training_samples", lambda: tp.hmt_train(
                sections[:2], classifier="mlp", mlp_hidden=(16, 8),
                device=dev, dtype=torch.float64, stats=st)))
    samples = calls[0][1]
    forest_inputs = {"sections": sections, "samples": samples,
                     "train_merges": [c[0] for c in merges]}
    out, info, _, seg_line = segment("train_mlp_device", mlp,
                                     engine="device")
    if paths["train_mlp_device"]["segment_sum"] == 0:
        raise AssertionError("segment_sum never launched on the device "
                             "path with the trained MLP")
    order, sals = md.greedy_merge_device(rag, pb, policy=mlp.policy,
                                         device=dev)
    feats = tp._features_for(seg, pb, intensity, mlp, order, sals)
    runs, failures = retrain_checks(
        lambda **k: replace(mlp, extra=train_mlp_supervised(
            *samples, hidden=(16, 8), **k)),
        mlp, feats, order, seg, "greedy", out, dev, gate_cpu=False)
    horizon = mlp_horizon(samples, dev)
    gated = horizon[str(MLP_GATED_STEPS)]
    if not gated["card_identical"]:
        failures.append(f"two float64 card trainings of {MLP_GATED_STEPS} "
                        f"steps a round gave different weights")
    if gated["max_rel_weight_gap"] > TRAIN_RTOL:
        failures.append(f"card and CPU float64 weights after "
                        f"{MLP_GATED_STEPS} steps a round differ by "
                        f"{gated['max_rel_weight_gap']} relative (limit "
                        f"{TRAIN_RTOL})")
    emit({"phase": "slice_train", "model": "mlp", "samples": list(
              samples[0].shape), "merge_labels": int((samples[1] < 0).sum()),
          "stages_s": {k: x for k, x in st.items() if k.startswith("t_")},
          "steps": st["n_steps"],
          "steps_per_s": st["n_steps"] / st["t_optimizer"],
          "rounds": st["rounds"], "sigma_s": st["sigma_s"], "retrain": runs,
          "card_vs_cpu_by_steps_per_round": horizon,
          "ccm": ccm_check(mlp, feats, order, seg, truth, dev),
          "segment": seg_line, "baseline_eval": baseline})
    if failures:
        raise AssertionError(f"MLP training: {failures}")

    # SSHMT Logsig: one section labeled at 0.5, one unlabeled
    st = {}
    (logsig, calls), merges = capture_calls(
        tp, "_features_for", lambda: capture_calls(
            tp, "sshmt_samples", lambda: tp.hmt_train_sshmt(
                sections[2:3], sections[3:], label_fraction=0.5,
                device=dev, dtype=torch.float64, stats=st)))
    samples = calls[0][1]
    forest_inputs["held_out_merges"] = merges[0][0]

    def train_logsig(**k):
        w = train_sshmt(samples["feats"], samples["orders"],
                        samples["sup_X"], samples["sup_y"],
                        classifier="logsig", n_sigma_update=5,
                        inner_steps=150, lr=0.2, **k)["w"]
        return replace(logsig, extra={**logsig.extra, "w": w})

    out, info, _, seg_line = segment("sshmt_host_ccm", logsig,
                                     engine="host", mode="ccm")
    order, sals = greedy_merge_native(rag, pb, policy=logsig.policy)
    feats = tp._features_for(seg, pb, intensity, logsig, order, sals)
    runs, failures = retrain_checks(train_logsig, logsig, feats, order, seg,
                                    "ccm", out, dev)
    hist = logsig.extra["history"]
    emit({"phase": "slice_train", "model": "logsig",
          "paths": sum(len(f) for f in samples["feats"]),
          "supervised": int(len(samples["sup_y"])),
          "D": int(samples["feats"][0].shape[1]),
          "stages_s": {k: x for k, x in st.items() if k.startswith("t_")},
          "steps": st["n_steps"],
          "steps_per_s": st["n_steps"] / st["t_optimizer"],
          "rounds": st["rounds"], "sigma_u": st["sigma_u"],
          "sigma_s": st["sigma_s"], "energy": hist[-1]["energy"],
          "retrain": runs, "segment": seg_line,
          "baseline_eval": baseline})
    if failures:
        raise AssertionError(f"SSHMT training: {failures}")

    # the seeded forest on the serial merge order: kernel B1 on the host path
    hmt = tp.HmtModel(forest=forest, n_bins=16)
    _, _, calls, seg_line = segment("host_forest", hmt, engine="host",
                                    backend="device")
    if paths["host_forest"]["forest_votes"] != 1 or len(calls) != 1:
        raise AssertionError("forest_votes should launch once on the host "
                             "path")
    emit({"phase": "slice_train", "path": "host_forest", "segment": seg_line,
          "data_s": data_s, "phase_s": time.perf_counter() - t_phase})
    b1 = phase_kernel(calls[0][0][0], forest, seed, path="host")
    return paths, b1, forest_inputs


# trees of the trained forests (hmt_train's default) and the seed
FOREST_TREES = 100
# wall seconds slice_forest should stay under; where training the first
# forest alone takes longer, the device_bc forest gets fewer trees
FOREST_PHASE_S = 90.0
# side of the data section's top-left corner that the serial C++ BC engine
# runs on: on the whole 1024^2 section it took 795.2 s (NVIDIA H100 80GB
# HBM3 machine, 700 W), far past the script's time limit
BC_SIDE = 512


def forest_shape(model):
    """Real nodes in all, in the largest tree, depth."""
    _, inner, leaves = node_shape(model)
    per_tree = (model.feature != -1).sum(axis=1)
    return {"trees": model.n_trees, "nodes": inner + leaves,
            "largest_tree": int(per_tree.max()),
            "mean_tree": float(per_tree.mean()), "max_depth": model.max_depth}


def same_forest(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in
               ("feature", "threshold", "left", "right", "leaf_class")) and (
        a.max_depth == b.max_depth)


def phase_slice_forest(data, seg, dev, inputs, seed):
    """Forests trained by the port (models.forest.train_forest, the C++
    CART trainer) on slice_train's samples, then segmenting with them:

    - a forest of FOREST_TREES trees on the 148-wide samples of the two MLP
      sections (hmt_train(classifier="rf")'s training): trained three
      times (again, and on one thread; identical arrays or the script
      fails), its error on the held-out section's merges (below the
      majority class's or the script fails), hmt_segment(engine="host")
      and (engine="device") with backend="device" (kernel B1 on the
      trained trees, held against the plain walk);
    - a forest on the same merges' 143-wide features (no saliencies), then
      hmt_segment(engine="device_bc") with it, twice (identical rows and
      probabilities, and 0 vote fractions of B1 differing from the plain
      walk on every batch of the second loop, or the script fails), and
      the serial C++ BC engine (native.greedy_merge_bc_native) with it
      and device_bc again on the section's top-left BC_SIDE^2 corner;
    - hmt_train(classifier="rf_ensemble") on the two sections, then
      hmt_segment(engine="host", backend="device") with it.

    Returns (launch counts per path, kernel B1's checks)."""
    import os

    import glia_tpu_torch.pipeline as tp
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.features.hierarchical import TreeFeatures
    from glia_tpu_torch.features.labels import bc_labels
    from glia_tpu_torch.graph.merge_bc_device import merge_order_bc_device
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.graph.tree import build_tree, node_potentials
    from glia_tpu_torch.infer.greedy import resolve_tree_greedy
    from glia_tpu_torch.infer.segment import final_segmentation
    from glia_tpu_torch.metrics import eval_vi
    from glia_tpu_torch.models.ensemble import distribute
    from glia_tpu_torch.models.forest import (ForestTables,
                                              forest_votes_torch,
                                              make_label_scorer,
                                              pack_nodes,
                                              predict_label_fraction,
                                              train_forest)
    from glia_tpu_torch.native import greedy_merge_bc_native

    t_phase = time.perf_counter()
    pb, intensity = data["pb"], data["intensity"]
    rag = build_rag(seg, contour_only=False)
    X, y = inputs["samples"]
    cores = os.cpu_count() or 1
    paths, b1, failures = {}, [], []

    def train(X, y, n_trees=FOREST_TREES, n_jobs=-1):
        t = time.perf_counter()
        m = train_forest(X, y, n_trees=n_trees, seed=0, n_jobs=n_jobs)
        return m, time.perf_counter() - t

    def segment(name, model, **kw):
        out = segment_section(name, model, data, seg, rag, dev, paths, **kw)
        if paths[name]["forest_votes"] == 0:
            raise AssertionError(f"{name}: forest_votes never launched")
        return out

    # the forest of hmt_train(classifier="rf") on the two MLP sections
    forest, train_s = train(X, y)
    again, again_s = train(X, y)
    single, single_s = train(X, y, n_jobs=1)
    if not same_forest(forest, again):
        failures.append("two trainings with one seed gave different forests")
    if not same_forest(forest, single):
        failures.append(f"n_jobs=1 and n_jobs={cores} gave different forests")
    seg_h, pb_h, int_h, _, order_h, sals_h = inputs["held_out_merges"]
    X_h = tp._features_for(seg_h, pb_h, int_h, tp.HmtModel(forest=None),
                           order_h, sals_h)
    y_h = bc_labels(seg_h, inputs["sections"][2]["truth"], order_h,
                    rule="f1")[0]
    p_h = predict_label_fraction(forest, X_h, label=-1, backend="device",
                                 device=dev)
    held_out = {"merges": int(len(y_h)),
                "error": float(np.mean((p_h > 0.5) != (y_h == -1))),
                "majority_error": float(min(np.mean(y_h == -1),
                                            np.mean(y_h == 1)))}
    if not held_out["error"] < held_out["majority_error"]:
        failures.append(f"held-out error not below the majority class's: "
                        f"{held_out}")
    hmt = tp.HmtModel(forest=forest, n_bins=16)
    lines = {}
    for engine in ("host", "device"):
        name = f"forest_{engine}"
        _, _, calls, lines[engine] = segment(name, hmt, engine=engine,
                                             backend="device")
        if paths[name]["forest_votes"] != 1 or len(calls) != 1:
            raise AssertionError(f"{name}: forest_votes should launch once")
        b1.append(phase_kernel(calls[0][0][0], forest, seed, path=name))
    emit({"phase": "slice_forest", "forest": "rf", "D": int(X.shape[1]),
          "samples": int(len(y)), "merge_labels": int((y < 0).sum()),
          "cores": cores, "train_s": train_s, "train_again_s": again_s,
          "train_one_thread_s": single_s, "shape": forest_shape(forest),
          "mean_steps": {e: r["mean_steps"] for e, r in
                         zip(("host", "device"), b1)},
          "held_out": held_out, "segment": lines})

    # the device_bc forest: the same merges' 143-wide features
    t = time.perf_counter()
    X_bc = np.concatenate([
        TreeFeatures(build_rag(s_, contour_only=False), o_,
                     FeatureConfig.standard(p_, i_, n_bins=16),
                     saliencies=None).bc_features()
        for s_, p_, i_, _, o_, _ in inputs["train_merges"]])
    features_s = time.perf_counter() - t
    # fewer trees only where one training of FOREST_TREES trees alone
    # overran the phase's budget
    bc_trees = (FOREST_TREES if train_s < FOREST_PHASE_S else
                max(10, int(FOREST_TREES * FOREST_PHASE_S / train_s / 4)))
    bc_forest, bc_train_s = train(X_bc, y, n_trees=bc_trees)
    bc_hmt = tp.HmtModel(forest=bc_forest, n_bins=16)
    _, info_bc, _, line_bc = segment("forest_device_bc", bc_hmt,
                                     engine="device_bc")

    # the loop again: the same rows and probabilities, every batch of B1
    # held against the plain walk (a comparison outside the counted run)
    cfg = FeatureConfig.standard(pb, intensity, n_bins=16)
    scorer = make_label_scorer(bc_forest, label=-1, device=dev)
    tables = ForestTables.from_model(bc_forest, dev)
    li = int(np.nonzero(bc_forest.classes == -1)[0][0])
    kept, batch_check = [], {"batches": 0, "mismatches": 0}

    def checked(Xb):
        out = scorer(Xb)
        want = forest_votes_torch(Xb, tables)[:, li]
        batch_check["batches"] += 1
        batch_check["mismatches"] += int((out != want).sum())
        # the 12th superstep's batch is timed, or the last where the loop
        # is shorter
        if batch_check["batches"] <= 12:
            kept[:] = [Xb.to(torch.float32).contiguous().clone()]
        return out

    order2, probs2 = merge_order_bc_device(rag, cfg, checked, device=dev)
    torch.cuda.synchronize()
    rerun = agreement(info_bc["order"], info_bc["probs"], order2, probs2)
    if not rerun["identical"]:
        failures.append(f"two device_bc runs with the trained forest "
                        f"differ: {rerun}")
    if batch_check["mismatches"]:
        failures.append(f"B1 on the device_bc loop's batches: "
                        f"{batch_check['mismatches']} vote fractions differ "
                        f"from the plain walk")
    if paths["forest_device_bc"]["forest_votes"] != batch_check["batches"]:
        failures.append("forest_votes should launch once per superstep of "
                        "the device_bc loop")
    b1.append(phase_kernel(kept[0], bc_forest, seed, path="forest_device_bc"))

    # the serial C++ BC engine with the same forest, and device_bc beside
    # it, on the data section's top-left BC_SIDE^2 corner: each of its
    # merges sums the merged region's boundary over all of its neighbours
    # again, in the reference's order, which grows faster than the number
    # of regions
    crop = {k: np.ascontiguousarray(data[k][:BC_SIDE, :BC_SIDE])
            for k in ("pb", "intensity", "truth")}
    seg_c = tp.pre_merge(tp.watershed(crop["pb"], 0.05), crop["pb"], (30,))
    rag_c = build_rag(seg_c, contour_only=False)
    cfg_c = FeatureConfig.standard(crop["pb"], crop["intensity"], n_bins=16)
    t = time.perf_counter()
    order_n, probs_n = greedy_merge_bc_native(rag_c, cfg_c, bc_forest)
    native_s = time.perf_counter() - t
    check_order(order_n, probs_n, rag_c.n_regions, int(rag_c.keys.max()))
    tree = build_tree(order_n)
    seg_n = final_segmentation(
        seg_c, tree,
        resolve_tree_greedy(tree, node_potentials(tree, probs_n)))
    seg_d, info_d = tp.hmt_segment(crop["pb"], crop["intensity"], bc_hmt,
                                   engine="device_bc", device=dev)
    emit({"phase": "slice_forest", "forest": "rf_bc", "D": int(
              X_bc.shape[1]), "trees": bc_trees,
          "trees_cut": bc_trees < FOREST_TREES, "features_s": features_s,
          "train_s": bc_train_s, "shape": forest_shape(bc_forest),
          "segment": line_bc, "rerun": rerun, "b1_loop_check": batch_check,
          "native_bc": {"side": BC_SIDE, "regions": rag_c.n_regions,
                        "merges": int(len(order_n)), "wall_s": native_s,
                        "eval": tp.evaluate(seg_n, crop["truth"]),
                        "device_bc_merges": int(len(info_d["order"])),
                        "device_bc_eval": tp.evaluate(seg_d, crop["truth"]),
                        "vi_to_device_bc": eval_vi(seg_n, seg_d)[2]}})

    # the ensemble, through hmt_train
    st = {}
    ens_model, calls = capture_calls(
        tp, "training_samples", lambda: tp.hmt_train(
            inputs["sections"][:2], classifier="rf_ensemble", stats=st))
    if not (np.array_equal(calls[0][1][0], X)
            and np.array_equal(calls[0][1][1], y)):
        raise AssertionError("hmt_train's samples differ from slice_train's")
    ens = ens_model.extra["ensemble"]
    groups = np.bincount(distribute(X, ens.dim0, ens.dim1, ens.threshold),
                         minlength=3)
    _, _, calls, line_ens = segment("ensemble_host", ens_model,
                                    engine="host", backend="device")
    if paths["ensemble_host"]["forest_votes"] != len(calls):
        raise AssertionError("ensemble: launch counts")
    # every launch against the plain walk of the member it served, at the
    # rows routed to that member (members without rows launch nothing)
    packed = [pack_nodes(f)[0] for f in ens.forests]
    for (args, _) in calls:
        served = [k for k, p in enumerate(packed)
                  if np.array_equal(args[1].packed.cpu().numpy(), p)]
        if len(served) != 1:
            raise AssertionError(f"ensemble: a B1 launch matches members "
                                 f"{served}")
        k = served[0]
        b1.append(phase_kernel(args[0], ens.forests[k], seed,
                               path=f"ensemble_member_{k}"))
    emit({"phase": "slice_forest", "forest": "rf_ensemble",
          "train_s": st["t_forest"], "threshold": ens.threshold,
          "groups": groups.tolist(),
          "shapes": [forest_shape(f) for f in ens.forests],
          "segment": line_ens, "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_forest: {failures}")
    return paths, b1


# bench.py's configuration (bench.py:44-68), run by glia_tpu_torch.bench:
# a 4096^2 synthetic section with (side // 14)^2 cells, seed 11, blur 1.2,
# noise 0.12, watershed at 0.004 on the pb filtered by a Gaussian of sigma
# 1; its RAG had 243,749 regions and 597,140 edges in glia_tpu
# (BENCH_r05.json)
MERGE_SIDE = 4096
MERGE_EXPECTED = {"R": 243749, "E": 597140}
# timed calls of each merge engine after its first call, as bench.py
MERGE_REPS = 5
# exact saliencies in float64 on the card against the C++ serial replay
EXACT_F64_RTOL = 1e-12
# device VI / Rand against the host's, float64 on both sides
METRIC_RTOL = 1e-12
# bench.py's JSON keys, in its order (bench.py:194-199)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def bench_line_ok(line, E, merges, reps_s, host_merges, host_s):
    """bench.py's line (bench.py:194-199) from numbers taken apart from
    it: its four keys, ``value`` = (E + merges) / the median of the timed
    calls' seconds rounded to 0.1, ``vs_baseline`` = that over the host
    serial engine's (E + its merges) / seconds, rounded to 0.001."""
    edges_s = (E + merges) / float(np.median(reps_s))
    return (list(line) == BENCH_KEYS
            and line["metric"] == "rag_merge_edges_per_s_per_chip"
            and line["unit"] == "edges/s"
            and line["value"] == round(edges_s, 1)
            and line["vs_baseline"] == round(
                edges_s / ((E + host_merges) / host_s), 3))


def rel_gap(got, want):
    """Largest |got - want| / |want| over the rows where want is defined;
    raises unless both are undefined (NaN) in the same rows."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("undefined (NaN) rows differ")
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(got[ok] - want[ok])
                        / np.maximum(np.abs(want[ok]), 1e-300)))


def host_interval_stats(tree, leaf_stats):
    """The host's all-node stats of ``ops.tree_scan``'s inputs: sums by a
    float64 prefix sum over the leaves in DFS order, minima and maxima by
    one bottom-up pass over the nodes (children come before parents)."""
    from glia_tpu_torch.graph.tree import dfs_intervals

    _, lo, hi, leaf_order = dfs_intervals(tree)
    row_of = np.full(tree.n_nodes, -1, dtype=np.int64)
    leaf_nodes = np.nonzero(tree.is_leaf)[0]
    row_of[leaf_nodes] = np.arange(len(leaf_nodes))
    out = {}
    for (kind, name), vals in leaf_stats.items():
        vals = np.asarray(vals, np.float64)
        if kind == "add":
            P = np.concatenate([np.zeros((1, vals.shape[1])),
                                np.cumsum(vals[row_of[leaf_order]], 0)])
            out[name] = P[hi] - P[lo]
            continue
        red = np.minimum if kind == "min" else np.maximum
        node = np.zeros((tree.n_nodes, vals.shape[1]))
        node[leaf_nodes] = vals
        for i in np.nonzero(~tree.is_leaf)[0]:
            node[i] = red(node[tree.left[i]], node[tree.right[i]])
        out[name] = node
    return out


def merge_switches(u_d, v_d, s_d, c_d, R, dev):
    """The multi-phase merge's two switches on bench.py's section, its plan
    memoized (merge_batched_device(mode="fused_ms") on the staged arrays):

    - GLIA_MERGE_DEBUG: one call with a stats dict runs the plan phase by
      phase; hard: the rows and saliency bits of the graph replay (a call
      without the switch), no graph replayed, its phases' supersteps
      summing to its n_supersteps, one alive count per transition and at
      most one transition fewer than phases; printed: the per-phase and
      per-transition walls and alive counts beside the replay's wall;
    - GLIA_MERGE_NOPACK64: two calls (the first captures the unpacked
      graph, the second replays it); hard: the packed call's rows and
      saliency bits, the packed graph not replayed meanwhile, then
      replayed again once the switch is off.

    Returns the printed numbers and the failures."""
    import os

    import glia_tpu_torch.graph.merge_device as md
    from glia_tpu_torch.bench import same_run

    failures = []

    def call(st=None):
        t = time.perf_counter()
        out = md.merge_batched_device(u_d, v_d, s_d, c_d, R, mode="fused_ms",
                                      stats=st, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def replays(pack64):
        return [g["replays"] for g in md.plan_graph_info()
                if (g["E"], g["R"], g["sal_L"], g["pack64"])
                == (len(u_d), R, None, pack64)]

    st_ref = {}
    call()
    ref, replay_s = call(st_ref)
    if not st_ref.get("plan_graph"):
        failures.append(f"switches: the reference call replayed no graph: "
                        f"{st_ref}")

    os.environ["GLIA_MERGE_DEBUG"] = "1"
    try:
        st_dbg = {}
        dbg, dbg_s = call(st_dbg)
    finally:
        del os.environ["GLIA_MERGE_DEBUG"]
    lists = {k: st_dbg.get(k, []) for k in md.DEBUG_KEYS}
    debug = {"wall_s": dbg_s, "replay_wall_s": replay_s,
             "plan_graph": st_dbg.get("plan_graph"),
             "n_supersteps": st_dbg.get("n_supersteps"),
             "buckets": st_dbg.get("buckets"), **lists,
             "same_as_replay": same_run(dbg, ref)}
    if not debug["same_as_replay"] or st_dbg.get("plan_graph") is not False:
        failures.append(f"GLIA_MERGE_DEBUG: rows or saliencies differ from "
                        f"the replay's, or a graph replayed: {debug}")
    if sum(lists["phase_steps"]) != st_dbg.get("n_supersteps") \
            or len(lists["phase_s"]) != len(lists["phase_steps"]) \
            or not len(lists["trans_s"]) == len(
                lists["alive_at_transition"]) <= len(lists["phase_s"]) - 1:
        failures.append(f"GLIA_MERGE_DEBUG: lists disagree: {debug}")

    packed_before = replays(True)
    os.environ["GLIA_MERGE_NOPACK64"] = "1"
    try:
        st_u1, st_u2 = {}, {}
        unp1, capture_s = call(st_u1)
        unp2, unpacked_s = call(st_u2)
    finally:
        del os.environ["GLIA_MERGE_NOPACK64"]
    packed_during = replays(True)
    unpacked = replays(False)
    st_p = {}
    _, packed_s = call(st_p)
    packed_after = replays(True)
    nopack = {"capture_call_s": capture_s, "replay_wall_s": unpacked_s,
              "packed_replay_wall_s": packed_s,
              "plan_graph": [st_u1.get("plan_graph"),
                             st_u2.get("plan_graph")],
              "same_as_packed": same_run(unp1, ref) and same_run(unp2, ref),
              "packed_graph_replays": [packed_before, packed_during,
                                       packed_after],
              "unpacked_graph_replays": unpacked}
    if not nopack["same_as_packed"] or not all(nopack["plan_graph"]) \
            or packed_during != packed_before or unpacked != [2] \
            or len(packed_after) != 1 \
            or packed_after[0] != packed_before[0] + 1 \
            or not st_p.get("plan_graph"):
        failures.append(f"GLIA_MERGE_NOPACK64: rows differ, or a graph of "
                        f"the other setting replayed: {nopack}")
    return {"debug": debug, "nopack64": nopack, "failures": failures}


def phase_slice_merge(data, seg, rag, dev):
    """bench.py's merge flow on the card at 4096^2, then the other device
    engines, the device metrics and the tree scan on the data section.

    - bench.py's flow through glia_tpu_torch.bench (setup: the section and
      the host serial mean greedy, bench.py's baseline; measure: the
      first call, the staged inputs, MERGE_REPS timed calls, the host
      replay, the three threshold cuts) with mode="fused_ms"
      (merge_batched_device_exact, the main path: the timed calls replay
      the plan program's CUDA graph, the first of them capturing it) and
      with mode="fused", each flow's launches counted; then one more
      fused_ms call whose launches are counted as a graph replay's:
      bench.py's JSON, edges/s as bench.py defines it, (E + merges) /
      median wall, supersteps, buckets, kernels per superstep and device
      busy share.  Hard: bench.py's four keys and its value; no fallback;
      both modes give the same number of merges and threshold cuts (at k
      = R - n_cells, on their exact saliencies) at VI 0.0 to each other;
      every call of an engine gives the first call's rows and saliency
      bits; every fused_ms repeat replays the one graph, whose tally of
      launches equals a counted replay's; in float64 the exact saliencies
      are within EXACT_F64_RTOL of the C++ replay.
    - the merge switches on the memoized 4096^2 plan (merge_switches,
      hard).
    - B2 against its plain version at the multi-phase engine's shapes
      (each phase's dedupe, the LCA sums) and at the new engines' and
      metrics' shapes.
    - on the data section: merge_serial_device in float64 (rows and
      saliencies equal to the CPU's bit for bit, hard; rows against the
      C++ serial engine, printed); mode="chunked" for mean and median in
      float32 (rows equal to the CPU's, hard); the plan store
      (plan_store_check, hard); vi_device /
      adapted_rand_device against the host metrics (METRIC_RTOL, hard);
      node_region_stats_device against the host's interval sums (minima,
      maxima and counts equal, sums within 1e-12 of the largest, hard).
    - at 4096^2 the sparse-pair metrics of the fused_ms cut against
      eval_vi and the host's big-integer pair counts (counts equal, VI
      within METRIC_RTOL, hard).

    Returns (launch counts per path, B2's per-shape results)."""
    import glia_tpu_torch.bench as gbench
    import glia_tpu_torch.graph.merge_device as md
    from glia_tpu_torch.bench import same_run
    import glia_tpu_torch.metrics.device as mdev
    from glia_tpu_torch.graph.merge import apply_merge_order
    from glia_tpu_torch.graph.tree import build_tree
    from glia_tpu_torch.metrics import eval_ri, eval_vi
    from glia_tpu_torch.metrics.contingency import (contingency_table,
                                                    pair_stats_from_counts)
    from glia_tpu_torch.metrics.rand import adapted_rand_from_pairs
    from glia_tpu_torch.metrics.vi import centropy
    from glia_tpu_torch.native import greedy_merge_native
    from glia_tpu_torch.ops import cuda as kcuda
    from glia_tpu_torch.ops.tree_scan import node_region_stats_device

    t_phase = time.perf_counter()
    paths, shapes, failures = {}, [], []

    def counted(name, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after, into ``paths[name]``; B2 must have launched."""
        kcuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = dict(kcuda.launches)
        if paths[name]["segment_sum"] == 0:
            raise AssertionError(f"{name}: segment_sum never launched")
        return out

    sec = gbench.setup(MERGE_SIDE)
    truth = sec.data["truth"]
    seg_b, rag_b, n_cells = sec.seg, sec.rag, sec.n_cells
    order_h, sal_h = sec.order_h, sec.sal_h
    R, E = rag_b.n_regions, rag_b.n_edges
    emit({"phase": "slice_merge", "part": "data", "side": MERGE_SIDE,
          "n_cells": n_cells, "R": R, "E": E,
          "glia_tpu_R_E": MERGE_EXPECTED,
          "same_as_glia_tpu": R == MERGE_EXPECTED["R"]
          and E == MERGE_EXPECTED["E"], "setup_s": sec.setup_s})

    u, v, s, c = sec.edges
    # inputs staged on the card once, as bench.py does
    u_d = torch.as_tensor(u, device=dev).long()
    v_d = torch.as_tensor(v, device=dev).long()
    s_d = torch.as_tensor(s, device=dev).float()
    c_d = torch.as_tensor(c, device=dev).float()

    def run_exact(mode, st):
        return gbench.run_exact(mode, u_d, v_d, s_d, c_d, R, dev, st)

    engines, firsts, lines = {}, {}, {}
    for mode in ("fused_ms", "fused"):
        res = counted(f"merge_{mode}",
                      lambda: gbench.measure(sec, mode, MERGE_REPS, dev))
        first = res["outputs"]["first"]
        st = res["first_stats"]
        line = res["result"]
        lines[mode] = line
        if not bench_line_ok(line, E, res["outputs"]["last"][2],
                             res["reps_s"], len(order_h), sec.host_s):
            failures.append(f"{mode}: bench's line is not bench.py's: "
                            f"{line}")
        if not res["reps_identical"]:
            failures.append(f"{mode}: two card runs differ in rows or "
                            f"saliencies")
        med = res["median_s"]
        prof = profile_run(lambda: run_exact(mode, {}))
        steps = st["n_supersteps"]
        prof.update(kernels_per_superstep=prof["kernels_launched"] / steps,
                    busy_share_of_median_wall=prof["device_busy_ms"]
                    / (med * 1e3))
        engines[mode] = {
            "bench_line": line, "first_call_s": res["first_s"],
            "staging_s": res["staging_s"], "reps_s": res["reps_s"],
            "median_s": med, "min_s": res["min_s"], "merges": res["merges"],
            "edges_per_s": res["edges_per_s"],
            "edges_per_s_min_rep": res["edges_per_s_min_rep"],
            "supersteps": steps, "buckets": st["buckets"],
            "fallback": res["fallback"], "sal_L": st.get("sal_L"),
            "stages_s": {k: x for k, x in st.items() if k.startswith("t_")},
            "launches": paths[f"merge_{mode}"],
            "repeat_runs_identical": res["reps_identical"],
            "host_replay_max_abs_gap": res["replay_max_abs_gap"],
            "vi": {k: res[k] for k in ("vi_serial", "vi_device",
                                       "vi_stale")},
            "profile": prof}
        if mode == "fused_ms":
            # the timed calls run the plan's CUDA graph (the first of them
            # captures it); one more replay, its launches counted as a path
            # of their own, against the graph's tally
            rst = {}
            counted("merge_fused_ms_graph", lambda: run_exact(mode, rst))
            graphs = [g for g in md.plan_graph_info()
                      if (g["E"], g["R"], g["sal_L"], g["pack64"])
                      == (E, R, st["sal_L"], True)]
            engines[mode]["graph"] = {
                "plan_graph": res["plan_graph"] + [rst.get("plan_graph")],
                "capture_call_s": res["capture_call_s"],
                "replay_median_s": res["replay_median_s"],
                "first_call_s": res["first_s"],
                "first_over_replay": res["first_s"]
                / res["replay_median_s"],
                "graphs": graphs,
                "launches_counted_one_replay":
                    paths["merge_fused_ms_graph"]}
            if not all(engines[mode]["graph"]["plan_graph"]) \
                    or len(graphs) != 1:
                failures.append(f"fused_ms: the calls after the first did "
                                f"not all replay one CUDA graph: "
                                f"{engines[mode]['graph']}")
            elif paths["merge_fused_ms_graph"] != \
                    graphs[0]["launches_per_replay"]:
                failures.append("fused_ms: a replay's counted launches "
                                "differ from its graph's tally")
        firsts[mode] = first
    if engines["fused_ms"]["fallback"] is not False:
        failures.append("fused_ms fell back to the single-phase engine")
    if engines["fused_ms"]["merges"] != engines["fused"]["merges"]:
        failures.append("fused_ms and fused merge counts differ")
    switches = merge_switches(u_d, v_d, s_d, c_d, R, dev)
    failures += switches.pop("failures")

    # threshold cuts at bench.py's k on each mode's exact saliencies
    k = R - n_cells
    tau = -sal_h[k - 1]
    cuts = {}
    for mode, (o, sal, n) in firsts.items():
        keys = md.order_to_keys(o, n, rag_b)
        mask = md.threshold_cut(keys, -sal[:n].double().cpu().numpy(), tau)
        cuts[mode] = apply_merge_order(seg_b, keys[mask])
    seg_h = apply_merge_order(seg_b, order_h[:k])
    n_ms = firsts["fused_ms"][2]
    rows_identical = bool(torch.equal(firsts["fused_ms"][0],
                                      firsts["fused"][0]))
    vi_cross = eval_vi(cuts["fused_ms"], cuts["fused"])[2]
    if vi_cross != 0.0:
        failures.append(f"fused_ms and fused cuts differ: VI {vi_cross}")
    vi_serial = eval_vi(seg_h, truth)
    vi_device = eval_vi(cuts["fused_ms"], truth)

    # exact saliencies: float64 on the card against the C++ replay of the
    # same order; float32 (the main path) against the replay of its order
    st64 = {}
    o64, _, n64 = md.merge_batched_device_exact(
        u, v, s, c, R, dtype=torch.float64, stats=st64, device=dev)
    ex64 = md.exact_saliency_device(u, v, s, c, o64, R, device=dev,
                                    dtype=torch.float64)[:n64]
    t = time.perf_counter()
    host64 = md.replay_exact_saliency(u, v, s, c, o64[:n64].cpu().numpy(),
                                      engine="native")
    replay_s = time.perf_counter() - t
    gap64 = rel_gap(ex64.cpu().numpy(), host64)
    if gap64 > EXACT_F64_RTOL:
        failures.append(f"float64 exact saliencies differ from the C++ "
                        f"replay by {gap64} relative")
    host32 = md.replay_exact_saliency(
        u, v, s, c, firsts["fused_ms"][0][:n_ms].cpu().numpy())
    gap32 = rel_gap(-firsts["fused_ms"][1][:n_ms].double().cpu().numpy(),
                    host32)

    # the sparse-pair metrics of the fused_ms cut at 4096^2
    l0, l1, cc = contingency_table(cuts["fused_ms"], truth,
                                   exclude_truth=(0,))
    sid, S = mdev.densify_labels(l0)
    tid, T = mdev.densify_labels(l1)

    def pair_metrics():
        return ([float(x) for x in mdev.vi_from_pairs_device(
                    sid, tid, cc, S, T, device=dev)],
                [int(x) for x in mdev.pair_counts_from_pairs_device(
                    sid, tid, cc, S, T, device=dev)],
                [float(x) for x in mdev.adapted_rand_from_pairs_device(
                    sid, tid, cc, S, T, device=dev)])

    t = time.perf_counter()
    vi_p, counts_p, rand_p = counted("metrics_pairs", pair_metrics)
    pairs_s = time.perf_counter() - t
    tp, tn, fp, fn = pair_stats_from_counts(l0, l1, cc)
    host_rand = adapted_rand_from_pairs(tp, tn, fp, fn)
    pairs = {"K": int(len(cc)), "S": S, "T": T, "seconds": pairs_s,
             "pair_counts": counts_p,
             "pair_counts_equal": counts_p == [tp, tp + fp, tp + fn],
             "vi_rel_gap": rel_gap(vi_p, vi_device),
             "rand_rel_gap": rel_gap(rand_p, host_rand)}
    if not pairs["pair_counts_equal"]:
        failures.append(f"sparse pair counts {counts_p} differ from the "
                        f"host's {[tp, tp + fp, tp + fn]}")
    if max(pairs["vi_rel_gap"], pairs["rand_rel_gap"]) > METRIC_RTOL:
        failures.append(f"sparse-pair VI / Rand differ from the host's: "
                        f"{pairs}")
    emit({"phase": "slice_merge", "part": "merge", "R": R, "E": E,
          "bench_line": lines["fused_ms"],
          "host_serial": {"merges": int(len(order_h)), "seconds": sec.host_s,
                          "edges_per_s": sec.host_edges_s},
          "engines": engines, "switches": switches,
          "fused_ms_vs_fused": {"rows_identical": rows_identical,
                                "vi_between_cuts": vi_cross},
          "threshold_cut": {"k": k, "tau": float(tau),
                            "vi_device_cut_vs_serial_cut": eval_vi(
                                cuts["fused_ms"], seg_h)[2],
                            "vi_serial_vs_truth": vi_serial,
                            "vi_device_vs_truth": vi_device},
          "exact_saliency": {"f64_rel_gap_vs_replay": gap64,
                             "f64_merges": n64,
                             "f64_supersteps": st64["n_supersteps"],
                             "f64_buckets": st64["buckets"],
                             "f32_rel_gap_vs_replay": gap32,
                             "replay_s": replay_s},
          "sparse_pair_metrics": pairs})

    # B2 at the multi-phase engine's shapes: each phase's first dedupe and
    # the LCA-keyed sum (checked for sorted ids all along the run)
    calls = capture_segment_sums(lambda: run_exact("fused_ms", {}))
    buckets = engines["fused_ms"]["buckets"]
    for cap in buckets:
        call = next(x for x in calls if x[0].ndim == 2
                    and x[0].shape[0] == cap)
        shapes.append(check_segment_sum(f"fused_ms_dedupe_{cap}", *call))
    shapes.append(check_segment_sum("fused_ms_lca_keys", *calls[-2]))

    # the serial engine on the data section: card and CPU in float64
    R1, pb1 = rag.n_regions, data["pb"]
    u1, v1, s1, c1 = md.edge_mean_arrays(rag, pb1)
    box = []
    t = time.perf_counter()
    # the first partner sum is kept for B2's check
    serial_call = capture_segment_sums(lambda: box.append(counted(
        "merge_serial", lambda: md.merge_serial_device(
            u1, v1, s1, c1, R1, dtype=torch.float64, device=dev))),
        first=1)[0]
    card_s = time.perf_counter() - t
    card = box[0]
    t = time.perf_counter()
    cpu = md.merge_serial_device(u1, v1, s1, c1, R1, dtype=torch.float64,
                                 device="cpu")
    cpu_s = time.perf_counter() - t
    serial_same = same_run((card[0].cpu(), card[1].cpu(), card[2]), cpu)
    if not serial_same:
        failures.append("merge_serial_device: card and CPU float64 runs "
                        "differ")
    order_n, sal_n = greedy_merge_native(rag, pb1, policy="mean")
    keys_s = md.order_to_keys(card[0], card[2], rag)
    serial = {"merges": card[2], "card_s": card_s, "cpu_s": cpu_s,
              "card_equals_cpu": serial_same,
              "rows_equal_native": bool(np.array_equal(keys_s, order_n)),
              "rel_gap_native": rel_gap(
                  -card[1][:card[2]].cpu().numpy(), -sal_n)
              if len(keys_s) == len(order_n) else None,
              "launches": paths["merge_serial"]}
    shapes.append(check_segment_sum("serial_partner", *serial_call))

    # the chunked engine on the data section, card and CPU in float32
    _, _, h1 = md.edge_hist_arrays(rag, pb1, n_bins=32)
    chunked = {}
    for policy in ("mean", "median"):
        def run(device, st):
            kw = dict(mode="chunked", dtype=torch.float32, stats=st,
                      device=device)
            if policy == "mean":
                return md.merge_batched_device(u1, v1, s1, c1, R1, **kw)
            return md.merge_batched_device_hist(u1, v1, h1, R1, **kw)

        st, st_cpu, box = {}, {}, []
        t = time.perf_counter()
        dedupe = capture_segment_sums(lambda: box.append(counted(
            f"merge_chunked_{policy}", lambda: run(dev, st))), first=1)[0]
        card_s = time.perf_counter() - t
        got = box[0]
        want = run("cpu", st_cpu)
        rows = got[2] == want[2] and torch.equal(got[0].cpu(), want[0])
        if not rows or st["buckets"] != st_cpu["buckets"]:
            failures.append(f"chunked ({policy}): card rows differ from the "
                            f"CPU's")
        chunked[policy] = {
            "merges": got[2], "supersteps": st["n_supersteps"],
            "buckets": st["buckets"], "card_s": card_s,
            "rows_equal_cpu": bool(rows),
            "saliencies_equal_cpu": bool(torch.equal(got[1].cpu(), want[1])),
            "launches": paths[f"merge_chunked_{policy}"]}
        if policy == "mean":
            shapes.append(check_segment_sum("chunked_dedupe", *dedupe))

    # the plan store across processes, on the data section
    store = plan_store_check(rag, pb1)
    failures += store.pop("failures")

    # dense device metrics of the data section's over-segmentation
    sid1, S1 = mdev.densify_labels(seg)
    tid1, T1 = mdev.densify_labels(data["truth"], exclude=(0,))
    vi_d, rand_d = counted("metrics_dense", lambda: (
        [float(x) for x in mdev.vi_device(sid1, tid1, S1, T1, device=dev)],
        [float(x) for x in mdev.adapted_rand_device(sid1, tid1, S1, T1,
                                                    device=dev)]))
    fs = centropy(data["truth"], seg, excluded0=(0,), itk_quirk=False)
    fm = centropy(seg, data["truth"], excluded1=(0,), itk_quirk=False)
    dense = {"S": S1, "T": T1, "vi": vi_d,
             "vi_rel_gap": rel_gap(vi_d, [fs, fm, fs + fm]),
             "rand_rel_gap": rel_gap(rand_d, eval_ri(seg, data["truth"])),
             "launches": paths["metrics_dense"]}
    if max(dense["vi_rel_gap"], dense["rand_rel_gap"]) > METRIC_RTOL:
        failures.append(f"dense device VI / Rand differ from the host's: "
                        f"{dense}")
    keep = (sid1.ravel() >= 0) & (tid1.ravel() >= 0)
    code = np.where(keep, sid1.ravel().astype(np.int64) * T1 + tid1.ravel(),
                    S1 * T1)
    shapes.append(check_segment_sum(
        "metrics_contingency",
        torch.as_tensor(keep, device=dev).to(torch.float64),
        torch.as_tensor(code, device=dev), S1 * T1, False))
    shapes.append(check_segment_sum(
        "metrics_pair_rows", torch.as_tensor(cc, device=dev).double(),
        torch.as_tensor(sid, device=dev).long(), S, False))

    # the tree scan over the serial merge tree of the data section
    tree = build_tree(order_n)
    leaf_keys = tree.keys[tree.is_leaf]
    lab = seg.ravel()
    vals = pb1.ravel().astype(np.float64)
    n_lab = int(lab.max()) + 1
    mins = np.full(n_lab, np.inf)
    maxs = np.full(n_lab, -np.inf)
    np.minimum.at(mins, lab, vals)
    np.maximum.at(maxs, lab, vals)
    leaf_stats = {
        ("add", "sum"): np.bincount(lab, vals, n_lab)[leaf_keys][:, None],
        ("add", "cnt"): np.bincount(lab, minlength=n_lab)[leaf_keys][
            :, None].astype(np.float64),
        ("min", "min"): mins[leaf_keys][:, None],
        ("max", "max"): maxs[leaf_keys][:, None]}
    t = time.perf_counter()
    got = node_region_stats_device(tree, leaf_stats, device=dev)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t
    want = host_interval_stats(tree, leaf_stats)
    sums = float(np.max(np.abs(got["sum"].cpu().numpy() - want["sum"])))
    scan = {"nodes": tree.n_nodes, "leaves": tree.n_leaves,
            "seconds": scan_s,
            "sum_max_abs_gap": sums,
            "sum_largest": float(np.max(np.abs(want["sum"]))),
            "cnt_min_max_equal": all(np.array_equal(
                got[k].cpu().numpy(), want[k]) for k in ("cnt", "min",
                                                         "max"))}
    if not scan["cnt_min_max_equal"] or sums > 1e-12 * scan["sum_largest"]:
        failures.append(f"tree scan differs from the host: {scan}")
    emit({"phase": "slice_merge", "part": "data_section_1024",
          "serial": serial, "chunked": chunked, "plan_store": store,
          "dense_metrics": dense,
          "tree_scan": scan, "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_merge: {failures}")
    fused = firsts["fused"]
    bench = {"u": u, "v": v, "s": s, "c": c, "R": R, "E": E, "rag": rag_b,
             "seg": seg_b, "tau": float(tau),
             "fused_order": fused[0][:fused[2]].cpu().numpy(),
             "fused_median_s": engines["fused"]["median_s"],
             "fused_ms_median_s": engines["fused_ms"]["median_s"]}
    return paths, shapes, bench


def plan_store_child(directory):
    """One process of the plan-store check: the store in ``directory``
    (utils.enable_persistent_cache), merge_batched_device_exact twice on
    the edge arrays saved there; then a capture of a program that reads
    the card from the host, which must raise, and the merge once more.
    Prints one line: the calls' counters, seconds and the SHA-1 of their
    rows and saliency bits, the capture's error, the last rows' SHA-1."""
    import hashlib
    import os

    import glia_tpu_torch.graph.merge_device as md
    from glia_tpu_torch.utils import enable_persistent_cache

    enable_persistent_cache(directory)
    x = np.load(os.path.join(directory, "inputs.npz"))
    calls = []
    for _ in range(2):
        st = {}
        t = time.perf_counter()
        order, sal, n = md.merge_batched_device_exact(
            x["u"], x["v"], x["s"], x["c"], int(x["R"]), stats=st,
            device="cuda")
        torch.cuda.synchronize()
        calls.append({
            "s": time.perf_counter() - t, "merges": n,
            "rows_sha1": hashlib.sha1(
                order[:n].cpu().numpy().tobytes()).hexdigest(),
            "saliencies_sha1": hashlib.sha1(
                sal[:n].cpu().numpy().tobytes()).hexdigest(),
            **{k: st.get(k) for k in ("plan_replayed", "plan_graph",
                                      "fallback", "n_supersteps")}})
    # a plan program that reads the card from the host cannot be captured:
    # the capture raises (no eager run in its place), and the card goes on
    inputs = (torch.as_tensor(x["u"], device="cuda").long(),
              torch.as_tensor(x["v"], device="cuda").long(), (), ())
    try:
        md._PlanGraph(lambda *xs: xs[0].sum().item(), inputs, {})
        raised = None
    except Exception as e:  # reported: the parent fails on None
        raised = repr(e)[:200]
    order, _, n = md.merge_batched_device_exact(
        x["u"], x["v"], x["s"], x["c"], int(x["R"]), device="cuda")
    emit({"plan_store_child": calls, "capture_with_host_read": raised,
          "rows_after_it_sha1": hashlib.sha1(
              order[:n].cpu().numpy().tobytes()).hexdigest()})


def plan_store_check(rag, pb):
    """Two processes, one after the other, with the plan store in one
    temporary directory: the first discovers and stores the plan and the
    depth capacity; the second's first call must replay the stored plan
    (its last phase eagerly, its superstep count not being stored), its
    second call the plan's CUDA graph, all with the first process's rows
    and saliency bits; in each, a capture with a host read must raise and
    the merge after it give the same rows.  Returns what the children
    printed and the failures."""
    import os
    import tempfile

    import glia_tpu_torch.graph.merge_device as md

    u, v, s, c = md.edge_mean_arrays(rag, pb)
    t = time.perf_counter()
    children, failures = [], []
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "inputs.npz"), u=u, v=v, s=s, c=c,
                 R=rag.n_regions)
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--plan-store-child", d], capture_output=True, text=True,
                timeout=300)
            if out.returncode != 0:
                raise AssertionError(f"plan-store child: rc "
                                     f"{out.returncode}: "
                                     f"{out.stderr[-2000:]}")
            children.append(json.loads(out.stdout.strip().splitlines()[-1]))
        with open(os.path.join(d, "glia_plan_memo.json")) as f:
            stored = json.load(f)
    (a1, a2), (b1, b2) = (ch["plan_store_child"] for ch in children)
    digests = {(x["rows_sha1"], x["saliencies_sha1"])
               for x in (a1, a2, b1, b2)}
    if a1["plan_replayed"] is not False or b1["plan_replayed"] is not True:
        failures.append(f"plan store: the second process's first call did "
                        f"not replay the stored plan: {children}")
    if not b2["plan_graph"] or any(x["fallback"] for x in (a1, a2, b1, b2)):
        failures.append(f"plan store: no graph or a fallback: {children}")
    if len(digests) != 1:
        failures.append(f"plan store: rows or saliencies differ between "
                        f"the processes: {children}")
    for ch in children:
        if ch["capture_with_host_read"] is None or \
                ch["rows_after_it_sha1"] != a1["rows_sha1"]:
            failures.append(f"a capture with a host read did not raise, or "
                            f"the next merge differed: {ch}")
    return {"processes": children, "stored_plans": len(stored["plans"]),
            "stored_sal_L": len(stored["sal_L"]),
            "seconds": time.perf_counter() - t, "failures": failures}


# the port's hardware suite (tests/test_torch_on_card.py, the counterpart
# of tests_tpu/test_real_tpu.py's ten tests); --noconftest keeps out
# tests/conftest.py, which imports JAX
CARD_SUITE = ["tests/test_torch_on_card.py"]
CARD_SUITE_TESTS = 10
# the section of bench_cli's run of python -m glia_tpu_torch.bench
# (bench.py's round-4 configuration, GLIA_BENCH_SIDE=2048); its RAG had
# 61,001 regions and 149,084 edges in glia_tpu (BENCH_r04.json);
# slice_merge runs the default 4096^2
BENCH_CLI_SIDE = 2048
BENCH_CLI_EXPECTED = {"R": 61001, "E": 149084}


def repo_root() -> str:
    import os

    return os.path.dirname(os.path.abspath(__file__))


def phase_card_suite():
    """tests/test_torch_on_card.py under pytest in a child process: it must
    exit 0 with all CARD_SUITE_TESTS tests passed and none skipped."""
    import re

    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", *CARD_SUITE], cwd=repo_root(),
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t
    summary = ([ln for ln in out.stdout.splitlines() if ln.strip()]
               or [""])[-1]
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|xfailed|xpassed|deselected)",
        summary)}
    emit({"phase": "card_suite", "command": "python -m pytest --noconftest "
          "-p no:cacheprovider -q " + " ".join(CARD_SUITE),
          "returncode": out.returncode, "seconds": seconds,
          "summary": summary, "counts": counts})
    if out.returncode != 0 or counts != {"passed": CARD_SUITE_TESTS}:
        raise AssertionError(f"card_suite: {summary}\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-2000:]}")


def phase_bench_cli(dev):
    """``python -m glia_tpu_torch.bench`` in a child process at
    GLIA_BENCH_SIDE=BENCH_CLI_SIDE: it must exit 0 and print exactly one
    stdout line, bench.py's line (bench_line_ok, from the numbers of its
    ``counts`` line on stderr), on a RAG of glia_tpu's R and E
    (BENCH_CLI_EXPECTED).  Path ``bench_2048`` is the child's launch
    counts, from its first call to its last (the ``counts`` line).  Then
    kernel B2 at that section's shapes (each phase's first dedupe and the
    LCA keys of a discovery call of merge_batched_device_exact in this
    process).  Returns (launch counts per path, B2's per-shape
    results)."""
    import os

    import glia_tpu_torch.graph.merge_device as md
    from glia_tpu_torch.bench import bench_section

    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "glia_tpu_torch.bench"], cwd=repo_root(),
        env={**os.environ, "GLIA_BENCH_SIDE": str(BENCH_CLI_SIDE)},
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    lines = out.stdout.splitlines()
    line = json.loads(lines[0]) if len(lines) == 1 else None
    counts = [json.loads(x[len("counts: "):])
              for x in out.stderr.splitlines() if x.startswith("counts: ")]
    counts = counts[0] if len(counts) == 1 else None
    emit({"phase": "bench_cli", "side": BENCH_CLI_SIDE,
          "returncode": out.returncode, "seconds": seconds,
          "stdout": lines, "stderr": out.stderr.splitlines()[-15:]})
    if out.returncode != 0 or line is None or counts is None:
        raise AssertionError(f"bench_cli: rc {out.returncode}, stdout "
                             f"{out.stdout[-2000:]!r}\n{out.stderr[-3000:]}")
    R, E = counts["R"], counts["E"]
    if {"R": R, "E": E} != BENCH_CLI_EXPECTED or not bench_line_ok(
            line, E, counts["merges"], counts["reps_s"],
            counts["host_merges"], counts["host_s"]):
        raise AssertionError(f"bench_cli: R, E {R}, {E} (glia_tpu's "
                             f"{BENCH_CLI_EXPECTED}), or the line is not "
                             f"bench.py's: {line}, {counts}")
    paths = {"bench_2048": counts["launches"]}
    if paths["bench_2048"]["segment_sum"] == 0:
        raise AssertionError("bench_cli: segment_sum never launched")
    print(lines[0], flush=True)

    data, _, rag = bench_section(BENCH_CLI_SIDE, (BENCH_CLI_SIDE // 14) ** 2)
    u, v, s, c = md.edge_mean_arrays(rag, data["pb"])
    st = {}
    calls = capture_segment_sums(lambda: md.merge_batched_device_exact(
        u, v, s, c, rag.n_regions, stats=st, device=dev))
    shapes = []
    for cap in st["buckets"]:
        call = next(x for x in calls if x[0].ndim == 2
                    and x[0].shape[0] == cap)
        shapes.append(check_segment_sum(f"bench2048_dedupe_{cap}", *call))
    shapes.append(check_segment_sum("bench2048_lca_keys", *calls[-2]))
    return paths, shapes


# the sharded path (glia_tpu_torch.parallel): the ranks of its world-4
# runs, the timed calls at bench.py's 4096^2 section, a spawn's time limit
# slice_tools: glia_tpu's scripts under tools/ through the port's
# examples, each at its tool's default arguments (they fit the phase's
# budget of 150 s); the bounds of tests/test_bc_midcut.py on the mid-cut
# VI gaps (each, and their sum)
TOOLS_MIDCUT_MAX_DVI = 0.08
TOOLS_MIDCUT_SUM_DVI = 0.06
# the first halo step's loss across worlds (float32, summed in other
# orders by other partitions)
TOOLS_LOSS_RTOL = 1e-4
# bench_scaling's section: the tool's defaults (side, cells)
TOOLS_SCALING = (512, 900)
# the worlds slice_tools runs bench_scaling at, cut from the tool's 1, 2,
# 4 and 8: ranks sharing the card start one after another, about 12 s
# each, and the four worlds took 191 s of the phase's budget of 150 s
# (15 / 27 / 50 / 97 s; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 4)
TOOLS_SCALING_WORLDS = (1, 2)


def phase_slice_tools(dev, seed):
    """glia_tpu's scripts under tools/ as the port's examples
    (glia_tpu_torch.examples), through their functions on the card at the
    tools' default arguments, each with launch counts:

    - bench_merge_device (1024^2, (1024 // 14)^2 cells), mode fused_ms and
      then fused: no fallback of fused_ms, its staged calls replaying the
      plan's CUDA graph, and its threshold cut keeping as many merges as
      fused's, or the script fails;
    - bench_bc_device (512^2, 120 trees): B1 launched in the merge loop,
      the steady call's order and probabilities equal to the first's, or
      the script fails;
    - bench_forest (8192 x 96, 120 trees), both walks: 0 mismatches in the
      256 checked rows, or the script fails; B1 held to the plain walk
      and timed at that batch (path tools_forest);
    - bc_midcut_compare (512^2, 60 trees): serial and device rows at five
      taus, every |dVI| within TOOLS_MIDCUT_MAX_DVI and their sum within
      TOOLS_MIDCUT_SUM_DVI (tests/test_bc_midcut.py's bounds), or the
      script fails;
    - median_drift (1024^2) for median and median_minsize: the tool's
      keys present and every cut VI finite, or the script fails;
    - bench_scaling (512^2, 900 cells) at TOOLS_SCALING_WORLDS gloo ranks
      sharing the card: halo_rows and cut_fraction equal to the host
      plan's, the first step's loss equal across worlds within
      TOOLS_LOSS_RTOL, or the script fails.

    Returns (launch counts per path, B1's line at the forest batch)."""
    from glia_tpu_torch.examples import (bench_bc_device, bench_bc_midcut,
                                         bench_forest_pallas,
                                         bench_median_drift,
                                         bench_merge_device, bench_scaling)
    from glia_tpu_torch.parallel.halo import HaloPlan
    from glia_tpu_torch.parallel.partition import partition_rag

    t_phase = time.perf_counter()
    paths, failures, seconds = {}, [], {}

    def run(name, fn):
        t = time.perf_counter()
        out, _ = counted_run(paths, name, fn)
        seconds[name] = time.perf_counter() - t
        return out

    merge = {mode: run(f"tools_merge_{mode}", lambda: (
        bench_merge_device.bench_merge_device(mode=mode, device=dev)))
        for mode in ("fused_ms", "fused")}
    ms_stats = merge["fused_ms"]["stats"]
    if ms_stats.get("fallback") is not False or not ms_stats["plan_graph"]:
        failures.append(f"bench_merge_device fused_ms: {ms_stats}")
    if merge["fused_ms"]["cut_merges"] != merge["fused"]["cut_merges"]:
        failures.append("bench_merge_device: the threshold cuts of fused_ms "
                        "and fused keep other merge counts")

    bc = run("tools_bc_device",
             lambda: bench_bc_device.bench_bc_device(device=dev))
    require_launches(paths, "tools_bc_device", ["forest_votes"])
    if not bc["steady_equal_first"]:
        failures.append("bench_bc_device: the steady call's order differs "
                        "from the first call's")

    forest = run("tools_forest",
                 lambda: bench_forest_pallas.bench_forest(device=dev))
    if forest["plain"]["mismatches"] or forest["cuda"]["mismatches"]:
        failures.append(f"bench_forest: mismatches plain "
                        f"{forest['plain']['mismatches']}, cuda "
                        f"{forest['cuda']['mismatches']}")
    model, X = bench_forest_pallas.forest_case(forest["B"], forest["T"],
                                               forest["D"])
    b1 = phase_kernel(torch.as_tensor(X, device=dev), model, seed,
                      path="tools_forest")

    midcut = run("tools_bc_midcut",
                 lambda: bench_bc_midcut.bc_midcut_compare(device=dev))
    dvis = [r["dvi"] for r in midcut]
    if len(midcut) != len(bench_bc_midcut.TAUS) \
            or max(abs(d) for d in dvis) > TOOLS_MIDCUT_MAX_DVI \
            or sum(dvis) > TOOLS_MIDCUT_SUM_DVI:
        failures.append(f"bc_midcut_compare: {midcut}")

    drift = {p: run(f"tools_median_drift_{p}", lambda: (
        bench_median_drift.median_drift(policy=p, device=dev)))
        for p in bench_median_drift.POLICIES}
    for p, d in drift.items():
        vis = [d.get(k) for k in ("vi_serial", "vi_stale", "vi_exact")]
        if not all(v is not None and np.isfinite(v) for v in vis) \
                or not {"dvi_stale", "dvi_exact", "edges"} <= set(d):
            failures.append(f"median_drift {p}: {d}")

    t = time.perf_counter()
    scaling = bench_scaling.bench_scaling(
        *TOOLS_SCALING, worlds=TOOLS_SCALING_WORLDS, device=dev)
    seconds["tools_scaling"] = time.perf_counter() - t
    paths["tools_scaling"] = sum_launches(r["launches"] for r in scaling)
    require_launches(paths, "tools_scaling", ["segment_sum"])
    _, rag = bench_scaling.scaling_section(*TOOLS_SCALING)
    loss0 = scaling[0]["loss_first"]
    for r in scaling:
        part = partition_rag(rag, r["shards"])
        plan = HaloPlan(part, rag)
        if (r["halo_rows"], r["cut_fraction"]) != (plan.comm_rows,
                                                   part.cut_fraction):
            failures.append(f"bench_scaling at {r['shards']}: halo rows / "
                            f"cut {r['halo_rows']} / {r['cut_fraction']} "
                            f"against the plan's {plan.comm_rows} / "
                            f"{part.cut_fraction}")
        if abs(r["loss_first"] - loss0) > TOOLS_LOSS_RTOL * abs(loss0):
            failures.append(f"bench_scaling at {r['shards']}: first loss "
                            f"{r['loss_first']} against {loss0}")

    emit({"phase": "slice_tools", "bench_merge_device": merge,
          "bench_bc_device": bc, "bench_forest": forest,
          "bc_midcut": midcut, "median_drift": drift,
          "bench_scaling": scaling, "seconds": seconds,
          "launches": paths, "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_tools: {failures}")
    return paths, b1


PARALLEL_WORLD = 4
PARALLEL_REPS = 3
PARALLEL_TIMEOUT_S = 600


def parallel_bench_rank(mesh, case):
    """One rank of the sharded merge at bench.py's 4096^2 section: a
    first call whose kernel launches are counted in this process, then
    PARALLEL_REPS timed calls (each must give the first call's rows), then
    the float64 exact saliencies of the first call's order."""
    from glia_tpu_torch.ops import cuda as kcuda
    from glia_tpu_torch.parallel.merge_shard import (exact_saliency_sharded,
                                                     merge_batched_sharded)

    u, v, s, c, R = (case[k] for k in ("u", "v", "s", "c", "R"))
    st = {}
    kcuda.reset_launches()
    t = time.perf_counter()
    order, _, n = merge_batched_sharded(u, v, s, c, R, mesh, dmax=4,
                                        stats=st)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = dict(kcuda.launches)
    reps, same = [], True
    for _ in range(PARALLEL_REPS):
        t = time.perf_counter()
        again, _, n2 = merge_batched_sharded(u, v, s, c, R, mesh, dmax=4)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t)
        same = same and n2 == n and torch.equal(again, order)
    rows = order[:n].cpu().numpy()
    t = time.perf_counter()
    exact = exact_saliency_sharded(u, v, s, c, rows, R, mesh,
                                   dtype=torch.float64)
    exact_s = time.perf_counter() - t
    return {"rows": rows if mesh.rank == 0 else None, "n": n, "stats": st,
            "first_s": first_s, "reps_s": reps, "repeats_identical": same,
            "exact": exact if mesh.rank == 0 else None, "exact_s": exact_s,
            "launches": launches, "device": str(mesh.device),
            "backend": mesh.backend}


def same_stages(a, b, stages=("train", "merge", "bc")):
    """Per stage of two dryrun._dryrun_rank results: every array and value
    the same, bit for bit (merge stats aside)."""
    return {st: all(np.array_equal(x, b[st][k], equal_nan=True)
                    if isinstance(x, np.ndarray) else x == b[st][k]
                    for k, x in a[st].items() if k != "stats")
            for st in stages}


def parallel_dryrun_rank(mesh, case):
    """One rank of dryrun.dryrun_multichip: its three stages
    (dryrun._dryrun_rank), then all three once more in the same ranks:
    ``rerun_identical`` per stage (the halo step's loss, gradient and
    losses, the merge's rows and saliencies, the BC rows and scores with
    the first run's bits).  On rank 0 every B2 sum and every B1 batch of
    the first run is captured and held to the plain versions on the card;
    its result adds ``held``: what was held and the first sum of each
    (rank, width, sorted) kind for timing."""
    from glia_tpu_torch import dryrun

    res = parallel_dryrun_first(mesh, case)
    res["rerun_identical"] = same_stages(res,
                                         dryrun._dryrun_rank(mesh, case))
    return res


def parallel_dryrun_first(mesh, case):
    """The first run of parallel_dryrun_rank."""
    from glia_tpu_torch import dryrun
    from glia_tpu_torch.models.forest import forest_votes_torch
    from glia_tpu_torch.ops import cuda as kcuda

    if mesh.rank:
        return dryrun._dryrun_rank(mesh, case)
    outs, res = [], {}
    sums, b1_calls = capture_calls(kcuda, "forest_votes_cuda", lambda: (
        capture_segment_sums(lambda: res.update(
            dryrun._dryrun_rank(mesh, case)), outputs=outs)))
    held = hold_segment_sums("parallel_rank0", sums, outs)
    mismatches = sum(int((out != forest_votes_torch(args[0], args[1])).sum())
                     for args, out in b1_calls)
    kinds = {}
    for values, ids, S, is_sorted in sums:
        key = (values.ndim, tuple(values.shape[1:]), is_sorted)
        if key not in kinds:
            kinds[key] = (values.cpu().numpy(), ids.cpu().numpy(), S,
                          is_sorted)
    res["held"] = {
        "b2": held, "b1_batches": len(b1_calls),
        "b1_rows": [int(args[0].shape[0]) for args, _ in b1_calls],
        "b1_mismatches": mismatches, "b2_samples": list(kinds.values())}
    return res


def sum_launches(per_rank):
    """Kernel launches summed over the ranks' counts."""
    out = {}
    for counts in per_rank:
        for k, n in counts.items():
            out[k] = out.get(k, 0) + n
    return out


def float32_ties(s, c):
    """Edges whose float32 mean shares its bits with another edge's."""
    bits = (np.asarray(s) / np.maximum(np.asarray(c), 1.0)).astype(
        np.float32).view(np.int32)
    _, counts = np.unique(bits, return_counts=True)
    return int(counts[counts > 1].sum())


def phase_slice_parallel(bench, dev, seed):
    """The sharded path (glia_tpu_torch.parallel) on the card.

    (a) dryrun.dryrun_multichip(PARALLEL_WORLD) on gloo ranks sharing the
        card (glia_tpu's dryrun RAG, 512^2): the halo train step (loss
        within 1e-4 of the single-process loss, the gradient
        PARALLEL_WORLD x the single-process gradient within 1e-5, 10 more
        steps lower the loss), the sharded merge (rows equal to
        merge_batched_device(mode="fused"), exact saliencies = host replay,
        cut VI 0) and the sharded BC features (allclose to TreeFeatures,
        scores = the host walk); the three stages once more in the same
        ranks, every rank's results with the first run's bits, or the
        script fails; kernel launches summed over the ranks;
        B1 against the plain walk at the BC batch; in the same ranks,
        rank 0's B2 sums and B1 batches of the three stages held to the
        plain versions on the card (parallel_dryrun_rank), B2 timed at
        each kind of sum.
    (b) merge_batched_sharded at bench.py's 4096^2 section at
        PARALLEL_WORLD gloo ranks and at 1 rank on nccl: rows equal to
        mode="fused"'s on the card (or, where a float32 tie between
        distinct pairs parts them, equal merge counts and threshold cuts
        at VI 0, the ties and the first parting row printed), repeats
        identical, float64 exact saliencies within EXACT_F64_RTOL of the
        C++ replay; stats and the median wall of PARALLEL_REPS calls
        beside fused's.

    Returns (launch counts per path, B1's line at the BC batch, B2's
    per-shape results)."""
    from glia_tpu_torch import dryrun
    from glia_tpu_torch.graph import merge_device as md
    from glia_tpu_torch.graph.merge import apply_merge_order
    from glia_tpu_torch.metrics import eval_vi
    from glia_tpu_torch.parallel.launch import spawn_ranks

    t_phase = time.perf_counter()
    paths, failures = {}, []

    # (a) the dryrun at PARALLEL_WORLD ranks on the card
    rep = dryrun.dryrun_multichip(PARALLEL_WORLD, device=dev,
                                  backend="gloo",
                                  timeout_s=PARALLEL_TIMEOUT_S,
                                  rank_fn=parallel_dryrun_rank)
    held = rep["ranks"][0]["held"]
    rerun = [r["rerun_identical"] for r in rep["ranks"]]
    if not all(all(r.values()) for r in rerun):
        failures.append(f"a second run of the dryrun's stages gave other "
                        f"bits: {rerun}")
    for stage in ("train", "merge", "bc"):
        paths[f"parallel_{stage}"] = sum_launches(
            r[stage] for r in rep["launches_by_rank"])
    require_launches(paths, "parallel_train", ["segment_sum"])
    require_launches(paths, "parallel_merge", ["segment_sum"])
    require_launches(paths, "parallel_bc", ["segment_sum", "forest_votes"])
    b1 = phase_kernel(torch.as_tensor(rep["bc_feats"], device=dev).float(),
                      rep["model"], seed, path="parallel_bc")
    emit({"phase": "slice_parallel", "part": "dryrun",
          **{k: rep[k] for k in (
              "backend", "world", "n_regions", "n_edges", "halo_rows",
              "wall_s", "loss", "loss_single", "loss_rel", "losses",
              "grad_rel", "merges", "merge_stats", "cut_vi", "bc_level",
              "bc_merges", "bc_feats_max_abs_err", "seconds_by_rank",
              "host_staged_bytes")},
          "rerun_identical": rerun,
          "launches": {p: paths[p] for p in paths}})

    # (b) bench.py's section, PARALLEL_WORLD gloo ranks and 1 nccl rank
    u, v, s, c, R, E = (bench[k] for k in ("u", "v", "s", "c", "R", "E"))
    case = {"u": u, "v": v, "s": s, "c": c, "R": R}
    fused = bench["fused_order"]
    rag_b, seg_b, tau = bench["rag"], bench["seg"], bench["tau"]

    def cut(rows):
        keys = md.order_to_keys(rows, len(rows), rag_b)
        ex = md.replay_exact_saliency(u, v, s, c, rows, engine="native")
        return apply_merge_order(seg_b, keys[md.threshold_cut(keys, ex,
                                                              tau)]), ex

    cut_fused, _ = cut(fused)
    runs = {}
    for name, world, backend in (("w4_gloo", PARALLEL_WORLD, "gloo"),
                                 ("w1_nccl", 1, "nccl")):
        t = time.perf_counter()
        res = spawn_ranks(parallel_bench_rank, world, backend, "cuda",
                          args=(case,), timeout_s=PARALLEL_TIMEOUT_S)
        wall = time.perf_counter() - t
        r0 = res[0]
        rows = r0["rows"]
        paths[f"parallel_merge_4096_{name}"] = sum_launches(
            r["launches"] for r in res)
        require_launches(paths, f"parallel_merge_4096_{name}",
                         ["segment_sum"])
        cut_sh, host64 = cut(rows)
        gap64 = rel_gap(r0["exact"], host64)
        same_rows = len(rows) == len(fused) and np.array_equal(rows, fused)
        line = {"world": world, "backend": backend,
                "devices": sorted({r["device"] for r in res}),
                "merges": r0["n"], "fused_merges": int(len(fused)),
                "rows_equal_fused": same_rows,
                "cut_vi_vs_fused": eval_vi(cut_sh, cut_fused)[2],
                "repeats_identical": all(r["repeats_identical"]
                                         for r in res),
                "f64_exact_rel_gap_vs_replay": gap64,
                "first_s": r0["first_s"], "reps_s": r0["reps_s"],
                "median_s": float(np.median(r0["reps_s"])),
                "exact_s": r0["exact_s"], "spawn_wall_s": wall,
                "stats": r0["stats"],
                "launches": paths[f"parallel_merge_4096_{name}"]}
        if not same_rows:
            n = min(len(rows), len(fused))
            part = np.nonzero((rows[:n] != fused[:n]).any(axis=1))[0]
            line.update(float32_ties=float32_ties(s, c),
                        first_parting_row=int(part[0]) if len(part) else n,
                        rows_parting=int(len(part)))
            if r0["n"] != len(fused) or line["cut_vi_vs_fused"] != 0.0:
                failures.append(f"{name}: {r0['n']} merges, cut VI "
                                f"{line['cut_vi_vs_fused']} against fused")
        if not line["repeats_identical"]:
            failures.append(f"{name}: repeated calls differ")
        if gap64 > EXACT_F64_RTOL:
            failures.append(f"{name}: float64 exact saliencies differ from "
                            f"the C++ replay by {gap64}")
        runs[name] = line
    emit({"phase": "slice_parallel", "part": "merge_4096", "R": R, "E": E,
          "runs": runs, "fused_median_s": bench["fused_median_s"],
          "fused_ms_median_s": bench["fused_ms_median_s"]})

    # rank 0's B2 sums and B1 batches of (a) against the plain versions
    if held["b1_mismatches"] or not held["b1_batches"]:
        failures.append(f"B1 on rank 0's batches: {held['b1_mismatches']} "
                        f"vote fractions differ in {held['b1_batches']} "
                        f"batches")
    b2 = []
    for i, (values, ids, S, is_sorted) in enumerate(held["b2_samples"]):
        b2.append(check_segment_sum(
            f"parallel_rank0_{i}", torch.as_tensor(values, device=dev),
            torch.as_tensor(ids, device=dev), S, is_sorted))
    emit({"phase": "slice_parallel", "part": "rank0_kernels",
          "b2": held["b2"], "b1_batches": held["b1_batches"],
          "b1_rows": held["b1_rows"],
          "b1_mismatches": held["b1_mismatches"],
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_parallel: {failures}")
    return paths, b1, b2


# BASELINE config #5 end to end (tools/run_snemi_e2e.py's flow): a
# synthetic EM volume of 100 x 1024 x 1024 voxels and 4 cells a section,
# seed 23, watershed level 0.01, 40 halo train steps, the ranks world 1
# on NCCL.  A cut depth keeps the 1024^2 sections and the cell density.
# The depth slice_snemi runs at: the phase took 102 s at 12 sections, 45
# of them starting the three spawns' ranks, about 4.6 s a section (the
# voxel oracle 1.8 of them); at 100 sections the chain alone takes 483 s
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md sections 4-5)
SNEMI_Z_RUN = 8
SNEMI_SIDE = 1024
SNEMI_STEPS = 40
SNEMI_TIMEOUT_S = 600
# the first step's loss on one rank against the single-process loss
SNEMI_LOSS_RTOL = 1e-4


def host_sum(call):
    """A captured segment sum's inputs as host arrays, to leave a rank."""
    values, ids, S, is_sorted = call
    return values.cpu().numpy(), ids.cpu().numpy(), S, is_sorted


def snemi_train_rank(mesh, cfg, block):
    """run_snemi_e2e.train_rank, its first segment sum (the halo partials
    by first endpoint, B2's sorted entry in the batch's fixed order) kept
    to be held to the plain sum; then the whole training once more in the
    same rank, from the same block: ``rerun_identical`` when the loss of
    every step and rank 0's weights have the first run's bits.  The
    launch counts are the first run's."""
    from glia_tpu_torch.examples import run_snemi_e2e as e2e

    res = {}
    sums = capture_segment_sums(
        lambda: res.update(e2e.train_rank(mesh, cfg, block)), first=1)
    res["b2_sample"] = host_sum(sums[0])
    again = e2e.train_rank(mesh, cfg, block)
    res["rerun_identical"] = (
        again["losses"] == res["losses"]
        and (mesh.rank != 0 or np.array_equal(again["w"], res["w"])))
    return res


def snemi_merge_rank(mesh, case):
    """run_snemi_e2e.merge_rank, its first merge dedupe and first LCA sum
    (B2's sorted entry) kept, then the sharded merge and its exact
    saliencies once more on the same inputs: ``repeat_identical`` on rank
    0, and the second run's rows and saliencies (``rows2``, ``exact2``)."""
    from glia_tpu_torch.examples import run_snemi_e2e as e2e
    from glia_tpu_torch.parallel.merge_shard import (exact_saliency_sharded,
                                                     merge_batched_sharded)

    res = {}
    sums = capture_segment_sums(
        lambda: res.update(e2e.merge_rank(mesh, case)))
    res["b2_samples"] = {
        "merge_dedupe": host_sum(next(c for c in sums
                                      if c[0].ndim == 2 and c[3])),
        "lca_sum": host_sum(next(c for c in sums
                                 if c[0].ndim == 1 and c[3]))}
    again, _, n2 = merge_batched_sharded(
        *(case[k] for k in ("u", "v", "s", "c", "R")), mesh, dmax=e2e.DMAX,
        max_supersteps=e2e.MAX_SUPERSTEPS, dtype=torch.float64)
    rows2 = again[:n2].cpu().numpy()
    exact2 = exact_saliency_sharded(
        *(case[k] for k in ("u", "v", "s", "c")), rows2, case["R"], mesh,
        dtype=torch.float64)
    if mesh.rank == 0:
        res["repeat_identical"] = (n2 == res["n"]
                                   and np.array_equal(rows2, res["rows"]))
        res.update(rows2=rows2, exact2=exact2)
    return res


def phase_slice_snemi(dev, z):
    """BASELINE config #5 end to end on the card
    (glia_tpu_torch.examples.run_snemi_e2e.snemi_e2e, world 1 on NCCL) at
    ``z`` sections of 1024^2, then the partition and halo counters of 8
    shards and the halo step's time (run_snemi_sharded.snemi_sharded) on
    the same volume.  Hard checks:

    (a) the sharded merge's rows (float64) equal merge_batched_device(
        mode="fused")'s in float64 on the card; a second sharded call
        gives them again;
    (b) the sharded exact saliencies within EXACT_F64_RTOL of the C++
        replay;
    (c) the device pair counts equal the host's int64 counts at the
        watershed cut and at every tau (snemi_e2e raises otherwise);
    (d) the voxel-level host oracle at tau 0.7 within 1e-9 of the
        pair-table VI and adapted Rand error (snemi_e2e raises otherwise);
    (e) the first step's loss within SNEMI_LOSS_RTOL of the
        single-process loss on the same weights; the last below the first;
    (f) B2 launched on each of the paths snemi_train, snemi_score,
        snemi_merge, snemi_replay and snemi_eval; one sum of each kind on
        them held to the plain sum and timed: the halo partials (sorted,
        float32), the scoring's incident sum (sorted, float32), the pair
        counts (atomic, float64, S * T: whole numbers, exact in any
        order), the merge dedupe and the LCA sum (sorted, float64);
    (g) two runs give the same bits: the training once more in the same
        rank (the loss of all SNEMI_STEPS steps and the final weights),
        the scoring once more with those weights (the probabilities), and
        the sharded merge and exact saliencies once more in the same
        ranks (the merge rows kept at every tau).  Equal probabilities
        make equal merge inputs, so the second merge is the second run's.

    Returns (launch counts per path, B2's per-shape results)."""
    from glia_tpu_torch import dryrun
    from glia_tpu_torch.examples import run_snemi_e2e as e2e
    from glia_tpu_torch.examples import run_snemi_sharded as shd
    from glia_tpu_torch.examples import snemi
    from glia_tpu_torch.graph import merge_device as md
    from glia_tpu_torch.models.mlp import mlp2_init
    from glia_tpu_torch.parallel.train import halo_feat_dims

    t_phase = time.perf_counter()
    failures = []
    vol = snemi.make_volume(z, SNEMI_SIDE, 4 * z,
                            level=snemi.DEFAULT_LEVEL)
    res, arrays = {}, {}
    main_sums = capture_segment_sums(lambda: res.update(e2e.snemi_e2e(
        vol, shards=1, steps=SNEMI_STEPS, device=dev, host_check=True,
        timeout_s=SNEMI_TIMEOUT_S, train_fn=snemi_train_rank,
        merge_fn=snemi_merge_rank, arrays=arrays)))
    paths = {f"snemi_{k}": n for k, n in res["launches"].items()}
    for name in paths:
        require_launches(paths, name, ["segment_sum"])

    # (a) rows against the single-process fused engine, both float64
    u, v, s, c, rows = (arrays[k] for k in ("u", "v", "s", "c", "rows"))
    R = vol.rag.n_regions
    t = time.perf_counter()
    o_f, _, n_f = md.merge_batched_device(
        u, v, s, c, R, max_supersteps=e2e.MAX_SUPERSTEPS,
        dtype=torch.float64, mode="fused", dmax=e2e.DMAX, device=dev)
    fused_s = time.perf_counter() - t
    same_rows = n_f == len(rows) and np.array_equal(
        o_f[:n_f].cpu().numpy(), rows)
    repeat = arrays["merge_ranks"][0]["repeat_identical"]
    if not same_rows:
        failures.append(f"sharded rows ({len(rows)}) differ from fused's "
                        f"({n_f}) in float64")
    if not repeat:
        failures.append("a second sharded merge gave other rows")
    # (b) exact saliencies against the C++ replay
    gap64 = rel_gap(arrays["exact"], md.replay_exact_saliency(
        u, v, s, c, rows, engine="native"))
    if gap64 > EXACT_F64_RTOL:
        failures.append(f"float64 exact saliencies differ from the C++ "
                        f"replay by {gap64}")
    # (g) the second run's bits: training, scoring, merge rows at every tau
    m0 = arrays["merge_ranks"][0]
    probs2 = e2e.score_edges(vol, arrays["w"], dev)
    okeys2 = md.order_to_keys(m0["rows2"], len(m0["rows2"]), vol.rag)
    okeys, ex = arrays["okeys"], arrays["exact"]
    rerun = {
        "train": all(r["rerun_identical"] for r in arrays["train_ranks"]),
        "probs": bool(np.array_equal(probs2, arrays["probs"])),
        "exact": bool(np.array_equal(m0["exact2"], ex, equal_nan=True)),
        "cut_rows": {tau: bool(np.array_equal(
            okeys[md.threshold_cut(okeys, ex, tau)],
            okeys2[md.threshold_cut(okeys2, m0["exact2"], tau)]))
            for tau in e2e.TAUS}}
    if not (rerun["train"] and rerun["probs"] and rerun["exact"]
            and all(rerun["cut_rows"].values())):
        failures.append(f"two runs of config #5 differ: {rerun}")
    # (d) is snemi_e2e's own raise; its gaps are printed
    chk = res["host_check"]
    if max(chk["vi_gap"], chk["rand_error_gap"]) > e2e.HOST_CHECK_TOL:
        failures.append(f"host oracle: {chk}")
    # (e) the first step's loss against one process's
    _, D = halo_feat_dims(2, e2e.N_BINS)
    loss1, _ = dryrun._single_process_loss_and_grad(
        vol.rag, (vol.pb, vol.intensity), arrays["labels"],
        mlp2_init(D, e2e.N1, e2e.N2, 0), dev)
    losses = res["losses"]
    loss_rel = abs(losses[0] - loss1) / abs(loss1)
    if loss_rel > SNEMI_LOSS_RTOL or not losses[-1] < losses[0]:
        failures.append(f"losses {losses[0]} .. {losses[-1]} against the "
                        f"single-process {loss1} (rel {loss_rel})")
    emit({"phase": "slice_snemi", "part": "e2e", "Z": z,
          "side": SNEMI_SIDE, "n_cells": 4 * z, "R": res["regions"],
          "E": res["edges"], "world": res["shards"],
          "backend": res["backend"], "stages_s": res["stages_s"],
          "wall_s": res["wall_s"], "rank_s": res["rank_s"],
          "loss_trace": res["loss_trace"], "loss_single": loss1,
          "loss_rel": loss_rel, "edge_acc": res["edge_acc"],
          "watershed_vi": res["watershed_vi"],
          "watershed_rand_error": res["watershed_rand_error"],
          "cuts": res["cuts"], "merges": res["merges"],
          "merge_stats": res["merge_stats"],
          "rows_equal_fused_f64": same_rows, "fused_f64_s": fused_s,
          "repeat_identical": repeat, "rerun_identical": rerun,
          "f64_exact_rel_gap_vs_replay": gap64,
          "pair_counts_equal_host": True, "host_check": chk,
          "peak_rss_gb": res["peak_rss_gb"],
          "card_peak_gb": res["card_peak_gb"], "launches": paths})

    # the partition and halo counters and the halo step's time
    sh = shd.snemi_sharded(vol, shards=8, device=dev,
                           timeout_s=SNEMI_TIMEOUT_S)
    emit({"phase": "slice_snemi", "part": "sharded", **{k: sh[k] for k in (
        "shards", "world", "backend", "cut_fraction", "balance",
        "halo_rows", "dense_rows", "comm_ratio_vs_dense",
        "halo_bytes_per_step", "step_s", "steps_s", "edges_per_s",
        "loss_first", "loss_after", "stages_s", "spawn_wall_s",
        "rank_card_peak_gb")}})

    # (f) one sum of each kind, held to the plain sum and timed
    score = next(x for x in main_sums if x[0].ndim == 2
                 and x[0].dtype == torch.float32)
    pairs = next(x for x in main_sums if x[0].ndim == 1
                 and x[0].dtype == torch.float64)
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cases = [("snemi_halo_partials",
              *arrays["train_ranks"][0]["b2_sample"]),
             ("snemi_score_incident", *score),
             ("snemi_pair_counts", *pairs)]
    cases += [(f"snemi_{k}", *x) for k, x in
              arrays["merge_ranks"][0]["b2_samples"].items()]
    b2 = [check_segment_sum(name, as_dev(vals), as_dev(ids), S, srt)
          for name, vals, ids, S, srt in cases]
    emit({"phase": "slice_snemi", "part": "done",
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_snemi: {failures}")
    return paths, b2


# BASELINE config #2 (BASELINE.json:8; tools/run_3d_hmt.py:52-96), as
# glia_tpu_torch.examples.run_3d_hmt runs it: a synthetic EM volume of
# VOL_Z x 512 x 512 voxels and 400 cells, seed 17; its forest trained by
# hmt_train (80 trees, pre-merge 50, watershed 0.04) on an independent
# subvolume (run_3d_hmt.train_config), seed 31.  A cut depth keeps the
# cell density (n_cells in proportion to Z) and the 512^2 sections.
VOL_Z = 100
# the depth the script runs at: at 100 sections slice_3d took 341 s of
# the script's budget of about 240 s, the host's pre-merge 94-102 s of
# each of its two segmentations; at 64 sections the whole script took
# 776 s on one host and 1048 s of its 1200 s limit on a slower one
# (every host stage 1.3-1.9x), slice_3d 237 / 346 s of it; at 52, with
# slice_tools added, 1155 s on a slow host, slice_3d 208 s of it
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 4)
VOL_Z_RUN = 36
VOL_SIDE = 512
VOL_CELLS = 400


def segment_line(launches, wall, info, st):
    """A segmentation's line (wall, launches, stage seconds, merges,
    picks, the merge's stats), its order first checked to be a merge
    forest."""
    check_order(info["order"], info["probs"], len(np.unique(info["seg0"])),
                int(info["seg0"].max()))
    return {"wall_s": wall, "launches": launches,
            "stages_s": {k: x for k, x in st.items() if k.startswith("t_")},
            "merges": int(len(info["order"])), "n_picks": info["n_picks"],
            **{k: st[k] for k in ("n_supersteps", "buckets", "fallback",
                                  "plan_replayed") if k in st}}


def counted_run(paths, name, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, into ``paths[name]``; returns (its result, the forest_votes_cuda
    calls it made)."""
    from glia_tpu_torch.ops import cuda as kcuda

    kcuda.reset_launches()
    out, calls = capture_calls(kcuda, "forest_votes_cuda", fn)
    torch.cuda.synchronize()
    paths[name] = dict(kcuda.launches)
    return out, calls


def require_launches(paths, name, kernels):
    for k in kernels:
        if paths[name][k] == 0:
            raise AssertionError(f"{name}: {k} never launched")


def phase_slice_3d(dev, z, seed):
    """BASELINE config #2, 3D HMT on the card (tools/run_3d_hmt.py's flow):

    - glia_tpu_torch.examples.run_3d_hmt at depth ``z``: the volume and
      the training subvolume; the forest of hmt_train on the subvolume,
      at the volume's BC width; pipeline3d.hmt3d_segment (engine="host":
      the serial C++ merge order) with its defaults: the forest walked on
      the card; the example's result line;
    - hmt_segment(engine="device", backend="device") on the whole volume:
      the multi-phase merge on the 3D supervoxel RAG (no fallback, or the
      script fails), B1 on the volume's batch against the plain walk (0
      mismatches, or the script fails); the device merge twice more (the
      path's rows and identical saliencies, or the script fails); the mean
      flow with exact saliencies on the card in float64 against the C++
      replay (within EXACT_F64_RTOL, or the script fails); B2 at the
      volume's shapes;
    - hmt_segment(engine="device_bc") on the training subvolume with a
      forest on its BC vector without the saliency columns: every B1
      batch and every B2 sum of the loop held to the plain versions (or
      the script fails), B1 timed at the first batch and B2 at the first
      superstep's sums;
    - supervoxels, RAG edges, merges, stage seconds, VI / adapted Rand
      against the truth beside the watershed baseline's.

    Returns (launch counts per path, B1's checks, B2's checks, the data
    the later phases use)."""
    import glia_tpu_torch.graph.merge_device as md
    import glia_tpu_torch.pipeline as tp
    from glia_tpu_torch.examples import run_3d_hmt as r3d
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.features.hierarchical import TreeFeatures
    from glia_tpu_torch.features.labels import bc_labels
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.models.forest import train_forest

    t_phase = time.perf_counter()
    paths, b1, b2, failures = {}, [], [], []
    n_cells = VOL_CELLS * z // VOL_Z
    seg_kw = dict(watershed_level=r3d.WATERSHED_LEVEL,
                  pre_merge_size=r3d.PRE_MERGE)

    def segment(name, fn):
        st = {}
        t = time.perf_counter()
        (out, info), calls = counted_run(paths, name, lambda: fn(st))
        wall = time.perf_counter() - t
        return out, info, calls, segment_line(paths[name], wall, info, st)

    # the volume, its forest and the host engine's segmentation: the
    # example run_3d_hmt at depth z
    arr, lines = {}, {}
    tool, _ = counted_run(paths, "3d_host", lambda: r3d.run_3d_hmt(
        z, VOL_SIDE, n_cells, device=dev, arrays=arr))
    vol, tr_vol, model = arr["volume"], arr["train"], arr["model"]
    pb, intensity, truth = vol["pb"], vol["intensity"], vol["truth"]
    info_h, seg0 = arr["aux"], arr["aux"]["seg0"]
    lines["host"] = segment_line(paths["3d_host"],
                                 tool["stages_s"]["segment"], info_h,
                                 arr["segment_stats"])
    lines["host"]["eval"] = arr["eval_hmt"]
    base = arr["eval_watershed"]
    evaluate_s = tool["stages_s"]["evaluate"]
    tz, tside, tcells = r3d.train_config(z, VOL_SIDE, n_cells)
    emit({"phase": "slice_3d", "part": "data",
          "volume": [z, VOL_SIDE, VOL_SIDE], "voxels": tool["voxels"],
          "voxels_over_2_24": tool["voxels"] > 2 ** 24, "n_cells": n_cells,
          "train_volume": [tz, tside, tside], "train_cells": tcells,
          "generate_s": tool["stages_s"]["generate"],
          "train_s": tool["stages_s"]["train"],
          "train_stages_s": arr["train_stats"], "D": model.forest.n_features,
          "forest": forest_shape(model.forest), "run_3d_hmt": tool})
    seg_d, info_d, calls_d, lines["device"] = segment(
        "3d_device", lambda st: tp.hmt_segment(
            pb, intensity, model, engine="device", backend="device",
            device=dev, stats=st, **seg_kw))
    lines["device"]["eval"] = tp.evaluate(seg_d, truth)
    require_launches(paths, "3d_host", ["forest_votes"])
    require_launches(paths, "3d_device", ["forest_votes", "segment_sum"])
    if not np.array_equal(info_d["seg0"], seg0):
        failures.append("engine='device' over-segmentation differs from "
                        "hmt3d_segment's")
    if lines["device"].get("fallback") is not False:
        failures.append("fused_ms fell back to the single-phase engine on "
                        "the 3D RAG")
    # the memo is keyed by shape: the volume's first device merge measures
    # its own plan, replaying none of the sections'
    if lines["device"].get("plan_replayed") is not False:
        failures.append("the 3D RAG replayed a plan measured on another "
                        "graph")
    b1.append(phase_kernel(calls_d[0][0][0], model.forest, seed,
                           path="3d_device"))

    # the device merge twice more: the path's rows, identical saliencies;
    # B2 at the first call's shapes
    t = time.perf_counter()
    rag = build_rag(seg0, contour_only=False)
    rag_s = time.perf_counter() - t
    runs = []
    sums = capture_segment_sums(lambda: runs.append(md.greedy_merge_device(
        rag, pb, policy=model.policy, device=dev)), first=1)
    runs.append(md.greedy_merge_device(rag, pb, policy=model.policy,
                                       device=dev))
    rerun = {"rows_equal_path": all(np.array_equal(o, info_d["order"])
                                    for o, _ in runs),
             "identical": bool(np.array_equal(runs[0][0], runs[1][0])
                               and np.array_equal(runs[0][1], runs[1][1],
                                                  equal_nan=True))}
    if not (rerun["rows_equal_path"] and rerun["identical"]):
        failures.append(f"device merge reruns differ on the volume: {rerun}")
    b2.append(check_segment_sum("3d_dedupe_median", *sums[0]))

    # exact saliencies of the mean flow on the card in float64 against
    # the C++ replay of its order; B2 at its LCA-keyed sum
    R = rag.n_regions
    u, v, s, c = md.edge_mean_arrays(rag, pb)
    st64 = {}
    sums = capture_segment_sums(lambda: runs.append(
        md.merge_batched_device_exact(u, v, s, c, R, dtype=torch.float64,
                                      stats=st64, device=dev)))
    o64, sal64, n64 = runs[-1]
    host64 = md.replay_exact_saliency(u, v, s, c, o64[:n64].cpu().numpy(),
                                      engine="native")
    exact = {"merges": n64, "supersteps": st64["n_supersteps"],
             "buckets": st64["buckets"], "fallback": st64["fallback"],
             "f64_rel_gap_vs_replay": rel_gap(
                 -sal64[:n64].cpu().numpy(), host64)}
    if exact["f64_rel_gap_vs_replay"] > EXACT_F64_RTOL or exact["fallback"]:
        failures.append(f"float64 exact saliencies on the volume: {exact}")
    b2.append(check_segment_sum("3d_lca_keys", *sums[-2]))

    # device_bc on the training subvolume, with a forest on its BC vector
    # without the saliency columns
    t = time.perf_counter()
    st_bc = {}
    seg_t, order_t, _ = tp._training_slice(
        tr_vol, "median", r3d.WATERSHED_LEVEL, r3d.PRE_MERGE,
        tp.HmtModel(forest=None), st_bc)
    X_bc = TreeFeatures(build_rag(seg_t, contour_only=False), order_t,
                        FeatureConfig.standard(tr_vol["pb"],
                                               tr_vol["intensity"],
                                               n_bins=16)).bc_features()
    y_bc = bc_labels(seg_t, tr_vol["truth"], order_t, rule="f1")[0]
    bc_forest = train_forest(X_bc, y_bc, n_trees=r3d.N_TREES, seed=0,
                             n_jobs=-1)
    bc_train_s = time.perf_counter() - t
    bc_sums, bc_outs = [], []

    def device_bc(st):
        box = []
        bc_sums[:] = capture_segment_sums(lambda: box.append(tp.hmt_segment(
            tr_vol["pb"], tr_vol["intensity"],
            tp.HmtModel(forest=bc_forest), engine="device_bc", device=dev,
            stats=st, **seg_kw)), outputs=bc_outs)
        return box[0]

    seg_bc, info_bc, calls_bc, lines["device_bc"] = segment(
        "3d_device_bc", device_bc)
    require_launches(paths, "3d_device_bc", ["forest_votes", "segment_sum"])
    # every B1 batch and every B2 sum of the loop against the plain
    # versions on the card (0 vote fractions differing, sums within
    # SEGMENT_SUM_RTOL), or the script fails
    from glia_tpu_torch.models.forest import forest_votes_torch

    b1_batches = sum(int((out != forest_votes_torch(args[0], args[1])).sum())
                     for args, out in calls_bc)
    if b1_batches:
        failures.append(f"B1 on the 3D device_bc loop's batches: "
                        f"{b1_batches} vote fractions differ from the plain "
                        f"walk")
    if paths["3d_device_bc"]["segment_sum"] > len(bc_sums):
        failures.append("the 3D device_bc loop launched B2 outside "
                        "segment_sum_auto")
    lines["device_bc"].update(
        volume=[tz, tside, tside], D=int(X_bc.shape[1]),
        train_s=bc_train_s, eval=tp.evaluate(seg_bc, tr_vol["truth"]),
        eval_watershed=tp.evaluate(info_bc["seg0"], tr_vol["truth"]),
        b1_batches_held=len(calls_bc), b1_batch_mismatches=b1_batches,
        b2_sums_held=hold_segment_sums("3d_device_bc", bc_sums, bc_outs))
    # B1 timed at the loop's first batch (every candidate of the
    # subvolume), B2 at its first superstep's sums
    b1.append(phase_kernel(calls_bc[0][0][0], bc_forest, seed,
                           path="3d_device_bc"))
    b2 += [check_segment_sum(*case)
           for case in bc_superstep_sums(bc_sums, 0, prefix="3d_")]

    emit({"phase": "slice_3d", "part": "segment",
          "supervoxels": R, "rag_edges": rag.n_edges, "rag_s": rag_s,
          "eval_watershed": base, "evaluate_s": evaluate_s,
          "segment": lines, "rerun": rerun, "exact_saliency": exact,
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_3d: {failures}")
    return paths, b1, b2, {"stack": vol["stack"], "train": tr_vol["stack"],
                           "model": model}


# the link forest's trees and the linking threshold of
# pipeline3d.link3d_train / link3d_segment's defaults
LINK_TREES = 100


def phase_slice_link3d(dev, vol, seed):
    """LINK3D on the card (glia_tpu's tests/test_pipeline3d.py flow at the
    volume's scale): link3d_train on the training subvolume's sections
    with their truth as the segmentations, link3d_segment on the volume's
    sections (their truth as the per-section segmentations) with the
    forest walked on the card, B1 at the link rows against the plain walk
    (0 mismatches, or the script fails); pairs, links, seconds and the
    linking error (adapted Rand of the linked volume against the 3D
    truth, section by section).  Returns (launch counts, B1's check)."""
    from glia_tpu_torch.metrics import eval_ri
    from glia_tpu_torch.pipeline3d import link3d_segment, link3d_train

    t_phase = time.perf_counter()
    paths = {}
    tr, stack = vol["train"], vol["stack"]
    t = time.perf_counter()
    model = link3d_train(tr["slices"], [s["truth"] for s in tr["slices"]],
                         n_trees=LINK_TREES)
    train_s = time.perf_counter() - t
    slices = stack["slices"]
    segs = [s["truth"] for s in slices]
    st = {}
    t = time.perf_counter()
    linked, calls = counted_run(paths, "link3d", lambda: link3d_segment(
        slices, segs, model, device=dev, stats=st))
    wall = time.perf_counter() - t
    require_launches(paths, "link3d", ["forest_votes"])
    truth = stack["truth3d"]
    prec, rec, err = eval_ri(list(linked), list(truth))
    b1 = phase_kernel(calls[0][0][0], model, seed, path="link3d")
    emit({"phase": "slice_link3d", "sections": len(slices),
          "train_sections": len(tr["slices"]), "train_s": train_s,
          "forest": forest_shape(model), "D": int(calls[0][0][0].shape[1]),
          "pairs": st["pairs"], "links": st["links"], "wall_s": wall,
          "stages_s": {k: x for k, x in st.items() if k.startswith("t_")},
          "launches": paths["link3d"],
          "linking_error": {"precision": prec, "recall": rec, "error": err},
          "groups": int(len(np.unique(linked))),
          "phase_s": time.perf_counter() - t_phase})
    return paths, b1


# trees of the CLI chain's forests (train_rf --nTree)
CLI_TREES = 100


def phase_slice_cli(data, vol, dev, workdir):
    """The file bus: glia_tpu_torch.cli's main, subcommand by subcommand,
    on the data section through ``.npy`` images and text files in
    ``workdir``: watershed, pre_merge, merge_order_pb --engine device,
    bc_feat (with and without the saliency columns), bc_label, train_rf,
    pred_rf, merge_order_bc --engine device, segment_greedy, eval_vi,
    eval_ri; then the LINK3D subcommands on the volume's first two
    sections (gen_region_pairs, sc_feat, sc_label, a link forest by
    train_rf and pred_rf --label 1, link_by_threshold,
    group_region_profiles).  Each
    output must equal what the library call it wraps gives on the same
    inputs in this process, or the script fails; the subcommands that
    run on the card are counted.  Returns (launch counts per path, the
    seconds of each subcommand)."""
    import contextlib
    import importlib
    import io as stdio
    import os

    import glia_tpu_torch.graph.merge_device as md
    import glia_tpu_torch.pipeline as tp
    from glia_tpu_torch.features.config import FeatureConfig
    from glia_tpu_torch.features.hierarchical import TreeFeatures
    from glia_tpu_torch.features.labels import bc_labels
    from glia_tpu_torch.graph.merge_bc_device import merge_order_bc_device
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.graph.tree import build_tree, node_potentials
    from glia_tpu_torch.infer.greedy import resolve_tree_greedy
    from glia_tpu_torch.infer.segment import final_segmentation
    from glia_tpu_torch.io.image import read_label_image
    from glia_tpu_torch.io.text import (read_matrix, read_merge_order,
                                        read_vector)
    from glia_tpu_torch.link3d import link as ll
    from glia_tpu_torch.metrics import eval_ri, eval_vi
    from glia_tpu_torch.models.forest import (ForestModel, make_label_scorer,
                                              predict_label_fraction,
                                              train_forest)

    cli = importlib.import_module("glia_tpu_torch.cli.main")
    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    paths, seconds, failures = {}, {}, []

    def f(name):
        return os.path.join(workdir, name)

    def run(*argv, count=None):
        """One subcommand through cli.main on ``dev``; returns what it
        printed."""
        out = stdio.StringIO()
        full = list(argv) + ["--device", str(dev)]
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if count:
                counted_run(paths, count, lambda: cli.main(full))
            else:
                cli.main(full)
        seconds[argv[0]] = seconds.get(argv[0], 0.0) + \
            time.perf_counter() - t
        return out.getvalue()

    def same(name, got, want):
        if isinstance(want, list):
            ok = len(got) == len(want) and all(
                np.array_equal(g, w) for g, w in zip(got, want))
        else:
            ok = np.array_equal(got, want)
        if not ok:
            failures.append(f"{name}: the subcommand's output differs from "
                            f"the library call's")

    pb, intensity, truth = data["pb"], data["intensity"], data["truth"]
    for name, arr in (("pb", pb), ("raw", intensity), ("truth", truth)):
        np.save(f(f"{name}.npy"), arr)

    run("watershed", "-i", f("pb.npy"), "-l", "0.05", "-o", f("ws.npy"))
    ws = tp.watershed(pb, 0.05)
    same("watershed", read_label_image(f("ws.npy")), ws)
    run("pre_merge", "-s", f("ws.npy"), "-p", f("pb.npy"), "-t", "30",
        "-o", f("seg0.npy"))
    seg0 = tp.pre_merge(ws, pb, (30,))
    same("pre_merge", read_label_image(f("seg0.npy")), seg0)

    run("merge_order_pb", "-s", f("seg0.npy"), "-p", f("pb.npy"),
        "--engine", "device", "-o", f("order.txt"), "-y", f("sal.txt"),
        count="cli_merge_order_pb")
    require_launches(paths, "cli_merge_order_pb", ["segment_sum"])
    order, sals = md.greedy_merge_device(
        build_rag(seg0, contour_only=True), pb, policy="median", device=dev)
    same("merge_order_pb", read_merge_order(f("order.txt")), order)
    same("merge_order_pb saliencies", read_vector(f("sal.txt")), sals)

    rag = build_rag(seg0, contour_only=False)
    cfg = FeatureConfig.standard(pb, intensity, n_bins=16)
    run("bc_feat", "-s", f("seg0.npy"), "-p", f("pb.npy"), "--rawImage",
        f("raw.npy"), "-o", f("order.txt"), "-y", f("sal.txt"), "-b",
        f("feat.txt"))
    X = TreeFeatures(rag, order, cfg, saliencies=sals).bc_features()
    same("bc_feat", read_matrix(f("feat.txt")), X)
    run("bc_feat", "-s", f("seg0.npy"), "-p", f("pb.npy"), "--rawImage",
        f("raw.npy"), "-o", f("order.txt"), "-b", f("feat_bc.txt"))
    X_bc = TreeFeatures(rag, order, cfg).bc_features()
    same("bc_feat without saliencies", read_matrix(f("feat_bc.txt")), X_bc)
    run("bc_label", "-s", f("seg0.npy"), "-t", f("truth.npy"), "-o",
        f("order.txt"), "-l", f("labels.txt"))
    y = bc_labels(seg0, truth, order, rule="f1")[0]
    same("bc_label", read_vector(f("labels.txt"), dtype=np.int64), y)

    forests = {}
    for name, feats in (("rf", X), ("rf_bc", X_bc)):
        run("train_rf", "-f", f(f"{'feat' if name == 'rf' else 'feat_bc'}"
                                f".txt"), "-l", f("labels.txt"), "--nTree",
            str(CLI_TREES), "-m", f(f"{name}.npz"))
        got = ForestModel.load(f(f"{name}.npz"))
        want = train_forest(feats, y, n_trees=CLI_TREES, seed=0, n_jobs=-1)
        same(f"train_rf {name}", [getattr(got, k) for k in (
            "feature", "threshold", "left", "right", "leaf_class")],
            [getattr(want, k) for k in ("feature", "threshold", "left",
                                        "right", "leaf_class")])
        forests[name] = want
    run("pred_rf", "-m", f("rf.npz"), "-f", f("feat.txt"), "-o",
        f("probs.txt"))
    probs = predict_label_fraction(forests["rf"], X, label=-1)
    same("pred_rf", read_vector(f("probs.txt")), probs)

    run("merge_order_bc", "-s", f("seg0.npy"), "-p", f("pb.npy"),
        "--rawImage", f("raw.npy"), "-m", f("rf_bc.npz"), "--engine",
        "device", "-o", f("order_bc.txt"), "-y", f("sal_bc.txt"),
        count="cli_merge_order_bc")
    require_launches(paths, "cli_merge_order_bc",
                     ["forest_votes", "segment_sum"])
    order_bc, probs_bc = merge_order_bc_device(
        rag, cfg, make_label_scorer(forests["rf_bc"], label=-1, device=dev),
        device=dev)
    same("merge_order_bc", read_merge_order(f("order_bc.txt")), order_bc)
    same("merge_order_bc probabilities", read_vector(f("sal_bc.txt")),
         probs_bc)

    run("segment_greedy", "-s", f("seg0.npy"), "-o", f("order.txt"), "-p",
        f("probs.txt"), "-f", f("final.npy"))
    tree = build_tree(order)
    final = final_segmentation(
        seg0, tree, resolve_tree_greedy(tree, node_potentials(tree, probs)))
    same("segment_greedy", read_label_image(f("final.npy")), final)
    printed_vi = run("eval_vi", "-p", f("final.npy"), "-r", f("truth.npy"))
    fs, fm, vi = eval_vi([final], [truth])
    same("eval_vi", printed_vi, f"{fs:.6g} {fm:.6g} {vi:.6g}\n")
    printed_ri = run("eval_ri", "-p", f("final.npy"), "-r", f("truth.npy"))
    prec, rec, err = eval_ri([final], [truth])
    same("eval_ri", printed_ri, f"{prec:.6g} {rec:.6g} {err:.6g}\n")

    # LINK3D on the volume's first two sections
    sl = vol["stack"]["slices"][:2]
    for z in range(2):
        np.save(f(f"s{z}.npy"), sl[z]["truth"])
    np.save(f("pbz.npy"), sl[0]["pb"])
    run("gen_region_pairs", "--s0", f("s0.npy"), "--s1", f("s1.npy"),
        "--id0", "0", "--id1", "1", "-o", f("pairs.txt"))
    pairs, _ = ll.gen_region_pairs(sl[0]["truth"], sl[1]["truth"], 0, 1)
    same("gen_region_pairs", np.loadtxt(f("pairs.txt"), dtype=np.int64,
                                        ndmin=2),
         np.array([[a, b, c, d] for (a, b), (c, d) in pairs]))
    run("sc_feat", "--s0", f("s0.npy"), "--s1", f("s1.npy"), "-p",
        f("pbz.npy"), "--pairs", f("pairs.txt"), "--bins", "8", "-o",
        f("sc.txt"))
    sc = ll.sc_features(sl[0]["truth"], sl[1]["truth"],
                        FeatureConfig.standard(sl[0]["pb"], n_bins=8),
                        pairs)
    same("sc_feat", read_matrix(f("sc.txt")), sc)
    run("sc_label", "--s0", f("s0.npy"), "--s1", f("s1.npy"), "--t0",
        f("s0.npy"), "--t1", f("s1.npy"), "--pairs", f("pairs.txt"), "-o",
        f("sc_labels.txt"))
    same("sc_label", read_vector(f("sc_labels.txt"), dtype=np.int64),
         ll.sc_labels(sl[0]["truth"], sl[0]["truth"], sl[1]["truth"],
                      sl[1]["truth"], pairs)[0])
    # sc_feat's rows (pb only) are scored by a forest trained on them
    run("train_rf", "-f", f("sc.txt"), "-l", f("sc_labels.txt"), "--nTree",
        "20", "-m", f("sc_rf.npz"))
    run("pred_rf", "-m", f("sc_rf.npz"), "-f", f("sc.txt"), "--label", "1",
        "-o", f("scores.txt"))
    scores = read_vector(f("scores.txt"))
    sc_y = read_vector(f("sc_labels.txt"), dtype=np.int64)
    same("pred_rf --label 1", scores, predict_label_fraction(
        train_forest(sc, sc_y, n_trees=20, seed=0, n_jobs=-1), sc, label=1))
    run("link_by_threshold", "--pairs", f("pairs.txt"), "--scores",
        f("scores.txt"), "--minScore", "0.5", "-o", f("links.txt"))
    links = ll.link_by_threshold(pairs, scores, 0.5)
    same("link_by_threshold", np.loadtxt(f("links.txt"), dtype=np.int64,
                                         ndmin=2),
         np.array([[a, b, c, d] for (a, b), (c, d) in links]))
    run("group_region_profiles", "-s", f("s0.npy"), f("s1.npy"), "--ids",
        "0", "1", "-l", f("links.txt"), "-o", f("vol%d.npy"))
    grouped = ll.group_region_profiles([sl[0]["truth"], sl[1]["truth"]],
                                       [0, 1], links)
    same("group_region_profiles",
         np.stack([read_label_image(f(f"vol{z}.npy")) for z in range(2)]),
         grouped)
    emit({"phase": "slice_cli", "subcommands": sorted(seconds),
          "seconds": seconds, "merges": int(len(order)),
          "merges_bc": int(len(order_bc)), "pairs": len(pairs),
          "links": len(links), "eval_vi": printed_vi.split(),
          "eval_ri": printed_ri.split(),
          "launches": {k: paths[k] for k in paths},
          "phase_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"slice_cli: {failures}")
    return paths, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=255)
    ap.add_argument("--depth", type=int, default=24)
    # one process of slice_merge's plan-store check (plan_store_check)
    ap.add_argument("--plan-store-child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    import glia_tpu_torch  # noqa: F401  (fails outside the repository)

    if args.plan_store_child:
        plan_store_child(args.plan_store_child)
        return 0

    dev = torch.device("cuda")
    smi = phase_env()
    phase_build()
    paths = {}
    data, seg, rag, feats, model = phase_data(
        args.side, args.seed, args.trees, args.depth, dev)
    b1 = phase_kernel(feats, model, args.seed)
    phase_kernel_forest_shapes(feats, args.seed)
    b2_shapes = phase_kernel_segment(data, rag, model, dev, args.seed)
    paths["device_bc"] = phase_slice(data, model, dev)
    device_paths, b1_device, forest = phase_slice_device(
        data, seg, rag, dev, args.seed, args.trees, args.depth)
    paths.update(device_paths)
    train_paths, b1_host, forest_inputs = phase_slice_train(
        data, seg, rag, forest, dev, args.side, args.seed)
    paths.update(train_paths)
    forest_paths, b1_trained = phase_slice_forest(
        data, seg, dev, forest_inputs, args.seed)
    paths.update(forest_paths)
    merge_paths, b2_merge, bench = phase_slice_merge(data, seg, rag, dev)
    paths.update(merge_paths)
    cli_bench_paths, b2_bench_cli = phase_bench_cli(dev)
    paths.update(cli_bench_paths)
    phase_card_suite()
    tools_paths, b1_tools = phase_slice_tools(dev, args.seed)
    paths.update(tools_paths)
    b1_all = [b1, b1_device, b1_host, *b1_trained, b1_tools]
    b2_shapes += b2_merge + b2_bench_cli
    par_paths, b1_par, b2_par = phase_slice_parallel(bench, dev, args.seed)
    del bench
    paths.update(par_paths)
    b1_all.append(b1_par)
    b2_shapes += b2_par
    snemi_paths, b2_snemi = phase_slice_snemi(dev, SNEMI_Z_RUN)
    paths.update(snemi_paths)
    b2_shapes += b2_snemi
    vol_paths, b1_3d, b2_3d, vol = phase_slice_3d(dev, VOL_Z_RUN, args.seed)
    paths.update(vol_paths)
    b1_all += b1_3d
    b2_shapes += b2_3d
    link_paths, b1_link = phase_slice_link3d(dev, vol, args.seed)
    paths.update(link_paths)
    b1_all.append(b1_link)
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        cli_paths, _ = phase_slice_cli(data, vol, dev, workdir)
    paths.update(cli_paths)
    # one line per kernel: B1's headline numbers are the first path's
    # batch (device_bc's in a whole run), with every other path's batch
    # listed beside them; B2's are its first shape's
    sub = ("path", "shape", "mismatches", "max_abs_err", "ms",
           "global_memory_ms", "plain_ms", "bound_ms", "bound_by", "plan",
           "mean_steps")
    b1 = dict(b1_all[0])
    b1["shapes"] = [{k: r[k] for k in sub} for r in b1_all]
    b1["mismatches"] = sum(r["mismatches"] for r in b1_all)
    b1["max_abs_err"] = max(r["max_abs_err"] for r in b1_all)
    b2 = segment_sum_line(b2_shapes)
    kernels = [b1, b2]
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
