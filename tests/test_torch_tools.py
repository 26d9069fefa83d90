"""The port's counterparts of glia_tpu's scripts under tools/
(glia_tpu_torch.examples: run_3d_hmt, bench_merge_device,
bench_bc_device, bench_forest_pallas, bench_bc_midcut,
bench_median_drift, bench_scaling) against the tools on the same inputs,
at small sizes, the port on the CPU.

- run_3d_hmt (8 x 96 x 96): supervoxels and merges equal, VI and adapted
  Rand error within 1e-9 of glia_tpu's flow (tools/run_3d_hmt.py's calls,
  unrounded; the tool rounds its printout);
- bc_midcut_compare (128^2, 60 cells, 40 trees) and median_drift (128^2,
  both policies): the tools' own functions, taken from tools/ with
  ``ast`` as tests/test_torch_snemi.py takes its tool's; rows within
  1e-9, dicts equal;
- bench_scaling at 1 and 2 CPU gloo ranks: the partition and halo keys
  equal to glia_tpu's, the first step's loss within 1e-5 relative of
  glia_tpu's halo step on a mesh of as many devices (float32, summed in
  other orders);
- the three timing tools: ``main`` with ``--device cpu`` prints the
  tool's keys (read from the tool's source), the quality numbers beside
  them matching the tool's flow where the test has it;
- every example raises when no card is there and none was named.
"""

import ast
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from glia_tpu_torch.bench import bench_section
from glia_tpu_torch.examples import (bench_bc_device, bench_bc_midcut,
                                     bench_forest_pallas, bench_median_drift,
                                     bench_merge_device, bench_scaling,
                                     run_3d_hmt)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
FLOW_ATOL = 1e-9
LOSS_RTOL = 1e-5


def _tool_printed_keys(name):
    """The JSON keys a tool prints from an f-string (``\\"key\\":``)."""
    with open(os.path.join(TOOLS, f"{name}.py")) as f:
        return set(re.findall(r'\\"(\w+)\\":', f.read()))


def _tool_out_keys(name):
    """The string keys of the tool's ``out = {...}`` literal."""
    with open(os.path.join(TOOLS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
    return keys


def _tool_function(name, fn):
    """The tool's function ``fn``, taken from its source with ``ast`` and
    run with its module's names (importing the tool would switch on
    glia_tpu's compile cache and plan store, which write into the
    repository)."""
    import time

    import scipy.ndimage as ndi

    path = os.path.join(TOOLS, f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in (fn, "log")]
    ns = {"np": np, "ndi": ndi, "os": os, "sys": sys, "time": time,
          "__file__": path}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns[fn]


def _main_json(capsys, module, argv):
    module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# run_3d_hmt
# ---------------------------------------------------------------------------

def _glia_3d_flow(Z, side, n_cells):
    """tools/run_3d_hmt.py's calls with glia_tpu, unrounded."""
    from glia_tpu.data.synthetic import synthetic_em_stack
    from glia_tpu.pipeline import evaluate, hmt_train
    from glia_tpu.pipeline3d import hmt3d_segment

    stack = synthetic_em_stack(shape=(Z, side, side), n_cells=n_cells,
                               seed=17)
    pb_vol = stack["pb3d"]
    int_vol = np.stack([s["intensity"] for s in stack["slices"]])
    tz, tside = max(Z // 4, 8), max(side // 2, 64)
    tcells = max(n_cells * (tz * tside * tside) // (Z * side * side), 8)
    tr = synthetic_em_stack(shape=(tz, tside, tside), n_cells=tcells,
                            seed=31)
    tr_vol = {"pb": tr["pb3d"], "truth": tr["truth3d"],
              "intensity": np.stack([s["intensity"] for s in tr["slices"]])}
    model = hmt_train([tr_vol], n_trees=80, pre_merge_size=50,
                      watershed_level=0.04)
    seg, aux = hmt3d_segment(pb_vol, int_vol, model, watershed_level=0.04,
                             pre_merge_size=50)
    base = evaluate(aux["seg0"], stack["truth3d"])
    ours = evaluate(seg, stack["truth3d"])
    return {"voxels": int(pb_vol.size),
            "supervoxels": int(len(np.unique(aux["seg0"]))),
            "merges": int(len(aux["order"])),
            "vi_watershed": base["vi"], "vi_hmt": ours["vi"],
            "rand_error_watershed": base["rand_error"],
            "rand_error_hmt": ours["rand_error"]}


def test_run_3d_hmt_matches_the_tools_flow():
    Z, side, cells = 8, 96, 12
    got = run_3d_hmt.run_3d_hmt(Z, side, cells, device="cpu")
    want = _glia_3d_flow(Z, side, cells)
    assert _tool_out_keys("run_3d_hmt") <= set(got)
    assert got["config"] == f"3D HMT {Z}x{side}x{side}"
    for k in ("voxels", "supervoxels", "merges"):
        assert got[k] == want[k], k
    assert got["merges"] > 0
    for k in ("vi_watershed", "vi_hmt", "rand_error_watershed",
              "rand_error_hmt"):
        assert abs(got[k] - want[k]) <= FLOW_ATOL, (k, got[k], want[k])
    assert set(got["stages_s"]) == {"generate", "train", "segment",
                                    "evaluate"}


def test_run_3d_hmt_train_config_is_the_tools():
    """The training subvolume of the tool's formula, at full scale and at
    the chip smoke script's cut depth."""
    assert run_3d_hmt.train_config(100, 512, 400) == (25, 256, 25)
    assert run_3d_hmt.train_config(36, 512, 144) == (9, 256, 9)
    assert run_3d_hmt.train_config(8, 96, 12) == (8, 64, 8)


# ---------------------------------------------------------------------------
# the quality studies, against the tools' own functions
# ---------------------------------------------------------------------------

def test_bc_midcut_matches_the_tool():
    tool = _tool_function("bench_bc_midcut", "bc_midcut_compare")
    kw = dict(side=128, n_cells=60, n_trees=40, taus=(0.9, 0.7, 0.5))
    want = tool(**kw)
    got = bench_bc_midcut.bc_midcut_compare(**kw, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= FLOW_ATOL, (k, g, w)


@pytest.mark.parametrize("policy", bench_median_drift.POLICIES)
def test_median_drift_matches_the_tool(policy):
    tool = _tool_function("bench_median_drift", "median_drift")
    want = tool(side=128, policy=policy)
    got = bench_median_drift.median_drift(side=128, policy=policy,
                                          device="cpu")
    assert got == want


# ---------------------------------------------------------------------------
# bench_scaling against glia_tpu's halo step
# ---------------------------------------------------------------------------

def _glia_scaling_row(rag, data, labels, n):
    """The tool's row at ``n`` shards, unrounded, with the first step's
    loss on a mesh of ``n`` of conftest's CPU devices."""
    from glia_tpu.parallel.halo import HaloPlan
    from glia_tpu.parallel.mesh import make_mesh
    from glia_tpu.parallel.partition import partition_rag
    from glia_tpu.parallel.train import (make_halo_train_step,
                                         shard_halo_train_inputs)

    part = partition_rag(rag, n)
    plan = HaloPlan(part, rag)
    mesh = make_mesh(n)
    init, step, (_, D) = make_halo_train_step(
        mesh, plan, rag.n_regions, n_images=2, k_pixels=32, n_bins=16)
    batch = shard_halo_train_inputs(mesh, plan, part, rag,
                                    [data["pb"], data["intensity"]], labels,
                                    k_pixels=32, n_bins=16)
    w, st = init()
    _, _, loss = step(w, st, batch)
    dense_rows = n * rag.n_regions
    return {"shards": n, "cut_fraction": part.cut_fraction,
            "balance": part.balance(), "halo_rows": plan.comm_rows,
            "dense_rows": dense_rows,
            "comm_ratio_vs_dense": plan.comm_rows / max(dense_rows, 1),
            "feat_dim": D, "loss_first": float(loss)}


def test_bench_scaling_matches_glia_tpu():
    import scipy.ndimage as ndi

    from glia_tpu.data.synthetic import synthetic_em_slice
    from glia_tpu.graph.rag import build_rag
    from glia_tpu.native import watershed_native

    side, cells = 128, 60
    data = synthetic_em_slice((side, side), n_cells=cells, seed=9, blur=1.2,
                              noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0), level=0.004)
    rag = build_rag(seg, contour_only=False)
    labels = np.random.default_rng(0).integers(0, 2, rag.n_edges).astype(
        np.float32)
    rows = bench_scaling.bench_scaling(side, cells, worlds=(1, 2),
                                       device="cpu", timeout_s=300)
    for got in rows:
        want = _glia_scaling_row(rag, data, labels, got["shards"])
        for k in ("shards", "cut_fraction", "balance", "halo_rows",
                  "dense_rows", "comm_ratio_vs_dense", "feat_dim"):
            assert got[k] == want[k], (k, got[k], want[k])
        assert abs(got["loss_first"] - want["loss_first"]) \
            <= LOSS_RTOL * abs(want["loss_first"])
        assert got["step_ms"] > 0 and got["edges_per_s"] > 0
    assert rows[1]["halo_rows"] > 0
    tool_keys = {"shards", "step_ms", "edges_per_s", "cut_fraction",
                 "balance", "halo_rows", "dense_rows", "comm_ratio_vs_dense",
                 "feat_dim", "efficiency_vs_1shard", "speedup"}
    assert tool_keys <= set(rows[0])


# ---------------------------------------------------------------------------
# the timing tools: main() with --device cpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "fused_ms"])
def test_bench_merge_device_main_prints_the_tools_keys(capsys, mode):
    from glia_tpu.graph.merge import apply_merge_order
    from glia_tpu.metrics import eval_vi
    from glia_tpu.native import greedy_merge_native

    out = _main_json(capsys, bench_merge_device,
                     ["128", "60", mode, "--device", "cpu"])
    assert _tool_printed_keys("bench_merge_device") == {
        "edges", "compile_s", "device_edges_s", "host_edges_s", "vi_serial",
        "vi_batched"}
    assert _tool_printed_keys("bench_merge_device") <= set(out)
    assert out["mode"] == mode and out["device"] == "cpu"
    assert out["stats"].get("fallback", False) is False
    # the serial cut's VI as the tool computes it with glia_tpu
    data, seg, rag = bench_section(128, 60)
    order_h, _ = greedy_merge_native(rag, data["pb"], policy="mean")
    k = rag.n_regions - 60
    vi_h = eval_vi(apply_merge_order(seg, order_h, threshold_index=k),
                   data["truth"])[2]
    assert abs(out["vi_serial"] - vi_h) <= FLOW_ATOL
    assert out["edges"] == rag.n_edges


def test_bench_bc_device_main_prints_the_tools_keys(capsys):
    out = _main_json(capsys, bench_bc_device,
                     ["128", "40", "20", "--device", "cpu"])
    keys = _tool_printed_keys("bench_bc_device")
    assert keys == {"edges", "feat_dim", "compile_s", "scores_per_s",
                    "merges_per_s", "host_serial_edges_s", "vi_watershed",
                    "vi_bc"}
    assert keys <= set(out)
    assert out["feat_dim"] == 143 and out["steady_equal_first"]
    assert np.isfinite(out["vi_bc"]) and out["merges"] > 0


def test_bench_forest_main_prints_the_results(capsys):
    from glia_tpu.models.forest import predict_votes_np, train_forest

    out = _main_json(capsys, bench_forest_pallas,
                     ["512", "20", "16", "plain", "--device", "cpu"])
    assert (out["B"], out["T"], out["D"]) == (512, 20, 16)
    assert "cuda" not in out
    plain = out["plain"]
    assert plain["mismatches"] == 0
    assert set(plain) == {"compile_s", "mismatches", "ms_per_iter",
                          "samples_per_s", "tree_walks_per_s"}
    # the forest is the tool's: glia_tpu's sklearn forest on the same rows
    model, X = bench_forest_pallas.forest_case(512, 20, 16)
    rng = np.random.default_rng(0)
    Xtr = rng.random((4000, 16)).astype(np.float32)
    ytr = (Xtr[:, 0] + 0.5 * Xtr[:, 1] - 0.2 * Xtr[:, 2]
           + 0.1 * rng.standard_normal(4000) > 0.65).astype(np.int32)
    jx = train_forest(Xtr, ytr, n_trees=20, seed=0)
    np.testing.assert_array_equal(X, rng.random((512, 16)).astype(np.float32))
    np.testing.assert_array_equal(predict_votes_np(jx, X[:256]),
                                  predict_votes_np(model, X[:256]))


def test_bench_forest_refuses_the_cuda_walk_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensors"):
        bench_forest_pallas.bench_forest(64, 4, 8, "cuda", device="cpu")


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [
    lambda: run_3d_hmt.run_3d_hmt(8, 96, 12),
    lambda: bench_merge_device.bench_merge_device(128, 60),
    lambda: bench_bc_device.bench_bc_device(128, 40, 20),
    lambda: bench_forest_pallas.bench_forest(64, 4, 8),
    lambda: bench_bc_midcut.bc_midcut_compare(128, 60, 40),
    lambda: bench_median_drift.median_drift(128),
    lambda: bench_scaling.bench_scaling(128, 60, worlds=(1,)),
], ids=["run_3d_hmt", "bench_merge_device", "bench_bc_device",
        "bench_forest_pallas", "bench_bc_midcut", "bench_median_drift",
        "bench_scaling"])
def test_examples_need_a_card_unless_told(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
