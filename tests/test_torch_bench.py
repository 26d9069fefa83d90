"""glia_tpu_torch.bench (the counterpart of the repository's bench.py)
against bench.py's flow with glia_tpu's functions, on the CPU at 256^2.

bench.py's ``main`` is not called: it points JAX's persistent compile
cache at the repository.  ``_glia_flow`` makes bench.py's calls in its
order (first call, staged calls, the host replay, the cut at k = R -
cells on the device saliencies, on the engine's stale saliencies, and the
serial order's cut) with glia_tpu in x64; the port runs in float64.  R, E,
the merge count, the host serial order and the three cut VIs must be
equal, for each of bench.py's modes.  Then the script: one stdout line
with bench.py's keys; a bad mode exits non-zero with no stdout line; no
card and no ``--device`` raises.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from glia_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 256
MODES = ("fused_ms", "fused", "chunked")


def _glia_flow(side, mode, reps=1):
    """bench.py's calls (bench.py:60-200) with glia_tpu, unrounded."""
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from glia_tpu.data.synthetic import synthetic_em_slice
    from glia_tpu.graph.merge import apply_merge_order
    from glia_tpu.graph.merge_device import (edge_mean_arrays,
                                             exact_saliency_device,
                                             merge_batched_device,
                                             merge_batched_device_exact,
                                             order_to_keys,
                                             replay_exact_saliency,
                                             threshold_cut)
    from glia_tpu.graph.rag import build_rag
    from glia_tpu.metrics import eval_vi
    from glia_tpu.native import greedy_merge_native, watershed_native

    n_cells = (side // 14) ** 2
    data = synthetic_em_slice(shape=(side, side), n_cells=n_cells, seed=11,
                              blur=1.2, noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    rag = build_rag(seg, contour_only=False)
    E, R = rag.n_edges, rag.n_regions
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="mean")
    u, v, s, c = edge_mean_arrays(rag, data["pb"])

    def run_exact(u, v, s, c):
        if mode == "fused_ms":
            return merge_batched_device_exact(u, v, s, c, R, stats={})
        o, sb, n = merge_batched_device(u, v, s, c, R, stats={}, mode=mode)
        ex = exact_saliency_device(u, v, s, c, o, R)
        return o, jnp.where(jnp.isnan(ex), jnp.asarray(sb), -ex), n

    run_exact(u, v, s, c)
    u_d, v_d = jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32)
    s_d, c_d = jnp.asarray(s, jnp.float64), jnp.asarray(c, jnp.float64)
    for _ in range(reps):
        order_b, sal_b, n_m = run_exact(u_d, v_d, s_d, c_d)
    k = R - n_cells
    tau = -sal_h[k - 1]
    okeys = order_to_keys(order_b, n_m, rag)
    ex = -np.asarray(sal_b)[:n_m]
    ex_host = replay_exact_saliency(u, v, s, c, np.asarray(order_b)[:n_m])
    seg_b = apply_merge_order(seg, okeys[threshold_cut(okeys, ex, tau)])
    _, sal_stale, _ = merge_batched_device(u_d, v_d, s_d, c_d, R, mode=mode)
    mask_stale = threshold_cut(okeys, -np.asarray(sal_stale)[:n_m], tau)
    seg_stale = apply_merge_order(seg, okeys[mask_stale])
    seg_h = apply_merge_order(seg, order_h, threshold_index=k)
    return {"R": R, "E": E, "merges": int(n_m), "order_h": order_h,
            "k": k, "tau": float(tau), "ex": ex, "ex_host": ex_host,
            "vi_device": eval_vi(seg_b, data["truth"])[2],
            "vi_stale": eval_vi(seg_stale, data["truth"])[2],
            "vi_serial": eval_vi(seg_h, data["truth"])[2]}


@pytest.fixture(scope="module")
def section():
    return bench.setup(SIDE)


@pytest.mark.parametrize("mode", MODES)
def test_bench_matches_bench_py_flow(section, mode):
    got = bench.measure(section, mode, reps=1, device="cpu")
    want = _glia_flow(SIDE, mode)
    assert (got["R"], got["E"], got["merges"], got["k"]) == (
        want["R"], want["E"], want["merges"], want["k"])
    np.testing.assert_array_equal(section.order_h, want["order_h"])
    assert got["tau"] == want["tau"]
    for key in ("vi_device", "vi_stale", "vi_serial"):
        assert got[key] == want[key], (key, got[key], want[key])
    order, sal, n = got["outputs"]["last"]
    np.testing.assert_allclose(-sal[:n].numpy(), want["ex"], rtol=1e-12)
    ok = np.isfinite(want["ex_host"])
    assert got["replay_max_abs_gap"] <= 1e-12
    assert np.abs(want["ex"][ok] - want["ex_host"][ok]).max() <= 1e-12


def test_bench_result_is_bench_py_result(section):
    out = bench.measure(section, "fused_ms", reps=3, device="cpu")
    res = out["result"]
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    want = next(n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result"
                        for t in n.targets))
    assert list(res) == [k.value for k in want.keys]
    assert res["metric"] == "rag_merge_edges_per_s_per_chip"
    assert res["unit"] == "edges/s"
    assert len(out["reps_s"]) == 3
    assert out["median_s"] == float(np.median(out["reps_s"]))
    assert res["value"] == round((out["E"] + out["merges"])
                                 / out["median_s"], 1)
    assert res["vs_baseline"] == round(out["edges_per_s"]
                                       / out["host_edges_s"], 3)
    assert out["reps_identical"] and out["fallback"] is False
    assert out["launches"] == {"forest_votes": 0, "segment_sum": 0}
    # no graph off the card: every call ran the plan program eagerly
    assert out["plan_graph"] == [False] * 3 and out["capture_call_s"] is None


def _script(env, *args):
    return subprocess.run(
        [sys.executable, "-m", "glia_tpu_torch.bench", *args], cwd=ROOT,
        env={**os.environ, "GLIA_BENCH_SIDE": "128", "GLIA_BENCH_REPS": "2",
             **env}, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mode", ["", "chunked"])
def test_script_prints_one_json_line(mode):
    out = _script({"GLIA_BENCH_MODE": mode} if mode else {}, "--device",
                  "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    res = json.loads(lines[0])
    assert list(res) == ["metric", "value", "unit", "vs_baseline"]
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert "threshold-cut parity" in out.stderr
    # the one JSON diagnostic: the line follows from its numbers, and on
    # the CPU no kernel launched (the plain versions ran)
    counts = [json.loads(x[len("counts: "):])
              for x in out.stderr.splitlines() if x.startswith("counts: ")]
    assert len(counts) == 1, out.stderr
    c = counts[0]
    assert (c["side"], len(c["reps_s"])) == (128, 2)
    assert c["launches"] == {"forest_votes": 0, "segment_sum": 0}
    edges_s = (c["E"] + c["merges"]) / float(np.median(c["reps_s"]))
    assert res["value"] == round(edges_s, 1)
    assert res["vs_baseline"] == round(
        edges_s / ((c["E"] + c["host_merges"]) / c["host_s"]), 3)


def test_script_fails_loudly_on_a_bad_mode():
    out = _script({"GLIA_BENCH_MODE": "bogus"}, "--device", "cpu")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "bogus" in out.stderr


def test_bench_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(128, "fused_ms", 1)
