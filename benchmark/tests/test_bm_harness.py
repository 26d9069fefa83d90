"""The harness on the CPU: finding parts by name, the window's arithmetic,
the trace's reduction, the last line, the boundary maps, and the driver
end to end at a tiny size, held against the plain reference."""

import json
import os
import re

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.core.registry import BENCH_DIR, Registry
from benchmark.core.trace import idle_gaps, innermost, union_seconds
from benchmark.core.window import Call, Reservoir, Window, run_window

from bm_helpers import tiny_cells

CPU = torch.device("cpu")
SEED = 2 ** 33 + 12345


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Registry([tiny_cells(tmp_path_factory.mktemp("tiny"))])


def test_rate_over_the_window_ends_with_the_call_under_way():
    w = Window(10.0, [Call(10.0, 10.4, 100), Call(10.4, 10.9, 300),
                      Call(10.9, 11.6, 200)])
    assert w.seconds == pytest.approx(1.6)
    assert w.rate() == pytest.approx(600 / 1.6)


def test_window_closes_after_the_call_under_way():
    import time

    def step():
        time.sleep(0.03)
        return 1, {}

    w = run_window(step, 0.2)
    assert w.calls[-1].t1 - w.t_open >= 0.2
    assert all(c.t1 - w.t_open < 0.2 for c in w.calls[:-1])
    assert w.rate() == pytest.approx(len(w.calls) / w.seconds)


def test_p95_is_nearest_rank():
    lat = [float(i) for i in range(1, 101)]          # 1 .. 100
    w = Window(0.0, [Call(0.0, x, 1) for x in lat])
    assert w.percentile(95) == 95.0
    w = Window(0.0, [Call(0.0, x, 1) for x in (5.0, 1.0, 3.0)])
    assert w.percentile(95) == 5.0
    assert w.percentile(50) == 3.0


def test_union_of_intervals_counts_overlaps_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4), (4.0, 4.5)]
    assert union_seconds(iv) == pytest.approx(3.0)
    gaps = idle_gaps(iv, (0.0, 5.0))
    assert gaps == [(1.5, 2.0), (3.0, 4.0), (4.5, 5.0)]
    idle = 1 - union_seconds(iv) / 5.0
    assert idle == pytest.approx(sum(b - a for a, b in gaps) / 5.0)


def test_idle_gap_takes_the_innermost_host_operation():
    host = [(0.0, 10.0, "call"), (1.0, 3.0, "readback"),
            (1.5, 2.0, "cudaMemcpyAsync")]
    assert innermost(host, 1.7) == "cudaMemcpyAsync"
    assert innermost(host, 2.5) == "readback"
    assert innermost(host, 11.0) == "no traced host operation"


def test_reservoir_is_uniform_and_keeps_k():
    import numpy as np

    r = Reservoir(np.random.default_rng(0), 3)
    kept = np.zeros(60)
    for trial in range(400):
        r = Reservoir(np.random.default_rng(trial), 3)
        for i in range(60):
            slot = r.draw()
            if slot is not None:
                r.put(slot, i)
        assert len(r.items) == 3 and len(set(r.items)) == 3
        kept[r.items] += 1
    # each call is kept with chance 3 / 60
    assert abs(kept[:30].sum() - kept[30:].sum()) < 0.2 * kept.sum()


def _check_line(out, trace):
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] >= 0
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in out["device"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_driver_end_to_end_is_correct(tiny):
    out = run.run_cell("tiny.replay", SEED, 0.5, 0, CPU, registry=tiny)
    _check_line(out, 0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"merge_edges_per_s", "merge_p95_ms",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_window_takes_every_map_in_a_seeded_cycle(tiny):
    from benchmark.drivers import merge_replay

    cell = tiny.cell("tiny.replay")
    state = merge_replay.setup(cell, SEED, CPU, lambda *a: None)
    maps = [state.step()[1]["map"] for _ in range(8)]
    assert sorted(maps[:4]) == [0, 1, 2, 3] and maps[4:] == maps[:4]
    again = merge_replay.setup(cell, SEED, CPU, lambda *a: None)
    assert [again.step()[1]["map"] for _ in range(4)] == maps[:4]
    assert np.array_equal(again.sums, state.sums)
    # another seed: the same maps (the same work), in another order
    other = merge_replay.setup(cell, SEED + 1, CPU, lambda *a: None)
    assert np.array_equal(other.sums, state.sums)
    assert list(merge_replay.map_cycle(SEED + 1, 16)) != list(
        merge_replay.map_cycle(SEED, 16))


def test_boundary_maps_keep_the_edges_and_change_the_sums():
    from benchmark.inputs.sections import (bench_section, boundary_sums,
                                           edge_mean_arrays, membranes)

    data, _, rag, (u, v, s, c) = bench_section(192, 5)
    sums = boundary_sums(data, rag, 5, 3)
    assert sums.shape == (3, rag.n_edges)
    assert not any(np.array_equal(sums[k], s) for k in range(3))
    assert not np.array_equal(sums[0], sums[1])
    # each sum reads its own edge's boundary pixels: with no noise, the
    # sums of the membrane map itself
    clean = np.clip(membranes(data["truth"], 1.2), 0, 1).astype(np.float32)
    _, _, s0, c0 = edge_mean_arrays(rag, clean)
    assert np.array_equal(boundary_sums(data, rag, 5, 1, noise=0.0)[0], s0)
    assert np.array_equal(c0, c)
    # the maps' means stay the section's: the same membranes, fresh noise
    assert abs(sums.sum(1) / s.sum() - 1).max() < 0.05


def test_added_files_make_a_cell_a_config_and_a_metric(tmp_path):
    """A later change adds a cell, its configuration and a per-layer
    metric as new files only, and the harness runs that cell."""
    root = tiny_cells(tmp_path)
    with open(os.path.join(root, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["side"] = 192
    with open(os.path.join(root, "configs", "added.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", "tiny.replay.json")) as f:
        cell = json.load(f)
    cell["config"] = "added"
    with open(os.path.join(root, "workloads", "added.replay.json"), "w") as f:
        json.dump(cell, f)
    os.makedirs(os.path.join(root, "layer_metrics"))
    with open(os.path.join(root, "layer_metrics", "added.calls.py"),
              "w") as f:
        f.write('LAYER = "harness"\nUNIT = "count"\n'
                'SOURCE = "program_counter"\nMOVES = "merge_edges_per_s"\n'
                'WORKLOADS = ["added.replay"]\n\n\n'
                'def read(ctx):\n    return len(ctx.window.calls)\n')
    reg = Registry([root])
    assert reg.cell("added.replay")["config_data"]["side"] == 192
    names = [n for n, _ in reg.layer_metrics("added.replay")]
    assert names == ["added.calls"]
    out = run.run_cell("added.replay", SEED, 0.3, 1, CPU, registry=reg)
    _check_line(out, 1)
    assert out["correct"]
    assert out["metrics"]["added.calls"]["value"] == out["attempted"]


def test_a_metric_file_must_list_its_cells(tmp_path):
    os.makedirs(tmp_path / "layer_metrics")
    (tmp_path / "layer_metrics" / "loose.py").write_text(
        'LAYER = "device"\nUNIT = "share"\nSOURCE = "device_trace"\n'
        'MOVES = "merge_edges_per_s"\n\n\ndef read(ctx):\n'
        '    return 1.0\n')
    with pytest.raises(ValueError, match="WORKLOADS"):
        Registry([str(tmp_path)]).layer_metrics("bench4096.replay")


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "bench4096.replay", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "glia_tpu.graph", object())
    assert run.forbidden_modules() == ["glia_tpu"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_matches_the_files():
    """Every cell, configuration and metric that BENCHMARK.json names has
    its file, with the same unit, source, layer, ``moves`` and cells."""
    with open(os.path.join(os.path.dirname(BENCH_DIR),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    reg = Registry()
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells and set(cells) == set(reg.names("workloads", ".json"))
    configs = {c["name"]: c for c in bench["configs"]}
    assert set(configs) == {reg.cell(w)["config"] for w in cells}
    for c in configs.values():
        assert NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert reg.json("configs", c["name"])["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name, w in cells.items():
        assert NAME.match(name)
        cell = reg.cell(name)
        assert (w["config"], w["chips"], w["traffic"], w["why"]) == (
            cell["config"], cell["chips"], cell["driver"], cell["why"])
        for m in cell["end_to_end"]:
            assert name in e2e[m]["workloads"]
            assert reg.module("end_to_end", m).UNIT == e2e[m]["unit"]
    assert e2e["setup_s"]["unit"] == "s" and "workloads" not in e2e[
        "setup_s"]
    for m in e2e.values():
        assert UNIT.match(m["unit"]) and set(m.get("workloads", cells)) <= \
            set(cells)
    layer = {m["name"]: m for m in bench["per_layer"]}
    expect = {n for n in reg.names("layer_metrics", ".py")
              if set(reg.module("layer_metrics", n).WORKLOADS) & set(cells)}
    assert set(layer) == expect
    for name, m in layer.items():
        mod = reg.module("layer_metrics", name)
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert m["workloads"] == [w for w in mod.WORKLOADS if w in cells]
        for w in m["workloads"]:
            assert m["moves"] in reg.cell(w)["end_to_end"]
