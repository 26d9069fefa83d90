"""The classifier-in-the-loop merge on a staged state, its spans, its plain
reference (``benchmark/reference/bc.py``) and the check of the cell
``bench4096_bc.replay`` (``benchmark/drivers/bc_replay.py``), on the CPU at
a small size.  Imports no JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from glia_tpu_torch.features.config import FeatureConfig
from glia_tpu_torch.graph import merge_bc_device as mbd
from glia_tpu_torch.models.forest import ForestModel, make_label_scorer
from glia_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.control_bc import bc_control  # noqa: E402
from benchmark.core.registry import BENCH_DIR, Registry  # noqa: E402
from benchmark.drivers import bc_replay  # noqa: E402
from benchmark.inputs.sections import sub_seed  # noqa: E402
from benchmark.reference import bc  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 33 + 4242
CFG = dict(json.load(open(os.path.join(BENCH_DIR, "configs",
                                       "bench4096_bc.json"))),
           side=96, train_side=96, n_trees=15)


@pytest.fixture(scope="module")
def small():
    """A 96^2 section of the cell's recipe, its staged program state in
    float64, a 15-tree forest grown by the benchmark's trainer on another
    section, and the reference's leaf statistics."""
    forest = bc_replay.grow_forests(dict(CFG, forests=1),
                                    {"section_seed": 7}, CPU,
                                    lambda *a: None)[0]
    data, _, rag = bc_replay.section(CFG, 96, sub_seed(7, 1))
    cfg = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=16)
    model = ForestModel.from_arrays(
        forest.feature, forest.threshold, forest.left, forest.right,
        forest.leaf_class, len(forest.classes), forest.max_depth,
        forest.classes, forest.n_features)
    scorer = make_label_scorer(model, label=-1, device=CPU)
    lv = bc_replay.leaves(CFG, data, rag, CPU)
    return dict(data=data, rag=rag, cfg=cfg, model=model, scorer=scorer,
                forest=forest, lv=lv,
                walk=bc.ForestWalk(forest, -1, CPU))


def _call(s, **kw):
    st = {}
    order, probs = mbd.merge_order_bc_device(
        s["rag"], s["cfg"], s["scorer"], stats=st, device=CPU,
        dtype=torch.float64, **kw)
    return order, probs, st


def test_reference_gives_the_programs_rows_and_probabilities(small):
    order, probs, st = _call(small)
    rows, ref_probs, steps = bc.merge_order(small["lv"], small["walk"])
    assert len(order) > 20 and st["n_supersteps"] > 3
    assert np.array_equal(bc.dense_rows(small["lv"], order), rows)
    assert np.array_equal(probs, ref_probs)
    assert st["merges_per_superstep"] == steps
    got = bc.check_call(small["lv"], small["walk"], order, probs, steps)
    assert got == {"checked": len(order), "mismatched": 0, "explained": 0,
                   "prob_gap": 0.0}


def test_staged_state_serves_two_calls_and_is_left_unchanged(small):
    staged = mbd.stage_bc_state(small["rag"], small["cfg"], CPU,
                                torch.float64)
    before = {k: v.clone() for k, v in staged[0].items()}
    own = _call(small)
    for _ in range(2):
        order, probs, st = _call(small, state=staged)
        assert np.array_equal(order, own[0])
        assert np.array_equal(probs, own[1])
        assert st["merges_per_superstep"] == own[2]["merges_per_superstep"]
        assert st["t_build_state"] < own[2]["t_build_state"]
    for k, v in staged[0].items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_hmt_segment_rows_are_the_references(small):
    """hmt_segment's own merge (staged inside its call) gives the rows a
    call on a staged state gives and the reference's, on its
    over-segmentation."""
    from benchmark.reference.host.rag import build_rag as ref_rag
    from glia_tpu_torch.graph.rag import build_rag
    from glia_tpu_torch.pipeline import HmtModel, hmt_segment

    d = small["data"]
    model = HmtModel(forest=small["model"], kind="rf", feature_set="full")
    _, info = hmt_segment(d["pb"], d["intensity"], model, engine="device_bc",
                          device=CPU, dtype=torch.float64)
    seg0 = info["seg0"]
    assert len(info["order"]) > 5
    s = dict(small, rag=build_rag(seg0, contour_only=False))
    staged = mbd.stage_bc_state(s["rag"], s["cfg"], CPU, torch.float64)
    order, probs, _ = _call(s, state=staged)
    assert np.array_equal(info["order"], order)
    assert np.array_equal(info["probs"], probs)
    lv = bc_replay.leaves(CFG, d, ref_rag(seg0, contour_only=False), CPU)
    rows, ref_probs, _ = bc.merge_order(lv, small["walk"])
    assert np.array_equal(bc.dense_rows(lv, order), rows)
    assert np.array_equal(probs, ref_probs)


def test_one_bc_merge_record_a_call_with_its_counts(small):
    staged = mbd.stage_bc_state(small["rag"], small["cfg"], CPU,
                                torch.float64)
    profiling.reset()
    sts = [_call(small, state=staged)[2], _call(small)[2]]
    recs = [r for r in profiling.records if r.name == "bc.merge"]
    assert len(recs) == 2 == len(profiling.records)
    for r, st in zip(recs, sts):
        assert r.counts["bc.supersteps"] == st["n_supersteps"]
        assert r.counts["bc.scored"] == st["n_scored"]
        assert {"bc.features", "bc.score", "bc.commit", "bc.step_read",
                "bc.readback"} <= set(r.spans)
    assert "bc.stage" not in recs[0].spans and "bc.stage" in recs[1].spans
    assert profiling.totals["bc.supersteps"] == sum(
        s["n_supersteps"] for s in sts)


def _tiny(root):
    """``tinybc.replay``: the cell at 160^2, two forests of 15 trees grown
    on 128^2 sections, under ``root``."""
    for kind, name, data in (
            ("configs", "tinybc", dict(CFG, side=160, train_side=128,
                                       forests=2)),
            ("workloads", "tinybc.replay", dict(json.load(open(os.path.join(
                BENCH_DIR, "workloads", "bench4096_bc.replay.json"))),
                config="tinybc"))):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
        with open(os.path.join(root, kind, name + ".json"), "w") as f:
            json.dump(data, f)
    return Registry([str(root)])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny(tmp_path_factory.mktemp("tinybc"))


def test_cell_is_correct_end_to_end(tiny):
    out = run.run_cell("tinybc.replay", SEED, 0.5, 0, CPU, registry=tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"merge_edges_per_s", "setup_s"}
    assert set(out["checks"]) == {"rows_mismatched", "near_share",
                                  "prob_gap"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_forests_are_the_seeds_work_and_the_cycle_its_order(tiny):
    cell = tiny.cell("tinybc.replay")
    a = bc_replay.setup(cell, SEED, CPU, lambda *x: None)
    b = bc_replay.setup(cell, SEED + 1, CPU, lambda *x: None)
    for fa, fb in zip(a.forests, b.forests):
        assert np.array_equal(fa.threshold, fb.threshold)
    got = [a.step()[1]["forest"] for _ in range(4)]
    assert sorted(got[:2]) == [0, 1] and got[2:] == got[:2]


def _stale_superstep(real):
    """``superstep`` whose third superstep scores with the second's
    probabilities (stale: the edges have moved since)."""
    seen = []

    def broken(state, static, predict_fn):
        if len(seen) == 2:
            feats, valid = mbd.candidate_features(state, static)
            probs = seen[-1][:len(valid)].to(feats.dtype)
            seen.append(probs)
            return mbd._commit(state, static, probs, valid)
        out = real(state, static, predict_fn)
        seen.append(out[2])
        return out
    return broken


@pytest.mark.parametrize("fault", ["stale", "swapped", "bfloat16"])
def test_check_reads_not_correct_on_a_fault(tiny, monkeypatch, fault):
    real = mbd.merge_order_bc_device
    if fault == "stale":
        def merge(*a, **k):
            good = mbd.superstep
            mbd.superstep = _stale_superstep(good)
            try:
                return real(*a, **k)
            finally:
                mbd.superstep = good
    elif fault == "swapped":
        def merge(*a, **k):
            order, probs = real(*a, **k)
            order = order.copy()
            order[[0, len(order) // 2]] = order[[len(order) // 2, 0]]
            return order, probs
    else:
        def merge(rag, cfg, predict_fn, **k):
            return real(rag, cfg, lambda X: predict_fn(
                X.to(torch.bfloat16).to(X.dtype)), **k)
    monkeypatch.setattr(mbd, "merge_order_bc_device", merge)
    out = run.run_cell("tinybc.replay", SEED, 0.3, 0, CPU, registry=tiny)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_bfloat16_control_fails_a_limit(tiny):
    cell = tiny.cell("tinybc.replay")
    got = bc_control(cell, [SEED, SEED + 1], CPU, lambda *a: None)
    lim = cell["limits"]
    for _, nums in got:
        assert any(nums[k] > lim[k] for k in lim), nums


def test_reference_and_trainer_load_nothing_of_the_program():
    import subprocess

    code = ("import sys, json; sys.path.insert(0, '.'); "
            "import benchmark.reference.bc, benchmark.reference.host.forest; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmark" in names
    assert not names & {"glia_tpu_torch", "glia_tpu", "jax", "jaxlib"}
