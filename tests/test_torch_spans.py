"""The port's spans and counts (``glia_tpu_torch.utils.profiling``) and
where the program opens them, on the CPU.

The facility: spans nest and their seconds add into the root's record;
counts land in the open root and in ``totals``; ``records`` is bounded
and counts what it drops; under ``torch.profiler`` a span is a
``glia::<name>`` host event, and without one no record function is
entered.  The kernels' byte counts: a graph's tally carries them into
each replay.  The program: ``merge_batched_device_exact`` writes one
``merge.exact`` record a call (a plan-memo miss, then hits; the eager
rerun's span and supersteps only where the plan is one superstep short,
which raises the count once: plan.last_steps_raised) with its
``stats`` seconds taken from the spans, and
``hmt_segment`` / ``hmt_train`` fill their stage seconds from theirs.
Every test starts from empty records and plan memos.
"""

import sys
import threading
from collections import deque

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import glia_tpu_torch.graph.merge_device as tm
import glia_tpu_torch.pipeline as tp
from glia_tpu_torch.data.synthetic import synthetic_em_slice
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.models.forest import ForestModel, ForestTables
from glia_tpu_torch.native import watershed_native
from glia_tpu_torch.ops import cuda as kcuda
from glia_tpu_torch.utils import StageTimer, profiling
from glia_tpu_torch.utils.profiling import count, span


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Empty records, counts and plan memos; no plan store."""
    monkeypatch.setattr(profiling, "records",
                        deque(maxlen=profiling.MAX_RECORDS))
    monkeypatch.setattr(profiling, "totals", {})
    monkeypatch.setattr(profiling, "dropped", 0)
    for name in ("_PLAN_MEMO", "_EXACT_SAL_L"):
        monkeypatch.setattr(tm, name, {})
    monkeypatch.setattr(tm, "_PLAN_STORE_LOADED", [None])
    monkeypatch.setattr(tm, "plan_store_dir", lambda: None)


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------

def test_spans_nest_into_the_root_record():
    with span("root") as root:
        with span("a") as a1:
            with span("b") as b:
                pass
        with span("a") as a2:
            pass
    (rec,) = profiling.records
    assert rec.name == "root" and rec.t1 - rec.t0 == root.seconds
    assert set(rec.spans) == {"a", "b"}
    assert rec.spans["a"] == a1.seconds + a2.seconds
    assert rec.spans["b"] == b.seconds <= a1.seconds
    assert a1.seconds + a2.seconds <= root.seconds
    assert rec.counts == {}
    # a second root is a record of its own
    with span("other"):
        pass
    assert [r.name for r in profiling.records] == ["root", "other"]


def test_counts_land_in_the_root_and_totals():
    count("outside", 5)
    with span("root"):
        count("x")
        with span("inner"):
            count("x", 2)
            count("bytes", 1000)
        # a root's counts join the totals when it closes
        assert profiling.totals == {"outside": 5}
    with span("root"):
        count("x", 4)
    first, second = profiling.records
    assert first.counts == {"x": 3, "bytes": 1000}
    assert second.counts == {"x": 4}
    assert profiling.totals == {"outside": 5, "x": 7, "bytes": 1000}


def test_records_are_bounded_and_count_drops(monkeypatch):
    monkeypatch.setattr(profiling, "records", deque(maxlen=3))
    for i in range(5):
        with span(f"r{i}"):
            pass
    assert [r.name for r in profiling.records] == ["r2", "r3", "r4"]
    assert profiling.dropped == 2
    profiling.reset()
    assert not profiling.records and profiling.dropped == 0
    assert profiling.totals == {}


def test_a_span_that_raises_still_closes():
    with pytest.raises(ValueError):
        with span("root"):
            with span("inner"):
                raise ValueError("x")
    (rec,) = profiling.records
    assert rec.name == "root" and "inner" in rec.spans
    with span("next"):
        pass
    assert profiling.records[-1].name == "next"


def test_spans_on_the_profiler_timeline(monkeypatch):
    """While torch.profiler records, a span is a ``glia::`` host event of
    the operator kind (a user annotation would also be drawn on the
    device's timeline over the kernels inside it); with the profiler
    off, no record function is entered."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("merge.exact"):
            with span("merge.scalar_wait"):
                torch.ones(4).sum()
    glia = [e for e in prof.events() if e.name.startswith("glia::")]
    assert {e.name for e in glia} == {"glia::merge.exact",
                                      "glia::merge.scalar_wait"}
    assert not any(e.is_user_annotation for e in glia)

    def refuse(name):
        raise AssertionError(f"record function {name!r} with no profiler")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    with span("merge.exact"):
        count("n")
    assert profiling.records[-1].counts == {"n": 1}


def test_threads_keep_their_own_roots_and_share_totals():
    """Eight threads, each opening roots and counting under a short
    switch interval: every root is its thread's, no count is lost."""
    n_threads, n_roots = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_roots):
                with span(f"t{i}"):
                    with span("inner"):
                        count("c")
                    count(f"own{i}")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(profiling.records) == n_threads * n_roots
    for rec in profiling.records:
        i = rec.name[1:]
        assert rec.counts == {"c": 1, f"own{i}": 1}
        assert set(rec.spans) == {"inner"}
    assert profiling.totals["c"] == n_threads * n_roots


def test_stage_timer_times_through_span():
    timer = StageTimer()
    with timer.stage("watershed", n_items=10):
        pass
    (rec,) = profiling.records
    assert rec.name == "watershed"
    assert timer.records[0]["seconds"] == rec.t1 - rec.t0


# ---------------------------------------------------------------------------
# the kernels' bytes
# ---------------------------------------------------------------------------

def test_graph_launch_tally_carries_bytes(monkeypatch):
    """A captured launch adds its bytes to the tally; each replay adds
    them to ``bytes_moved`` and to the open root's ``segment_sum.bytes``;
    the launches count as before."""
    kcuda.reset_launches()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with kcuda.graph_launch_tally() as tally:
        kcuda._count_launch("segment_sum", 1000)
        kcuda._count_launch("segment_sum", 24)
    assert tally == {"forest_votes": 0, "segment_sum": 2}
    assert tally.nbytes == {"forest_votes": 0, "segment_sum": 1024}
    assert kcuda.bytes_moved["segment_sum"] == 0
    with span("merge.exact"):
        kcuda.count_graph_replay(tally)
        kcuda.count_graph_replay(tally)
    assert kcuda.launches == {"forest_votes": 0, "segment_sum": 4}
    assert kcuda.bytes_moved == {"forest_votes": 0, "segment_sum": 2048}
    assert profiling.records[-1].counts == {"segment_sum.bytes": 2048}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with span("eager"):
        kcuda._count_launch("segment_sum", 100)
    assert profiling.records[-1].counts == {"segment_sum.bytes": 100}
    assert kcuda.launches["segment_sum"] == 5
    kcuda.reset_launches()
    assert kcuda.bytes_moved == {"forest_votes": 0, "segment_sum": 0}


@pytest.mark.parametrize("B,F,S,w", [(597140, 2, 487498, 4), (10, 1, 3, 8),
                                     (40817, 42, 487497, 4)])
def test_segment_sum_bytes(B, F, S, w):
    """The ids and values once, and at most one output row a row."""
    assert kcuda.segment_sum_bytes(B, F, S, w) == 8 * B + B * F * w \
        + min(B, S) * F * w


@pytest.mark.parametrize("kept", [0, 7, 10])
def test_segment_sum_bytes_of_kept_rows(kept):
    """Rows whose ids fall outside [0, S) move only their ids."""
    assert kcuda.segment_sum_bytes(10, 2, 4, 4, kept=kept) == 8 * 10 \
        + kept * 2 * 4 + min(kept, 4) * 2 * 4
    assert kcuda.segment_sum_bytes(10, 2, 4, 4, kept=10) \
        == kcuda.segment_sum_bytes(10, 2, 4, 4)


def test_forest_bytes():
    """X once, 16 bytes a real inner node, 8 a real leaf, the output once:
    a two-tree forest of 2 + 1 inner nodes and 3 + 2 leaves."""
    feature = np.array([[0, 1, -1, -1, -1], [2, -1, -1, -1, -1]], np.int32)
    left = np.array([[1, 3, 0, 0, 0], [1, 0, 0, 0, 0]], np.int32)
    right = np.array([[2, 4, 0, 0, 0], [2, 0, 0, 0, 0]], np.int32)
    leaf = np.zeros((2, 5), np.int32)
    model = ForestModel.from_arrays(feature, np.zeros((2, 5), np.float32),
                                    left, right, leaf, 2, 2,
                                    np.array([0, 1]))
    tables = ForestTables.from_model(model, "cpu")
    assert tables.n_inner == 3 and int(tables.n_real.sum()) == 8
    B, D = 7, 3
    assert kcuda.forest_bytes(tables, B, D) == (4 * B * D + 16 * 3 + 8 * 5
                                                + 4 * B * 2)


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def section():
    """bench.py's recipe at 256x256: (u, v, s, c, R)."""
    side = 256
    data = synthetic_em_slice((side, side), n_cells=(side // 14) ** 2,
                              seed=11, blur=1.2, noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    rag = build_rag(seg, contour_only=False)
    return (*tm.edge_mean_arrays(rag, data["pb"]), rag.n_regions)


def _exact(section, st):
    u, v, s, c, R = section
    return tm.merge_batched_device_exact(u, v, s, c, R, stats=st,
                                         device="cpu")


def test_merge_exact_writes_one_record_a_call(section):
    """Discovery, then the one program twice, then the program with its
    last phase one superstep short (the plan of a map that needs one
    more: the plan is rerun eagerly and the count raised), then the
    program at the raised count (no eager rerun): one merge.exact record
    a call, stats seconds = span seconds."""
    st0, st1, st2 = {}, {}, {}
    _exact(section, st0)
    _exact(section, st1)
    want = _exact(section, st2)
    (entry,) = tm._PLAN_MEMO.values()
    entry.last_steps -= 1
    st3, st4 = {}, {}
    got = _exact(section, st3)
    again = _exact(section, st4)
    assert [r.name for r in profiling.records] == ["merge.exact"] * 5
    r0, r1, r2, r3, r4 = profiling.records

    assert r0.counts == {"plan.memo_miss": 1}
    assert st0["plan_replayed"] is False and "t_plan_program" not in st0
    assert st0["t_merge_loop"] == r0.spans["merge.merge_loop"]
    assert st0["t_exact_saliency"] == r0.spans["merge.exact_saliency"]
    assert r0.spans["merge.discovery"] >= st0["t_merge_loop"]

    for st, r in ((st1, r1), (st2, r2), (st4, r4)):
        assert r.counts == {"plan.memo_hit": 1}
        assert st["t_plan_program"] == r.t1 - r.t0
        assert st["eager_supersteps"] == 0
        assert {"merge.stage_inputs", "merge.scalar_wait"} <= set(r.spans)
        # eager on the CPU: no graph
        assert "merge.graph_launch" not in r.spans
        assert "merge.eager_tail" not in r.spans

    assert st3["eager_supersteps"] == st3["n_supersteps"] >= 1
    assert r3.counts == {"plan.memo_hit": 1,
                         "merge.eager_supersteps": st3["eager_supersteps"],
                         "plan.last_steps_raised": 1}
    assert r3.spans["merge.eager_tail"] > 0
    assert st3["t_plan_program"] == r3.t1 - r3.t0
    assert st3["n_supersteps"] == st2["n_supersteps"] == st4["n_supersteps"]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(again[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(again[1].numpy(), got[1].numpy())
    assert profiling.totals == {"plan.memo_miss": 1, "plan.memo_hit": 4,
                                "merge.eager_supersteps":
                                st3["eager_supersteps"],
                                "plan.last_steps_raised": 1}


@pytest.mark.parametrize("what", ["exact", "mean"])
def test_last_steps_raised_counts_once_a_raise(section, what):
    """plan.last_steps_raised counts each call that raises a memoized
    plan's last-phase count, once, and nothing else: not the discovery
    that records the first count, not a call at the recorded count, not
    a call below it."""
    u, v, s, c, R = section

    def call():
        if what == "exact":
            _exact(section, {})
        else:
            tm.merge_batched_device(u, v, s, c, R, mode="fused_ms",
                                    device="cpu")

    call()
    (entry,) = tm._PLAN_MEMO.values()
    K = entry.last_steps
    for lower, raised in ((1, 1), (0, 1), (2, 2), (-1, 2)):
        entry.last_steps = K - lower
        call()
        assert entry.last_steps == max(K, K - lower)
        assert profiling.totals.get("plan.last_steps_raised", 0) == raised
    if what == "exact":
        # the count lands in the raising call's record
        assert [r.counts.get("plan.last_steps_raised", 0)
                for r in profiling.records] == [0, 1, 0, 1, 0]


def test_merge_exact_fallback_counts(section):
    """A plan too tight for the RAG: the call counts the hit, the
    fallback and the rediscovery's miss, in one record."""
    u, v, s, c, R = section
    key = (len(u), R, tm._mean_stat_packed, ((2, "float64"),), 4,
           "float64", False)
    tm._PLAN_MEMO[key] = tm._Plan([(1, len(u), R), (None, 256, 128)], 3)
    tm._EXACT_SAL_L[(len(u), R - 1, R, "float64")] = 8
    st = {}
    _exact(section, st)
    (rec,) = profiling.records
    plan = {k: n for k, n in rec.counts.items() if k.startswith("plan.")}
    assert plan == {"plan.memo_hit": 1, "plan.fallback": 1,
                    "plan.memo_miss": 1}
    assert st["plan_replayed"] is False and "t_plan_program" not in st


@pytest.mark.parametrize("policy", ["mean", "median"])
def test_greedy_merge_device_stage_spans(policy):
    """The user surface's host-replay stages (saliency_engine="py" for the
    mean, the median's host replay) are spans."""
    side = 96
    data = synthetic_em_slice((side, side), n_cells=20, seed=4)
    seg = watershed_native(data["pb"], level=0.05)
    rag = build_rag(seg, contour_only=False)
    st = {}
    with span("root"):
        tm.greedy_merge_device(rag, data["pb"], policy=policy, stats=st,
                               saliency_engine="py", device="cpu")
    (rec,) = profiling.records
    assert st["t_merge_loop"] == rec.spans["merge.merge_loop"]
    assert st["t_exact_saliency"] == rec.spans["merge.exact_saliency"]


def test_span_cost_example_on_the_cpu():
    """The cost example replays a one-program call's record, empty."""
    from glia_tpu_torch.examples.span_cost import span_cost

    out = span_cost(side=128, calls=50, device="cpu")
    assert out["device"] == "cpu" and out["root"] == "merge.exact"
    assert {"merge.stage_inputs", "merge.scalar_wait"} <= set(out["spans"])
    assert out["counts"] == ["plan.memo_hit"]
    low, high = out["us_per_call_range"]
    assert 0 < low <= out["us_per_call_median"] <= high
    assert low <= out["us_per_call"] <= high
    assert 0 < out["us_per_call_profiled"]
    assert not profiling.records


# ---------------------------------------------------------------------------
# the section path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slices():
    return [synthetic_em_slice((96, 96), n_cells=20, seed=k) for k in (1, 4)]


HMT_STAGES = {"t_watershed": "hmt.watershed", "t_pre_merge": "hmt.pre_merge",
              "t_rag": "hmt.rag", "t_features": "hmt.features",
              "t_predict": "hmt.predict",
              "t_tree_resolve": "hmt.tree_resolve",
              "t_segmentation": "hmt.segmentation"}


@pytest.mark.parametrize("engine", ["host", "device"])
def test_hmt_train_and_segment_stages_are_spans(slices, engine):
    train, test = slices
    st_train = {}
    model = tp.hmt_train([train], classifier="rf", n_trees=4,
                         policy="mean", stats=st_train)
    names = [r.name for r in profiling.records]
    assert names == ["train.segment", "train.features", "train.labels",
                     "train.forest"]
    for r, key in zip(profiling.records, ("t_segment", "t_features",
                                          "t_labels", "t_forest")):
        assert st_train[key] == r.t1 - r.t0
    profiling.reset()
    st = {}
    tp.hmt_segment(test["pb"], test["intensity"], model, engine=engine,
                   device="cpu", stats=st)
    (rec,) = profiling.records
    assert rec.name == "hmt.segment"
    for key, name in HMT_STAGES.items():
        assert st[key] == rec.spans[name], key
    if engine == "host":
        assert st["t_merge_loop"] == rec.spans["hmt.merge_loop"]
    else:
        assert st["t_merge_loop"] == rec.spans["merge.merge_loop"]
        assert rec.counts == {"plan.memo_miss": 1}
