"""The per-layer metrics of the cell ``bench4096_bc.replay``
(``benchmark/layer_metrics/``: ``bc.supersteps_per_call``,
``bc.step_read_share``, ``device_idle.bc``, ``b1_roofline.bc``,
``b2_roofline.bc``, ``bc.rows_per_superstep``), each on a synthetic
context: a window of calls, one ``bc.merge`` record a call, a traced
stretch.  Each reads its value, and reads None unless every window call
has exactly one ``bc.merge`` record (records dropped, a record of another
name, or a program that keeps none)."""

import os
import sys
from collections import deque
from types import SimpleNamespace

import pytest

from glia_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core.registry import Registry  # noqa: E402
from benchmark.core.trace import TraceSummary  # noqa: E402
from benchmark.core.window import Call, Window  # noqa: E402
from benchmark.run import Context  # noqa: E402

CELL = "bench4096_bc.replay"
NAMES = ["bc.supersteps_per_call", "bc.step_read_share", "device_idle.bc",
         "b1_roofline.bc", "b2_roofline.bc", "bc.rows_per_superstep"]

# three calls of 3 s from t = 100 s, window open at 99.9 s; each call's
# record starts 1 ms into it
CALLS = [(100.0 + 3.0 * i, 100.0 + 3.0 * (i + 1)) for i in range(3)]
T_OPEN = 99.9
STEPS = [88, 88, 87]
EDGE_ROWS = [5_000_000, 4_800_000, 6_100_000]
READ = [0.2, 0.3, 0.25]
B1 = [3.3e10, 3.4e10, 3.3e10]
B2 = [1.2e11, 1.1e11, 1.2e11]
# each record: its call less 1 ms at either end
REC_S = sum(t1 - t0 - 2e-3 for t0, t1 in CALLS)
WANT = {"bc.supersteps_per_call": 263 / 3,
        "bc.step_read_share": 0.75 / REC_S,
        "device_idle.bc": 1 - 2.4 / 3.2,
        # the traced stretch: the first call, B1 busy 0.27 s, B2 0.5 s
        "b1_roofline.bc": 100 * 3.3e10 / (0.27 * 3.35e12),
        "b2_roofline.bc": 100 * 1.2e11 / (0.5 * 3.35e12),
        "bc.rows_per_superstep": (5_000_000 / 88 + 4_800_000 / 88
                                  + 6_100_000 / 87) / 3}


def Record(name, t0, t1, spans, counts):
    """A closed root span as the program keeps it."""
    return SimpleNamespace(name=name, t0=t0, t1=t1, seconds=t1 - t0,
                           spans=spans, counts=counts)


def _records(skip=None, other=None, rows=True):
    recs = deque(maxlen=profiling.MAX_RECORDS)
    # a set-up call and a staging before the window
    recs.append(Record("bc.stage", 90.0, 95.0, {}, {}))
    recs.append(Record("bc.merge", 96.0, 99.0, {}, {"bc.supersteps": 88}))
    for i, (t0, t1) in enumerate(CALLS):
        if i == skip:
            continue
        recs.append(Record(
            "merge.exact" if i == other else "bc.merge", t0 + 1e-3,
            t1 - 1e-3, {"bc.step_read": READ[i], "bc.features": 1.6},
            {"bc.supersteps": STEPS[i], "bc.scored": 3_800_000,
             "forest_votes.bytes": B1[i], "segment_sum.bytes": B2[i],
             **({"bc.edge_rows": EDGE_ROWS[i]} if rows else {})}))
    return recs


def _context():
    window = Window(T_OPEN, [Call(t0, t1, 833_577) for t0, t1 in CALLS])
    trace = TraceSummary(busy_s=2.4, window_s=3.2,
                         device_ops={"void forest_votes_kernel<true>": 0.27,
                                     "void segment_sum_sorted_kernel": 0.4,
                                     "void segment_sum_kernel": 0.1,
                                     "void at::native::gather": 1.2},
                         gaps=[], launches={"forest_votes": 88,
                                            "segment_sum": 616}, n_calls=1)
    return Context({"name": CELL}, window, trace, state=None)


def _metric(name):
    mods = dict(Registry().layer_metrics(CELL))
    assert name in mods
    return mods[name]


def test_registry_lists_the_bc_metrics_for_the_cell():
    names = [n for n, _ in Registry().layer_metrics(CELL)]
    assert sorted(names) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_bc_metric_reads_the_window(name, monkeypatch):
    monkeypatch.setattr(profiling, "records", _records())
    assert _metric(name).read(_context()) == pytest.approx(WANT[name],
                                                           rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_bc_metric_is_none_unless_each_call_has_one_record(name,
                                                            monkeypatch):
    mod = _metric(name)
    monkeypatch.setattr(profiling, "records", _records(skip=1))
    assert mod.read(_context()) is None
    monkeypatch.setattr(profiling, "records", _records(other=2))
    assert mod.read(_context()) is None
    # a program that keeps no records
    monkeypatch.delattr(profiling, "records")
    assert mod.read(_context()) is None


@pytest.mark.parametrize("name", ["device_idle.bc", "b1_roofline.bc",
                                  "b2_roofline.bc"])
def test_traced_metric_is_none_without_a_trace(name, monkeypatch):
    monkeypatch.setattr(profiling, "records", _records())
    ctx = _context()
    ctx.trace = None
    assert _metric(name).read(ctx) is None


def test_rows_per_superstep_is_none_without_the_count(monkeypatch):
    """A program that does not count its edge rows (one that runs every
    superstep on the staged edges) reads nothing."""
    monkeypatch.setattr(profiling, "records", _records(rows=False))
    assert _metric("bc.rows_per_superstep").read(_context()) is None
