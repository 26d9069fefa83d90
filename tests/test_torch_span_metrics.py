"""The benchmark's per-layer metrics that read the program's spans and
counts (``benchmark/layer_metrics/``: ``merge.eager_tail_share``,
``merge.graph_launch_us``, ``merge.device_wait_share``,
``b2_roofline.merge``), each on a synthetic context: a window of calls,
one ``merge.exact`` record a call, a traced stretch.  Each reads its
value, and reads None when a window call has no record (records dropped,
or a program that keeps none)."""

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

CELL = "bench4096.replay"
NAMES = ["merge.eager_tail_share", "merge.graph_launch_us",
         "merge.device_wait_share", "b2_roofline.merge"]

# four calls of 10 ms from t = 100 s, window open at 99.99 s; each call's
# record starts 1 ms into it; the second call goes on eagerly
CALLS = [(100.0 + 0.01 * i, 100.0 + 0.01 * (i + 1)) for i in range(4)]
T_OPEN = 99.99
SPANS = [{"merge.graph_launch": 400e-6, "merge.scalar_wait": 5e-3},
         {"merge.graph_launch": 600e-6, "merge.scalar_wait": 4e-3,
          "merge.eager_tail": 3e-3},
         {"merge.graph_launch": 500e-6, "merge.scalar_wait": 5e-3},
         {"merge.stage_inputs": 1e-4, "merge.scalar_wait": 6e-3}]
BYTES = [40e6, 45e6, 40e6, 40e6]
WINDOW_S = CALLS[-1][1] - T_OPEN
WANT = {"merge.eager_tail_share": 3e-3 / WINDOW_S,
        "merge.graph_launch_us": 500.0,
        "merge.device_wait_share": 20e-3 / WINDOW_S,
        # the traced stretch: the first two calls, B2 busy 0.5 ms there
        "b2_roofline.merge": 100 * 85e6 / (0.5e-3 * 3.35e12)}


def Record(name, t0, t1, spans, counts):
    """A closed root span as the program keeps it."""
    return SimpleNamespace(name=name, t0=t0, t1=t1, seconds=t1 - t0,
                           spans=spans, counts=counts)


def _records(skip=None):
    recs = deque(maxlen=profiling.MAX_RECORDS)
    # a set-up call before the window, and a record of another name
    recs.append(Record("merge.exact", 99.0, 99.01, {}, {}))
    recs.append(Record("hmt.segment", 100.0005, 100.0007, {}, {}))
    for i, ((t0, t1), sp) in enumerate(zip(CALLS, SPANS)):
        if i != skip:
            recs.append(Record("merge.exact", t0 + 1e-3, t1 - 1e-4, sp,
                               {"plan.memo_hit": 1,
                                "segment_sum.bytes": BYTES[i]}))
    return recs


def _context():
    window = Window(T_OPEN, [Call(t0, t1, 840_000) for t0, t1 in CALLS])
    trace = TraceSummary(busy_s=0.015, window_s=0.02,
                         device_ops={"void segment_sum_sorted_kernel": 4e-4,
                                     "void segment_sum_kernel": 1e-4,
                                     "void at::native::sort": 5e-3},
                         gaps=[], launches={"segment_sum": 22}, n_calls=2)
    return Context({"name": CELL}, window, trace, state=None)


def _metric(name):
    mods = dict(Registry().layer_metrics(CELL))
    assert name in mods
    return mods[name]


def test_registry_lists_the_span_metrics_for_the_cell():
    names = [n for n, _ in Registry().layer_metrics(CELL)]
    assert set(NAMES) <= set(names)


@pytest.mark.parametrize("name", NAMES)
def test_span_metric_reads_the_window(name, monkeypatch):
    mod = _metric(name)
    monkeypatch.setattr(profiling, "records", _records())
    assert mod.read(_context()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_span_metric_is_none_when_a_call_has_no_record(name, monkeypatch):
    mod = _metric(name)
    monkeypatch.setattr(profiling, "records", _records(skip=2))
    assert mod.read(_context()) is None
    # a program that keeps no records (the parent of the spans)
    monkeypatch.delattr(profiling, "records")
    assert mod.read(_context()) is None


def test_roofline_is_none_without_a_trace(monkeypatch):
    monkeypatch.setattr(profiling, "records", _records())
    ctx = _context()
    ctx.trace = None
    assert _metric("b2_roofline.merge").read(ctx) is None


def test_launch_us_is_none_without_a_replay(monkeypatch):
    recs = deque(Record(r.name, r.t0, r.t1, {
        k: v for k, v in r.spans.items() if k != "merge.graph_launch"},
        r.counts) for r in _records())
    monkeypatch.setattr(profiling, "records", recs)
    assert _metric("merge.graph_launch_us").read(_context()) is None
