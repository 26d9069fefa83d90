"""Tracing and profiling: spans and counts inside the program, per-stage
wall clock and throughput, device traces (counterpart of
glia_tpu.utils.profiling, with the spans added).

``span(name)`` times a block on the host clock (``time.perf_counter``)
and ``count(name, n)`` adds to a count.  A span opened while no other is
open in its thread is a root, and a closed root is a record in
``records``: its name, start and end, the seconds of every span opened
inside it (summed by name) and the counts made inside it.  ``totals``
holds every count over the process (a root's once it closes).
``records`` keeps the last ``MAX_RECORDS`` roots; ``dropped`` counts the
ones pushed out.  While ``torch.profiler`` records, each span is also a
``glia::<name>`` host event on the profiler's timeline, above the
kernels it launches (an operator event, not a user annotation, so that
the device's timeline holds kernels and copies alone); otherwise a span
costs two clock reads and a few dict updates, and nothing is switched on
or off.  The device work a span launches is asynchronous: a span
measures the host, up to the first read that waits for the device.

After a run, an operator reads::

    from glia_tpu_torch.utils import profiling
    r = profiling.records[-1]  # r.name "merge.exact", r.t0, r.t1,
                               # r.spans {"merge.graph_launch": s, ...},
                               # r.counts {"plan.memo_hit": 1, ...}
    profiling.totals           # {"plan.memo_miss": 1, "plan.memo_hit": 41,
                               #  "segment_sum.bytes": ..., ...}
    profiling.dropped          # roots pushed out of ``records``

and ``with profiling.trace(logdir): ...`` writes one Chrome trace with
the ``glia::`` spans above the kernels.  The plan-memo counts say how
often the multi-phase merge found its plan: a run over many sections of
one shape shows one ``plan.memo_miss`` and then hits; a stack whose
sections differ in their edge or region count shows a miss (a discovery,
one host read a superstep) for every section, and ``plan.graph_capture``
once per captured plan.

``StageTimer`` collects per-stage durations and item throughputs through
``span``; ``trace`` records a torch.profiler trace of the CPU and, where
there is one, the CUDA card, written as a Chrome trace;
``block_and_time`` times a function with the device synchronized (CUDA
events on the card).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

# the root spans ``records`` keeps (a 50 s window of 12 ms calls is about
# 4,300)
MAX_RECORDS = 65536

_now = time.perf_counter
_profiler_enabled = torch.autograd._profiler_enabled
# a record function of the profiler's operator kind: a user-scope
# ``record_function`` would also draw a GPU-side annotation over every
# kernel launched inside it, which a trace reader takes for device time
_record_function = torch._C._profiler._RecordFunctionFast


class _Open(threading.local):
    root = None      # the thread's open root span


_tls = _Open()
_lock = threading.Lock()


class span:
    """``with span(name) as sp:`` times the block into ``sp.seconds`` and
    into the open root span (see the module docstring).  A closed root is
    a record: ``name``, ``t0`` and ``t1`` (host clock), ``seconds``,
    ``spans`` (the seconds of the spans opened inside it, summed by name)
    and ``counts``."""

    __slots__ = ("name", "t0", "t1", "seconds", "spans", "counts", "_root",
                 "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._root = root = _tls.root
        if root is None:
            _tls.root = self
            self.spans, self.counts = {}, {}
        if _profiler_enabled():
            self._rf = _record_function("glia::" + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.t0 = _now()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.t1 = t1 = _now()
        self.seconds = dt = t1 - self.t0
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        root = self._root
        if root is None:
            _tls.root = None
            _keep(self)
        else:
            inner = root.spans
            inner[self.name] = inner.get(self.name, 0.0) + dt
        return False


records: Deque[span] = deque(maxlen=MAX_RECORDS)
totals: Dict[str, float] = {}
dropped = 0


def count(name: str, n=1):
    """Add ``n`` to the open root span's count ``name``, which joins
    ``totals`` when the root closes; with no span open, to ``totals``."""
    root = _tls.root
    if root is not None:
        c = root.counts
        c[name] = c.get(name, 0) + n
    else:
        with _lock:
            totals[name] = totals.get(name, 0) + n


def _keep(root: span):
    global dropped
    with _lock:
        if len(records) == records.maxlen:
            dropped += 1
        records.append(root)
        for name, n in root.counts.items():
            totals[name] = totals.get(name, 0) + n


def reset():
    """Forget every record, count and drop."""
    global dropped
    with _lock:
        records.clear()
        totals.clear()
        dropped = 0


class StageTimer:
    def __init__(self):
        self.records: List[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, n_items: Optional[int] = None,
              unit: str = "items"):
        sp = span(name)
        try:
            with sp:
                yield
        finally:
            dt = sp.seconds
            rec = {"stage": name, "seconds": dt}
            if n_items is not None:
                rec[f"{unit}_per_s"] = n_items / dt if dt > 0 else 0.0
                rec["n"] = n_items
            self.records.append(rec)

    def report(self, file=sys.stderr):
        for r in self.records:
            extra = "".join(
                f" {k}={v:,.0f}" for k, v in r.items()
                if k not in ("stage", "seconds"))
            print(f"[timer] {r['stage']}: {r['seconds']*1e3:.1f}ms{extra}",
                  file=file)

    def json(self) -> str:
        return json.dumps(self.records)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU activities, and CUDA
    when a card is available) and write ``logdir/trace.json``, a Chrome
    trace: the spans opened in the block as ``glia::<name>`` host events
    above the kernels.  Yields the profiler (``key_averages()`` for sums
    by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_cuda_device(out):
    """The device of the first CUDA tensor in ``out`` (nested tuples,
    lists and dicts), or None."""
    if torch.is_tensor(out):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for x in items:
        dev = _first_cuda_device(x)
        if dev is not None:
            return dev
    return None


def block_and_time(fn, *args, n_iter=10, warmup=1):
    """Seconds per call of ``fn(*args)`` over ``n_iter`` calls after
    ``warmup`` calls, and the last output.  When the warm-up output holds
    a CUDA tensor, the calls are timed with CUDA events on its device
    after a synchronize (the card's time, not the enqueueing); otherwise
    with the host clock, synchronizing the card at the end if the output
    is on it."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _first_cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_iter):
                out = fn(*args)
            end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n_iter, out
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    dev = _first_cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n_iter, out
