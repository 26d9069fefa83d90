"""Tracing and profiling: per-stage wall clock and throughput, device
traces (counterpart of glia_tpu.utils.profiling).

``StageTimer`` collects per-stage durations and item throughputs;
``trace`` records a torch.profiler trace of the CPU and, where there is
one, the CUDA card, written as a Chrome trace; ``block_and_time`` times a
function with the device synchronized (CUDA events on the card).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import List, Optional

import torch


class StageTimer:
    def __init__(self):
        self.records: List[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, n_items: Optional[int] = None,
              unit: str = "items"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
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
    trace.  Yields the profiler (``key_averages()`` for sums by kernel)."""
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
