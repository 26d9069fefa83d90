"""The traced stretch of a ``--trace 1`` run and its reduction.

``torch.profiler`` records the host's operations and the device's
(kernels, copies, sets) over a fixed stretch at the window's start.  From
it: the device's busy seconds as the union of the device intervals (two
kernels on concurrent streams count once), the traced stretch's length,
device time by operation name, and the idle gaps between busy intervals,
each labelled by the innermost host operation under way at its middle.
The program's launch counters (``glia_tpu_torch.ops.cuda.launches``,
CUDA-graph replays counted by their tally) are read at the stretch's two
ends.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    return sum(e - s for s, e in merged(intervals))


def idle_gaps(busy: List[Tuple[float, float]], span: Tuple[float, float]):
    """The gaps of ``span`` not covered by ``busy`` intervals."""
    gaps, t = [], span[0]
    for s, e in merged(busy):
        s, e = max(s, span[0]), min(e, span[1])
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if span[1] > t:
        gaps.append((t, span[1]))
    return gaps


def innermost(host: List[Tuple[float, float, str]], t: float) -> str:
    """The name of the shortest host operation under way at ``t``."""
    best, best_len = "no traced host operation", None
    for s, e, name in host:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


N_GAPS = 10


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: Dict[str, float]           # seconds by operation name
    gaps: List[Tuple[str, float]]          # the longest idle gaps:
    #                                        (host operation, seconds)
    launches: Dict[str, int]               # program launches in the stretch
    n_calls: int                           # calls completed in the stretch

    def device_seconds(self, pattern: str) -> float:
        return sum(v for k, v in self.device_ops.items() if pattern in k)

    def breakdown(self, n: int = N_GAPS) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """``start()`` / ``stop()`` around a stretch of calls; ``summary``
    afterwards (None before, or on a machine whose profiler saw no device
    operation)."""

    def __init__(self, launches: Optional[Dict[str, int]] = None):
        self._launches = launches
        self._prof = None
        self.summary: Optional[TraceSummary] = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._l0 = dict(self._launches or {})
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, n_calls: int):
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        launches = {k: v - self._l0.get(k, 0)
                    for k, v in (self._launches or {}).items()}
        dev, host = [], []
        ops: Dict[str, float] = {}
        for e in self._prof.events():
            s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == DeviceType.CUDA:
                dev.append((s, t))
                ops[e.name] = ops.get(e.name, 0.0) + (t - s)
            else:
                host.append((s, t, e.name))
        self._prof = None
        if not dev:
            return
        t_lo = min([h[0] for h in host] + [d[0] for d in dev])
        span = (t_lo, t_lo + window_s)
        # only the longest gaps are labelled: a stretch holds some 10^5
        # host operations
        longest = sorted(idle_gaps(dev, span), key=lambda g: g[0] - g[1])
        gaps = [(innermost(host, (a + b) / 2), b - a)
                for a, b in longest[:N_GAPS]]
        self.summary = TraceSummary(
            busy_s=union_seconds([(max(a, span[0]), min(b, span[1]))
                                  for a, b in dev if b > span[0]]),
            window_s=window_s, device_ops=ops, gaps=gaps,
            launches=launches, n_calls=n_calls)
