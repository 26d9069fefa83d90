"""The measured window and its arithmetic.

A closed loop with one caller: ``step()`` runs one call (a merge) and
returns when the host holds its outputs.  The window opens
before the first call and closes when the call under way at ``seconds``
completes, so every call in it is whole.  A rate is all the work of the
window over all its time; a tail is the tail of all its calls.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Call:
    t0: float           # host clock at the call's start (s)
    t1: float           # host clock once the host holds its outputs (s)
    work: float         # the call's units of work (edges)
    info: dict = field(default_factory=dict)

    @property
    def latency(self) -> float:
        return self.t1 - self.t0


@dataclass
class Window:
    t_open: float
    calls: List[Call]

    @property
    def seconds(self) -> float:
        """From the window's opening to the completion of its last call."""
        return self.calls[-1].t1 - self.t_open if self.calls else 0.0

    def rate(self) -> float:
        """All the window's work over all its time."""
        return sum(c.work for c in self.calls) / self.seconds

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile of the calls' latencies by nearest rank:
        the smallest latency with at least q % of the calls at or below
        it."""
        lat = sorted(c.latency for c in self.calls)
        k = max(1, math.ceil(q / 100.0 * len(lat)))
        return lat[k - 1]


def run_window(step: Callable[[], tuple], seconds: float,
               tracer=None, trace_seconds: float = 0.0) -> Window:
    """Calls ``step`` back to back until one completes at or after
    ``seconds``.  ``step()`` returns (work, info).  With a ``tracer``, its
    ``start()`` runs just before the first call and its ``stop()`` right
    after the first call that completes at or after ``trace_seconds``."""
    calls: List[Call] = []
    tracing = tracer is not None
    if tracing:
        tracer.start()
    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        work, info = step()
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, work, info))
        if tracing and t1 - t_open >= trace_seconds:
            tracer.stop(n_calls=len(calls))
            tracing = False
        if t1 - t_open >= seconds:
            break
    if tracing:
        tracer.stop(n_calls=len(calls))
    return Window(t_open, calls)


class Reservoir:
    """A seeded uniform sample of ``k`` of a window's calls, whose number
    is not known in advance.  ``draw()`` is asked once a call, in order:
    it gives the slot the call's outputs take (``put``), or None when the
    call is not kept, so only kept outputs need copying."""

    def __init__(self, rng, k: int):
        self.rng, self.k, self.n = rng, k, 0
        self.items: list = []

    def draw(self):
        n = self.n
        self.n += 1
        if n < self.k:
            self.items.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None

    def put(self, slot: int, item):
        self.items[slot] = item
