"""Host cost of the spans and counts (``utils.profiling``) of one
``merge_batched_device_exact`` call.

    python -m glia_tpu_torch.examples.span_cost [side] [--calls N]
        [--device cpu]

Merges bench.py's section at ``side``^2 (default 1024) until a call runs
the memoized plan as one program without capturing it (on the card a
CUDA-graph replay), and takes that call's record: its root, the spans
inside it and its counts.  Then it opens and closes the same spans,
empty, and makes the same counts, ``N`` times (default 20,000, in 20
runs) with torch.profiler off (what every call pays, the garbage
collector on as in a run) and a tenth as often while torch.profiler
records the CPU (what the ``glia::`` events add then).  Prints one JSON
line: the device, the record's names, and microseconds a call each way:
the mean over all the runs (the collector's pauses in it), the median
run, and the range of the runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def _time_like(rec, n: int, repeats: int) -> list:
    """Microseconds a call of ``n`` calls that open and close ``rec``'s
    spans, empty, and make its counts, in each of ``repeats`` runs."""
    from ..utils.profiling import count, span

    names = list(rec.spans)
    counts = list(rec.counts.items())
    runs = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(n):
            with span(rec.name):
                for name in names:
                    with span(name):
                        pass
                for key, k in counts:
                    count(key, k)
        runs.append((time.perf_counter() - t) / n * 1e6)
    return runs


def span_cost(side: int = 1024, calls: int = 20000, device=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..bench import bench_section
    from ..device import resolve_device
    from ..graph import merge_device as md
    from ..utils import profiling

    dev = resolve_device(device)
    data, _, rag = bench_section(side, (side // 14) ** 2)
    u, v, s, c = md.edge_mean_arrays(rag, data["pb"])
    for _ in range(5):
        st = {}
        md.merge_batched_device_exact(u, v, s, c, rag.n_regions,
                                      dtype=torch.float32, stats=st,
                                      device=dev)
        rec = profiling.records[-1]
        if (st["plan_replayed"] and st["plan_graph"] == (dev.type == "cuda")
                and "plan.graph_capture" not in rec.counts):
            break
    else:
        raise RuntimeError("no call ran the memoized plan as one program")
    off = _time_like(rec, max(calls // 20, 1), 20)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _time_like(rec, max(calls // 200, 1), 20)
    profiling.reset()
    return {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
            "side": side, "root": rec.name, "spans": sorted(rec.spans),
            "counts": sorted(rec.counts), "calls": calls,
            "us_per_call": statistics.mean(off),
            "us_per_call_median": statistics.median(off),
            "us_per_call_range": [min(off), max(off)],
            "us_per_call_profiled": statistics.mean(on),
            "us_per_call_profiled_median": statistics.median(on)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(span_cost(args.side, args.calls, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
