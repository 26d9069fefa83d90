"""Supersteps of the classifier-in-the-loop merge per call, the mean over
the window (the program's ``bc.supersteps`` count of each call's
``bc.merge`` record)."""

from benchmark.core.spans import window_records

LAYER = "graph.merge_bc_device (BC loop)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096_bc.replay"]


def read(ctx):
    recs = window_records(ctx, "bc.merge")
    if recs is None:
        return None
    return sum(r.counts.get("bc.supersteps", 0) for r in recs) / len(recs)
