"""Edge rows a superstep of the classifier-in-the-loop merge runs on, the
mean over the window's calls of each call's rows per superstep (the
program's ``bc.edge_rows`` count of a ``bc.merge`` record over its
``bc.supersteps``).  The staged state's edges where every superstep runs
on all of them; lower where the loop cuts its edge arrays to the live
edges.  None where the program keeps no such count."""

from benchmark.core.spans import window_records

LAYER = "graph.merge_bc_device (BC loop)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096_bc.replay"]


def read(ctx):
    recs = window_records(ctx, "bc.merge")
    if recs is None or any("bc.edge_rows" not in r.counts
                           or not r.counts.get("bc.supersteps")
                           for r in recs):
        return None
    return sum(r.counts["bc.edge_rows"] / r.counts["bc.supersteps"]
               for r in recs) / len(recs)
