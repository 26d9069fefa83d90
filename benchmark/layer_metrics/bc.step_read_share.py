"""The share of the classifier-in-the-loop merge's own time that the host
spends blocked on the card: the program's ``bc.step_read`` spans (the one
host read a superstep, of its merge count and the candidates left, which
waits for the superstep's kernels) over the seconds of the ``bc.merge``
root spans they sit in, summed over the window's calls.  The calls' own
seconds, not the window's: in a traced run the profiler's stop falls
between two calls and inside the window.  High: the card sets the pace;
low: the host's launches do."""

from benchmark.core.spans import window_records

LAYER = "graph.merge_bc_device (BC loop)"
UNIT = "share"
SOURCE = "program_span"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096_bc.replay"]


def read(ctx):
    recs = window_records(ctx, "bc.merge")
    if recs is None:
        return None
    return (sum(r.spans.get("bc.step_read", 0.0) for r in recs)
            / sum(r.seconds for r in recs))
