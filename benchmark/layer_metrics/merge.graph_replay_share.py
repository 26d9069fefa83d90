"""The share of the window's calls that replayed the plan's CUDA graph
(the program's ``stats["plan_graph"]``)."""

LAYER = "graph.merge_device (CUDA-graph replay)"
UNIT = "share"
SOURCE = "program_counter"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]


def read(ctx):
    calls = ctx.window.calls
    return sum(bool(c.info["stats"]["plan_graph"]) for c in calls) / len(calls)
