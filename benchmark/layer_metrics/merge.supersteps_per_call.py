"""Supersteps of the multi-phase merge per call, the mean over the window
(the program's ``stats["n_supersteps"]``)."""

LAYER = "graph.merge_device (plan program)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]


def read(ctx):
    steps = [c.info["stats"]["n_supersteps"] for c in ctx.window.calls]
    steps = [s for s in steps if s is not None]
    return sum(steps) / len(steps) if steps else None
