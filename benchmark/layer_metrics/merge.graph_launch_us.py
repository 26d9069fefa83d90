"""Host microseconds of one CUDA-graph launch of the plan program: the
program's `merge.graph_launch` span (`CUDAGraph.replay()`), the mean over
the window's calls that replayed a graph."""

LAYER = "graph.merge_device (CUDA-graph replay)"
UNIT = "us"
SOURCE = "program_span"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]


def window_records(ctx):
    """The program's `merge.exact` root span of each window call, in
    order (`glia_tpu_torch.utils.profiling.records`); None where the
    program keeps no such records or a call has not exactly one."""
    from glia_tpu_torch.utils import profiling

    recs = getattr(profiling, "records", None)
    calls = ctx.window.calls
    if recs is None or not calls:
        return None
    lo, hi = ctx.window.t_open, calls[-1].t1
    mine = [r for r in list(recs)
            if r.name == "merge.exact" and lo <= r.t0 <= hi]
    if len(mine) != len(calls) or any(
            not c.t0 <= r.t0 <= c.t1 for c, r in zip(calls, mine)):
        return None
    return mine


def read(ctx):
    recs = window_records(ctx)
    if recs is None:
        return None
    t = [r.spans["merge.graph_launch"] for r in recs
         if "merge.graph_launch" in r.spans]
    return sum(t) / len(t) * 1e6 if t else None
