"""The share of the window the host spends in the multi-phase merge's
eager continuation: the program's `merge.eager_tail` spans (a map that
needs more supersteps than the captured plan goes on eagerly after the
graph replay, one host read a superstep, and takes the exact saliencies
again; `merge.eager_supersteps` counts those supersteps), summed over the
window's calls, over the window's seconds."""

LAYER = "graph.merge_device (eager continuation)"
UNIT = "share"
SOURCE = "program_span"
MOVES = "merge_p95_ms"
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
    return sum(r.spans.get("merge.eager_tail", 0.0)
               for r in recs) / ctx.window.seconds
