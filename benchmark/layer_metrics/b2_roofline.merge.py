"""Kernel B2 (`glia_tpu_torch/ops/cuda/segment_sum.cu`) in the traced
stretch as a share of its memory roofline, in percent: the bytes its
launches must move (the program's `segment_sum.bytes` counts of the
stretch's calls, a CUDA graph's counted at each replay: ids, values and
output once each, so an upper bound on the rows the ids keep) over its
device time there at the H100's 3.35 TB/s.  B2 does one add a value, so
bytes bound it."""

LAYER = "kernel B2 (ops/cuda/segment_sum.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]
HBM_BYTES_PER_S = 3.35e12


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
    recs, tr = window_records(ctx), ctx.trace
    if recs is None or tr is None:
        return None
    nbytes = sum(r.counts.get("segment_sum.bytes", 0)
                 for r in recs[:tr.n_calls])
    t = tr.device_seconds("segment_sum")
    if t <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / (t * HBM_BYTES_PER_S)
