"""The device's idle share of the traced stretch: 1 - the union of its
operations' intervals over the stretch's length."""

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]


def read(ctx):
    tr = ctx.trace
    return None if tr is None else 1.0 - tr.busy_s / tr.window_s
