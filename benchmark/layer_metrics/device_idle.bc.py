"""The device's idle share of the traced stretch of the classifier-in-the-
loop merge: 1 - the union of its operations' intervals over the
stretch's length; read where every window call is one ``bc.merge`` of the
program."""

from benchmark.core.spans import window_records

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096_bc.replay"]


def read(ctx):
    tr = ctx.trace
    if tr is None or window_records(ctx, "bc.merge") is None:
        return None
    return 1.0 - tr.busy_s / tr.window_s
