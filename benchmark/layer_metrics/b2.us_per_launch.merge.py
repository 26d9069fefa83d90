"""Kernel B2 (``glia_tpu_torch/ops/cuda/segment_sum.cu``): its device time
in the traced stretch over its launches there (the program's
``ops.cuda.launches``, a CUDA graph's launches counted at each replay), in
microseconds."""

LAYER = "kernel B2 (ops/cuda/segment_sum.cu)"
UNIT = "us"
SOURCE = "device_trace"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096.replay"]


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.launches.get("segment_sum"):
        return None
    t = tr.device_seconds("segment_sum")
    return t / tr.launches["segment_sum"] * 1e6 if t > 0 else None
