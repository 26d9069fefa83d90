"""Kernel B1 (``glia_tpu_torch/ops/cuda/forest_votes.cu``, the forest vote
walk) in the traced stretch as a share of its memory roofline, in
percent: the bytes its launches must move (the program's
``forest_votes.bytes`` counts of the stretch's ``bc.merge`` calls: the
samples once, each real node once, the votes once) over its device time
there at the H100's 3.35 TB/s."""

from benchmark.core.spans import window_records

LAYER = "kernel B1 (ops/cuda/forest_votes.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "merge_edges_per_s"
WORKLOADS = ["bench4096_bc.replay"]
HBM_BYTES_PER_S = 3.35e12


def read(ctx):
    recs, tr = window_records(ctx, "bc.merge"), ctx.trace
    if recs is None or tr is None:
        return None
    nbytes = sum(r.counts.get("forest_votes.bytes", 0)
                 for r in recs[:tr.n_calls])
    t = tr.device_seconds("forest_votes")
    if t <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / (t * HBM_BYTES_PER_S)
