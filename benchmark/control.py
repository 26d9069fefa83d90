"""The lower-precision control of the cell's correctness check.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place and
computed in bfloat16, the nearest precision below the configuration's
float32 (``reference/merge.py`` takes the dtype), on the cell's own
inputs at its own size: the merge order and its exact saliencies summed
in bfloat16, on each of the first two boundary maps of the seed's cycle.
For every seed it prints one JSON line with the numbers the cell
compares, read between the control and the float32 reference (the
widest over the maps), beside the cell's limits: each limit has to lie
below every reading of the control.  The benchmark's own runs do not run
it; a limit is set from these readings (the upper ones) and from the
program's readings over a dozen seeds or more (the lower ones).  Nothing
here imports the program.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def merge_control(cell, seed, low, n_maps=2):
    import torch

    from benchmark.drivers.merge_replay import (map_cycle, rows_mismatched,
                                                saliency_gap, section_inputs)
    from benchmark.reference.merge import batched_merge, exact_saliency

    cfg = cell["config_data"]
    R, (u, v, c), sums = section_inputs(cfg, cell["traffic"])
    dmax = int(cfg["dmax"])
    out = {"rows_mismatched": 0, "saliency_gap": 0.0}
    for m in map_cycle(seed, len(sums))[:n_maps]:
        s = sums[m]
        rows, _, _ = batched_merge(u, v, s, c, R, dmax=dmax,
                                   dtype=getattr(torch, cfg["dtype"]))
        stat = exact_saliency(u, v, s, c, rows, R)
        lrows, _, _ = batched_merge(u, v, s, c, R, dmax=dmax, dtype=low)
        lstat = exact_saliency(u, v, s, c, lrows, R, dtype=low)
        out["rows_mismatched"] = max(out["rows_mismatched"],
                                     rows_mismatched(lrows, rows))
        out["saliency_gap"] = max(out["saliency_gap"],
                                  saliency_gap(-lstat, stat))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.core.registry import Registry

    cell = Registry().cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        nums = merge_control(cell, seed, torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16",
                          "readings": nums, "limits": cell["limits"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
