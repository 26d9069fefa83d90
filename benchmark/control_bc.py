"""The lower-precision control of the classifier-in-the-loop cell's check.

    python3 benchmark/control_bc.py --workload <cell> --seeds <n> [<n> ...]

The control is the program with its features rounded to bfloat16, the
nearest precision below the configuration's float32, before the forest
walks them: the cell's set-up, then for every seed one call under the
first forest of the seed's cycle with the rounded features, held to the
plain reference (``reference/bc.py``) as the cell holds its calls.  For
every seed it prints one JSON line with the numbers the cell compares
beside the cell's limits: at least one of them has to lie above its
limit.  The benchmark's own runs do not run it.  It runs on the card, as
the cell does (on the CPU with ``--device cpu``, for a small cell).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bfloat16_features(scorer):
    """``scorer`` walking the features rounded to bfloat16."""
    import torch

    def score(X):
        return scorer(X.to(torch.bfloat16).to(X.dtype))

    return score


def bc_control(cell, seeds, device, log, state=None):
    """[(seed, {number: reading})] of the bfloat16 control; ``state``: a
    set-up of the cell (``drivers/bc_replay.py``) to reuse."""
    from benchmark.drivers import bc_replay

    if state is None:
        state = bc_replay.setup(cell, seeds[0], device, log)
    lv = bc_replay.leaves(state.cfg, state.data, state.rag, device)
    out = []
    for seed in seeds:
        f = int(bc_replay.forest_cycle(seed, len(state.forests))[0])
        st = {}
        order, probs = state.merge(state.rag, None,
                                   bfloat16_features(state.scorers[f]),
                                   stats=st, state=state.staged)
        _, _, nums = bc_replay.check_calls(
            lv, state.forests,
            [(0, f, order, probs, st["merges_per_superstep"])],
            state.limits, device, log)
        out.append((seed, {k: v for k, v, _ in nums}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.core.registry import Registry

    cell = Registry().cell(args.workload)
    t = time.perf_counter()

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    for seed, nums in bc_control(cell, args.seeds, torch.device(args.device),
                                 log):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", "readings": nums,
                          "limits": cell["limits"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
