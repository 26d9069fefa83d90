"""End-to-end 512x512 HMT demo with a quality and timing record
(counterpart of the repository's examples/run_hmt_512.py).

Trains the HMT pipeline on synthetic EM slices at the BASELINE 2D-HMT
scale, segments a held-out slice and prints a JSON summary: quality
against the watershed baseline and per-stage timings (``StageTimer``).

    python -m glia_tpu_torch.examples.run_hmt_512 [--mode greedy|ccm]
        [--device cpu]
"""

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="greedy", choices=["greedy", "ccm"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--cells", type=int, default=900)
    ap.add_argument("--trees", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..data.synthetic import synthetic_em_slice
    from ..pipeline import evaluate, hmt_segment, hmt_train
    from ..utils.profiling import StageTimer

    timer = StageTimer()
    shape = (args.size, args.size)
    with timer.stage("data"):
        train = [synthetic_em_slice(shape, n_cells=args.cells, seed=s)
                 for s in (1, 2)]
        test = synthetic_em_slice(shape, n_cells=args.cells, seed=77)
    with timer.stage("train"):
        model = hmt_train(train, n_trees=args.trees, pre_merge_size=30,
                          watershed_level=0.01, device=args.device)
    with timer.stage("segment"):
        seg, aux = hmt_segment(test["pb"], test["intensity"], model,
                               watershed_level=0.01, pre_merge_size=30,
                               mode=args.mode, device=args.device)
    with timer.stage("evaluate"):
        base = evaluate(aux["seg0"], test["truth"])
        ours = evaluate(seg, test["truth"])
    timer.report()
    summary = {
        "mode": args.mode,
        "n_superpixels": int(len(np.unique(aux["seg0"]))),
        "n_final": int(len(np.unique(seg))),
        "watershed": {k: round(v, 4) for k, v in base.items()},
        "hmt": {k: round(v, 4) for k, v in ours.items()},
        "timings": json.loads(timer.json()),
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
