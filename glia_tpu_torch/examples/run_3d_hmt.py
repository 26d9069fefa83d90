"""BASELINE config #2 at stated scale: 3D HMT on a 100 x 512 x 512 EM
volume (counterpart of the repository's tools/run_3d_hmt.py, stage for
stage):

  synthetic EM volume -> 3D watershed supervoxels -> pre-merge ->
  supervoxel RAG -> greedy 3D merge tree (median policy) -> full-width BC
  features -> forest merge probabilities -> greedy tree resolution ->
  VI / adapted Rand against the 3D truth, with stage seconds and the
  peak RSS.

    python -m glia_tpu_torch.examples.run_3d_hmt [Z] [side] [n_cells]
        [--device cpu]

Defaults 100, 512, 400.  The volume is ``synthetic_em_stack((Z, side,
side), n_cells, seed=17)``; the forest (80 trees, pre-merge 50,
watershed 0.04) is trained by ``pipeline.hmt_train`` on an independent
subvolume (``train_config``: a quarter of the depth, half the side, the
cells in proportion; seed 31), on the volume's BC width.  The
segmentation is ``pipeline3d.hmt3d_segment`` with the port's defaults:
the serial C++ merge order (``engine="host"``) and the forest walked on
``device`` (the CUDA card by default: kernel B1).  ``run_3d_hmt``
returns the tool's keys, unrounded; ``main`` prints them as one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

from .snemi import log, peak_gb

WATERSHED_LEVEL, PRE_MERGE, N_TREES = 0.04, 50, 80
SEED, TRAIN_SEED = 17, 31


def train_config(Z: int, side: int, n_cells: int):
    """(depth, side, cells) of the training subvolume, as the tool
    computes them."""
    tz, tside = max(Z // 4, 8), max(side // 2, 64)
    tcells = max(n_cells * (tz * tside * tside) // (Z * side * side), 8)
    return tz, tside, tcells


def _stack(shape, n_cells, seed):
    """A synthetic stack as the dict of a training volume."""
    from ..data.synthetic import synthetic_em_stack

    st = synthetic_em_stack(shape=shape, n_cells=n_cells, seed=seed)
    return {"pb": st["pb3d"], "truth": st["truth3d"],
            "intensity": np.stack([s["intensity"] for s in st["slices"]]),
            "stack": st}


def run_3d_hmt(Z: int = 100, side: int = 512, n_cells: int = 400,
               device=None, arrays: Optional[dict] = None) -> dict:
    """The tool's flow on ``device`` (the CUDA card by default; ``"cpu"``
    for the plain path).  ``arrays`` (optional dict) receives what the
    run made: the volume and the training volume (``_stack`` dicts), the
    model, the segmentation, ``hmt3d_segment``'s aux dict and stats, and
    both evaluations.  Returns the tool's keys."""
    from ..device import resolve_device
    from ..pipeline import evaluate, hmt_train
    from ..pipeline3d import hmt3d_segment

    dev = resolve_device(device)
    seg_kw = dict(watershed_level=WATERSHED_LEVEL, pre_merge_size=PRE_MERGE)
    stages = {}
    t0 = time.perf_counter()
    vol = _stack((Z, side, side), n_cells, SEED)
    stages["generate"] = time.perf_counter() - t0
    log(f"volume: {Z}x{side}x{side} = {vol['pb'].size / 1e6:.0f}M voxels, "
        f"{n_cells} true cells ({stages['generate']:.1f}s, peak "
        f"{peak_gb():.1f}GB)")

    # the forest is trained on an independent subvolume: a volume's
    # supervoxels differ from a section's regions, and its BC vector is
    # wider (a forest trained on sections is refused)
    t0 = time.perf_counter()
    tz, tside, tcells = train_config(Z, side, n_cells)
    tr = _stack((tz, tside, tside), tcells, TRAIN_SEED)
    train_stats = {}
    model = hmt_train([{k: tr[k] for k in ("pb", "intensity", "truth")}],
                      n_trees=N_TREES, stats=train_stats, **seg_kw)
    stages["train"] = time.perf_counter() - t0
    log(f"trained forest on {tz}x{tside}x{tside} subvolume "
        f"({stages['train']:.1f}s)")

    t0 = time.perf_counter()
    seg_stats = {}
    seg, aux = hmt3d_segment(vol["pb"], vol["intensity"], model, device=dev,
                             stats=seg_stats, **seg_kw)
    stages["segment"] = time.perf_counter() - t0
    n_sv = int(len(np.unique(aux["seg0"])))
    log(f"3D HMT: {n_sv} supervoxels, {len(aux['order'])} merges "
        f"({stages['segment']:.1f}s, peak {peak_gb():.1f}GB)")

    t0 = time.perf_counter()
    base = evaluate(aux["seg0"], vol["truth"])
    ours = evaluate(seg, vol["truth"])
    stages["evaluate"] = time.perf_counter() - t0
    if arrays is not None:
        arrays.update(volume=vol, train=tr, model=model, seg=seg, aux=aux,
                      train_stats=train_stats, segment_stats=seg_stats,
                      eval_watershed=base, eval_hmt=ours)
    return {
        "config": f"3D HMT {Z}x{side}x{side}",
        "voxels": int(vol["pb"].size),
        "supervoxels": n_sv,
        "merges": int(len(aux["order"])),
        "vi_watershed": base["vi"],
        "vi_hmt": ours["vi"],
        "rand_error_watershed": base["rand_error"],
        "rand_error_hmt": ours["rand_error"],
        "stages_s": stages,
        "wall_s": sum(stages.values()),
        "peak_rss_gb": peak_gb(),
        "device": str(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("Z", nargs="?", type=int, default=100)
    ap.add_argument("side", nargs="?", type=int, default=512)
    ap.add_argument("n_cells", nargs="?", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run_3d_hmt(args.Z, args.side, args.n_cells, args.device)
    log(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
