"""Checks of BASELINE config #5 at full scale that the example
``run_snemi_e2e`` does not make, on one volume:

  - two runs of ``snemi_e2e`` give the same bits: the loss of every step,
    the weights, the probabilities, the merge rows, the exact saliencies,
    each cut's scores and the rows it keeps at every tau;
  - (a) the sharded merge's rows (float64) equal
    ``merge_batched_device(mode="fused")``'s on ``device``;
  - (b) the sharded exact saliencies equal the C++ replay's
    (``replay_exact_saliency``, relative gap printed);
  - ``run_snemi_sharded``'s counters and halo step;
  - with ``--parent DIR`` (a directory holding another tree of the
    package, e.g. a parent commit unpacked by ``git archive``): the halo
    step's steady time of that tree and of this one on the same block of
    inputs, one process each, in the order parent, this, this, parent.

    python -m glia_tpu_torch.examples.snemi_checks [Z] [side] [n_cells]
        [--parent DIR] [--device cpu]

Defaults 100, 1024, 400 (SNEMI3D's scale).  Prints one JSON line a part.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

from .snemi import log, make_volume

# one process of the halo-step comparison: the step_rank of the package
# found first on sys.path, on the pickled block
_STEP_CODE = r"""
import json, pickle, sys
import numpy as np
import glia_tpu_torch
from glia_tpu_torch.examples.run_snemi_sharded import step_rank
from glia_tpu_torch.parallel.launch import spawn_ranks
if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        plan, R, block = pickle.load(f)
    dev = sys.argv[2]
    res = spawn_ranks(step_rank, 1, "nccl" if dev == "cuda" else "gloo",
                      dev, args=(plan, R), rank_args=[(block,)],
                      timeout_s=900)[0]
    print(json.dumps({"package": glia_tpu_torch.__file__,
                      "steps_s": res["steps_s"],
                      "step_s": float(np.median(res["steps_s"])),
                      "batch_s": res.get("batch_s"),
                      "loss_first": res["loss_first"]}), flush=True)
"""


def emit(obj):
    print(json.dumps(obj, default=lambda x: x.tolist()
                     if hasattr(x, "tolist") else str(x)), flush=True)


def _rel_gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.isfinite(want)
    if not np.array_equal(ok, np.isfinite(got)):
        return float("inf")
    return float(np.abs(got[ok] - want[ok]).max()
                 / max(np.abs(want[ok]).max(), 1e-300))


def two_runs(vol, device) -> dict:
    """``snemi_e2e`` twice on ``vol``; each run's result (``e2e_0``,
    ``e2e_1``), ``identical`` (per item, bit for bit) and the first run's
    arrays."""
    from ..graph.merge_device import threshold_cut
    from . import run_snemi_e2e as e2e

    runs = []
    for _ in range(2):
        arr = {}
        runs.append((e2e.snemi_e2e(vol, device=device, arrays=arr), arr))
    (r1, a1), (r2, a2) = runs

    def cut_rows(a, tau):
        return a["okeys"][threshold_cut(a["okeys"], a["exact"], tau)]

    identical = {
        "losses_all_steps": r1["losses"] == r2["losses"],
        "weights": bool(np.array_equal(a1["w"], a2["w"])),
        "probs": bool(np.array_equal(a1["probs"], a2["probs"])),
        "rows": bool(np.array_equal(a1["rows"], a2["rows"])),
        "exact": bool(np.array_equal(a1["exact"], a2["exact"],
                                     equal_nan=True)),
        "cuts": [c1 == c2 for c1, c2 in zip(r1["cuts"], r2["cuts"])],
        "cut_rows": {tau: bool(np.array_equal(cut_rows(a1, tau),
                                              cut_rows(a2, tau)))
                     for tau in e2e.TAUS}}
    return {"e2e_0": r1, "e2e_1": r2, "identical": identical, "arrays": a1}


def merge_checks(vol, arrays, device) -> dict:
    """(a) and (b) on one run's payload and order."""
    import torch

    from ..graph import merge_device as md
    from . import run_snemi_e2e as e2e

    u, v, s, c, rows = (arrays[k] for k in ("u", "v", "s", "c", "rows"))
    t = time.perf_counter()
    o_f, _, n_f = md.merge_batched_device(
        u, v, s, c, vol.rag.n_regions, max_supersteps=e2e.MAX_SUPERSTEPS,
        dtype=torch.float64, mode="fused", dmax=e2e.DMAX, device=device)
    fused_s = time.perf_counter() - t
    t = time.perf_counter()
    host64 = md.replay_exact_saliency(u, v, s, c, rows, engine="native")
    replay_s = time.perf_counter() - t
    return {"merges": len(rows), "fused_merges": n_f,
            "a_rows_equal_fused_f64": n_f == len(rows) and bool(
                np.array_equal(o_f[:n_f].cpu().numpy(), rows)),
            "fused_s": fused_s,
            "b_exact_rel_gap_vs_replay": _rel_gap(arrays["exact"], host64),
            "replay_s": replay_s}


def halo_step_by_tree(vol, roots, device) -> list:
    """The halo step's steady time of each package tree in ``roots``
    (directories that hold a ``glia_tpu_torch``), one process each, on
    one block of inputs (world 1, random labels, seed 0)."""
    from ..parallel.halo import HaloPlan
    from ..parallel.partition import partition_rag
    from ..parallel.train import halo_rank_block, halo_train_host_inputs
    from .run_snemi_sharded import K_PIXELS

    part = partition_rag(vol.rag, 1)
    plan = HaloPlan(part, vol.rag)
    labels = np.random.default_rng(0).integers(
        0, 2, vol.rag.n_edges).astype(np.float32)
    host = halo_train_host_inputs(plan, part, vol.rag,
                                  [vol.pb, vol.intensity], labels, K_PIXELS)
    out = []
    with tempfile.TemporaryDirectory(prefix="glia_step_") as tmp:
        path = os.path.join(tmp, "block.pkl")
        with open(path, "wb") as f:
            pickle.dump((plan, vol.rag.n_regions, halo_rank_block(host, 0)),
                        f)
        del host
        for root in roots:
            proc = subprocess.run(
                [sys.executable, "-c", _STEP_CODE, path, device],
                env=dict(os.environ, PYTHONPATH=root), cwd=root,
                capture_output=True, text=True, timeout=1200)
            if proc.returncode:
                raise RuntimeError(f"halo step of {root} failed:\n"
                                   f"{proc.stderr[-4000:]}")
            out.append({"root": root, **json.loads(
                proc.stdout.strip().splitlines()[-1])})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("Z", nargs="?", type=int, default=100)
    ap.add_argument("side", nargs="?", type=int, default=1024)
    ap.add_argument("n_cells", nargs="?", type=int, default=400)
    ap.add_argument("--parent", default=None,
                    help="a directory holding another tree of the package")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from . import run_snemi_sharded as shd

    dev = resolve_device(args.device)
    t = time.perf_counter()
    vol = make_volume(args.Z, args.side, args.n_cells)
    emit({"part": "volume", "s": time.perf_counter() - t,
          "R": vol.rag.n_regions, "E": vol.rag.n_edges})
    runs = two_runs(vol, dev)
    for k in ("e2e_0", "e2e_1"):
        emit({"part": k, **{x: y for x, y in runs[k].items()
                            if x != "losses"}})
    emit({"part": "two_runs_identical", **runs["identical"]})
    emit({"part": "checks_a_b", **merge_checks(vol, runs["arrays"], dev)})
    del runs
    emit({"part": "sharded", **shd.snemi_sharded(vol, shards=8,
                                                 device=dev)})
    if args.parent:
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        roots = [args.parent, here, here, args.parent]
        for r in halo_step_by_tree(vol, roots, dev.type):
            emit({"part": "halo_step", **r})
    log("done")


if __name__ == "__main__":
    main()
