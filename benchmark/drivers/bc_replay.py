"""Traffic ``bc_replay``: one caller re-running the classifier-in-the-loop
merge of one large over-segmentation under several trained boundary
classifiers, closed loop.

A lab that compares boundary classifiers segments a section once (its
watershed over-segmentation and RAG) and merges it again under each
classifier, every candidate pair rescored after every merge (GLIA's
merge_order_bc).  Set-up makes the configuration's section from the
cell's ``section_seed`` (the benchmark's recipe, bench.py's headline
section at 11) and grows the configuration's ``forests`` random forests,
forest k on the initial candidate pairs of its own ``train_side``^2
section of the same recipe (seed: stream 20 + k of ``section_seed``),
each pair labelled "merge" when the truth majorities of its two regions
agree, with the reference's feature code and the benchmark's own copy of
the CART trainer.  Every run grows the same forests, so every seed gives
the same work; the run's seed draws the order of the cycle and the calls
checked.

The program's state of the section is staged on the device once
(``glia_tpu_torch.graph.merge_bc_device.stage_bc_state``) and each
forest's node tables uploaded once; set-up then makes one call, which
warms every shape a call has, and launches kernel B1 once under each other
forest.  Each call is ``merge_order_bc_device`` on the staged state under
the next forest of the cycle, ending with its rows (label keys) and
probabilities copied into host buffers the caller keeps (page-locked on
the card's machine).  A call's work is E + merges (bench.py's edge
count, E the RAG's edges).

Correctness: a sample of the window's calls drawn from the seed and the
last call are each held to the plain reference (``reference/bc.py``) on
the card, superstep by superstep along the program's own order
(``check_call``), under the call's own forest: the largest
``rows_mismatched``, ``near_share`` and ``prob_gap`` over the calls,
against the cell's limits.

Traffic parameters (the cell file's ``traffic``): ``section_seed``;
``sample``, the calls kept for the check besides the last.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core.window import Reservoir
from benchmark.inputs.sections import bench_section, sub_seed
from benchmark.reference import bc
from benchmark.reference.host.forest import train_forest

MERGE, SPLIT = -1, 1


def section(cfg, side, seed):
    """The configuration's recipe at ``side``^2: (data, seg, rag)."""
    data, seg, rag, _ = bench_section(
        side, seed, blur=cfg["blur"], noise=cfg["noise"],
        smooth=cfg["gaussian"], level=cfg["watershed_level"])
    return data, seg, rag


def leaves(cfg, data, rag, device):
    return bc.Leaves(rag, [data["pb"], data["intensity"]],
                     cfg["boundary_thresholds"], cfg["n_bins"], device)


def truth_majority(seg, truth, keys):
    """The most frequent truth label of each region (the lowest on a
    tie), in the order of ``keys``."""
    s = seg.ravel().astype(np.int64)
    t = truth.ravel().astype(np.int64)
    n = int(t.max()) + 1
    code, cnt = np.unique(s * n + t, return_counts=True)
    reg, lab = code // n, code % n
    o = np.lexsort((lab, -cnt, reg))
    reg, lab = reg[o], lab[o]
    first = np.r_[True, reg[1:] != reg[:-1]]
    return lab[first][np.searchsorted(reg[first], keys)]


def training_set(cfg, seed, device):
    """(features [n, 143] float64, labels [n]) of the initial candidate
    pairs of one training section: MERGE where both regions' truth
    majorities agree."""
    data, seg, rag = section(cfg, cfg["train_side"], seed)
    lv = leaves(cfg, data, rag, device)
    part = bc.partition(lv, torch.arange(lv.R, device=device))
    X, _ = bc.features(part)
    maj = truth_majority(seg, data["truth"], rag.keys)
    lo, hi = part.lo.cpu().numpy(), part.hi.cpu().numpy()
    return X.cpu().numpy(), np.where(maj[lo] == maj[hi], MERGE, SPLIT)


def grow_forests(cfg, traffic, device, log):
    out = []
    for k in range(int(cfg["forests"])):
        t = time.perf_counter()
        X, y = training_set(cfg, sub_seed(traffic["section_seed"], 20 + k),
                            device)
        f = train_forest(X, y, n_trees=cfg["n_trees"],
                         sample_ratio=cfg["sample_ratio"],
                         balance_classes=cfg["balance_classes"], seed=k)
        log(f"forest {k}: {len(y)} pairs, {np.mean(y == MERGE):.3f} merge, "
            f"depth {f.max_depth}, {f.feature.shape[1]} nodes "
            f"({time.perf_counter() - t:.1f} s)")
        out.append(f)
    return out


def forest_cycle(seed, n_forests):
    """The order in which a run of seed ``seed`` takes the forests."""
    return np.random.default_rng(sub_seed(seed, 4)).permutation(n_forests)


class State:
    def __init__(self, cell, seed, device, log):
        from glia_tpu_torch.features.config import FeatureConfig
        from glia_tpu_torch.graph.merge_bc_device import (
            merge_order_bc_device, stage_bc_state)
        from glia_tpu_torch.models.forest import (ForestModel,
                                                  make_label_scorer)

        cfg, traffic = cell["config_data"], cell["traffic"]
        self.cfg, self.limits, self.dev = cfg, cell["limits"], device
        self.merge = merge_order_bc_device
        t = time.perf_counter()
        self.data, _, self.rag = section(cfg, cfg["side"],
                                         traffic["section_seed"])
        self.E = self.rag.n_edges
        R = self.rag.n_regions
        log(f"section {cfg['side']}^2: R {R}, E {self.E} "
            f"({time.perf_counter() - t:.1f} s)")
        self.forests = grow_forests(cfg, traffic, device, log)
        t = time.perf_counter()
        fcfg = FeatureConfig.standard(
            self.data["pb"], self.data["intensity"], n_bins=cfg["n_bins"],
            boundary_thresholds=tuple(cfg["boundary_thresholds"]))
        self.staged = stage_bc_state(self.rag, fcfg, device,
                                     getattr(torch, cfg["dtype"]))
        self.scorers = [make_label_scorer(ForestModel.from_arrays(
            f.feature, f.threshold, f.left, f.right, f.leaf_class,
            len(f.classes), f.max_depth, f.classes, f.n_features),
            label=MERGE, device=device) for f in self.forests]
        log(f"staged: {self.staged[1].E} state edges "
            f"({time.perf_counter() - t:.1f} s)")
        pin = device.type == "cuda"
        max_m = max(R - 1, 1)
        self.out = (torch.empty((max_m, 3), dtype=torch.int64,
                                pin_memory=pin),
                    torch.empty(max_m, dtype=torch.float64, pin_memory=pin))
        # Every call has the same shapes (each superstep is sized by the
        # staged state's edges), so one call warms them all.  A forest's
        # own first launch of kernel B1 only plans its tables' layout on
        # the host: one row a forest does that.
        st = {}
        t = time.perf_counter()
        self._call(0, st)
        log(f"set-up call, forest 0: {time.perf_counter() - t:.3f} s, "
            f"{self.n} merges, {st['n_supersteps']} supersteps")
        x = torch.zeros((1, int(cfg["n_features"])), dtype=torch.float32,
                        device=device)
        for score in self.scorers[1:]:
            score(x)
        self.cycle = forest_cycle(seed, len(self.forests))
        self.sample = Reservoir(np.random.default_rng(sub_seed(seed, 3)),
                                int(traffic["sample"]))
        self.lat = [[] for _ in self.forests]
        self.i = 0
        self.t_ready = time.perf_counter()

    def _call(self, f, st):
        """One call under forest ``f``: (the program's order and
        probabilities as it returned them); they end in ``self.out``."""
        order, probs = self.merge(self.rag, None, self.scorers[f], stats=st,
                                  state=self.staged)
        n = len(order)
        self.out[0][:n].copy_(torch.from_numpy(order))
        self.out[1][:n].copy_(torch.from_numpy(probs))
        self.n, self.steps = n, list(st["merges_per_superstep"])
        return order, probs

    def step(self):
        st = {}
        f = int(self.cycle[self.i % len(self.cycle)])
        t = time.perf_counter()
        order, probs = self._call(f, st)
        self.lat[f].append(time.perf_counter() - t)
        slot = self.sample.draw()
        if slot is not None:
            # the program's own outputs of this call (new arrays each call)
            self.sample.put(slot, (self.i, f, order, probs, self.steps))
        self.last_forest = f
        self.i += 1
        return self.E + self.n, {"forest": f, "stats": {
            "n_supersteps": st.get("n_supersteps")}}

    def free(self):
        """Drop the program's device state before the reference runs."""
        self.staged = self.scorers = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log):
        """(calls checked, calls failing a limit, [(name, widest reading
        over the checked calls, limit)])."""
        log("window calls by forest: " + ", ".join(
            f"{f}: {len(x)} x {np.median(x):.3f} s"
            for f, x in enumerate(self.lat) if x))
        log_spans(self.t_ready, log)
        last = self.i - 1
        sample = [x for x in self.sample.items if x[0] != last]
        sample.append((last, self.last_forest, self.out[0][:self.n].numpy(),
                       self.out[1][:self.n].numpy(), self.steps))
        t = time.perf_counter()
        lv = leaves(self.cfg, self.data, self.rag, self.dev)
        log(f"reference leaves ({time.perf_counter() - t:.1f} s)")
        return check_calls(lv, self.forests, sample, self.limits, self.dev,
                           log)


def log_spans(t0, log):
    """The program's spans summed over its ``bc.merge`` records since
    ``t0`` (the window's calls), each beside its share of their seconds."""
    from glia_tpu_torch.utils import profiling

    recs = [r for r in getattr(profiling, "records", ())
            if r.name == "bc.merge" and r.t0 >= t0]
    total = sum(r.seconds for r in recs)
    if not total:
        return
    spans = {}
    for r in recs:
        for k, v in r.spans.items():
            spans[k] = spans.get(k, 0.0) + v
    log(f"spans of {len(recs)} bc.merge calls, {total:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s ({v / total:.4f})" for k, v in sorted(spans.items())))


def check_calls(lv, forests, calls, lim, device, log):
    """Each of ``calls`` ((i, forest, rows, probs, merges a superstep))
    held to the reference: (calls, failing calls, numbers)."""
    worst = {"rows_mismatched": 0, "near_share": 0.0, "prob_gap": 0.0}
    failed = 0
    for _, f, rows, probs, steps in calls:
        t = time.perf_counter()
        walk = bc.ForestWalk(forests[f], MERGE, device)
        got = bc.check_call(lv, walk, rows, probs, steps)
        nums = {"rows_mismatched": got["mismatched"],
                "near_share": got["explained"] / max(got["checked"], 1),
                "prob_gap": got["prob_gap"]}
        log(f"reference, forest {f}: {got['checked']} rows, "
            f"{got['explained']} explained, {nums} "
            f"({time.perf_counter() - t:.1f} s)")
        failed += any(nums[k] > lim[k] for k in nums)
        for k in nums:
            worst[k] = max(worst[k], nums[k])
    return len(calls), failed, [(k, worst[k], lim[k]) for k in worst]


def setup(cell, seed, device, log):
    return State(cell, seed, device, log)
