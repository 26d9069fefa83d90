"""Traffic ``merge_replay``: one caller re-merging one large RAG under
several boundary maps, closed loop.

Users segment a section once (its watershed over-segmentation and RAG)
and merge it again under the boundary maps of other predictors, to
compare them or pick one.  Set-up makes the configuration's section from
the cell's ``section_seed`` (the benchmark's recipe; bench.py's headline
section at 11) and ``maps`` - 1 more boundary maps of it
(``inputs.sections.boundary_sums``): the edges and their pixel counts
stay, each map has boundary sums of its own.  Every run merges the same
set of maps, so every seed gives the same work: the plan that the first
map's merge measures fixes how far the later maps' merges run in the
plan's CUDA graph, so sections drawn from the run's seed gave runs whose
work differed by seed.  The run's seed draws the order of the cycle and
the calls checked.

The edge arrays and every map's sums are staged on the device once.
Set-up then runs the first call on the section's own map (the
multi-phase plan's discovery), calls until the plan's CUDA graph is
captured and replayed once, and calls once on every map.  The window
takes the maps in the seed's cycle.  Each call is
``glia_tpu_torch.graph.merge_device.merge_batched_device_exact`` on the
staged arrays and one map's sums, ending with the order's rows and the
exact saliencies copied into host memory that the caller keeps for its
calls (page-locked on the card's machine): what a caller gets.  A call's
work is E + merges (bench.py's edge count).

Correctness: a sample of the window's calls drawn from the seed (their
outputs as the program returned them, kept without a copy), and the last
call's rows and saliencies in the host buffers, are each compared with
the plain reference (``reference/merge.py``) on that call's own map: the
rows (exact) and the exact merge-time saliencies (widest gap).

Traffic parameters (the cell file's ``traffic``): ``section_seed``, the
seed of the section and its maps; ``maps``, the boundary maps;
``sample``, the calls kept for the check besides the last.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.inputs.sections import bench_section, boundary_sums, sub_seed
from benchmark.reference.merge import batched_merge, exact_saliency
from benchmark.core.window import Reservoir


def rows_mismatched(rows: np.ndarray, ref: np.ndarray) -> int:
    """Rows of two merge orders that differ, by position, and rows one
    order has beyond the other."""
    n = min(len(rows), len(ref))
    return int((rows[:n] != ref[:n]).any(axis=1).sum()) + abs(len(rows)
                                                               - len(ref))


def saliency_gap(sal: np.ndarray, ref_stat: np.ndarray) -> float:
    """Widest gap between a program's saliencies (minus the pooled mean)
    and the reference's exact pooled means, over the rows both have; a
    value missing on one side only counts as infinite."""
    n = min(len(sal), len(ref_stat))
    got = -np.asarray(sal[:n], np.float64)
    ref = np.asarray(ref_stat[:n], np.float64)
    if (np.isnan(got) != np.isnan(ref)).any():
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.abs(got[ok] - ref[ok]).max()) if ok.any() else 0.0


def section_inputs(cfg, traffic):
    """The configuration's section made from the traffic's
    ``section_seed``: (R, (u, v, c), the boundary sums of its ``maps``
    maps [maps, E], the section's own first)."""
    seed = traffic["section_seed"]
    data, _, rag, (u, v, s, c) = bench_section(
        cfg["side"], seed, blur=cfg["blur"], noise=cfg["noise"],
        smooth=cfg["gaussian"], level=cfg["watershed_level"])
    more = boundary_sums(data, rag, seed, int(traffic["maps"]) - 1,
                         blur=cfg["blur"], noise=cfg["noise"])
    return rag.n_regions, (u, v, c), np.concatenate([s[None], more])


def map_cycle(seed, n_maps):
    """The order in which a run of seed ``seed`` takes the maps."""
    return np.random.default_rng(sub_seed(seed, 4)).permutation(n_maps)


class State:
    def __init__(self, cell, seed, device, log):
        from glia_tpu_torch.graph.merge_device import (
            merge_batched_device_exact)

        cfg, traffic = cell["config_data"], cell["traffic"]
        self.limits = cell["limits"]
        self.dev = device
        self.dtype = getattr(torch, cfg["dtype"])
        self.dmax = int(cfg["dmax"])
        self.merge = merge_batched_device_exact
        t = time.perf_counter()
        self.R, (u, v, c), self.sums = section_inputs(cfg, traffic)
        self.E = len(u)
        self.host = (u, v, c)
        log(f"section {cfg['side']}^2: R {self.R}, E {self.E}, "
            f"{len(self.sums)} maps ({time.perf_counter() - t:.1f} s)")
        self.uv = (torch.as_tensor(u, device=device).long(),
                   torch.as_tensor(v, device=device).long())
        self.c = torch.as_tensor(c, device=device).to(self.dtype)
        self.s = torch.as_tensor(self.sums, device=device).to(self.dtype)
        pin = device.type == "cuda"
        max_m = max(self.R - 1, 1)
        self.out = (torch.empty((max_m, 3), dtype=torch.int64,
                                pin_memory=pin),
                    torch.empty(max_m, dtype=self.dtype, pin_memory=pin))
        # the discovery call on the section's own map, then calls until
        # the plan's CUDA graph has been captured and replayed once, then
        # one call on every map: every shape the window uses
        graphs = 0
        for k in range(6):
            st = {}
            t = time.perf_counter()
            _, _, n = self._call(0, st)
            graphs += bool(st.get("plan_graph"))
            log(f"set-up call {k}: {time.perf_counter() - t:.4f} s, {n} "
                f"merges, {st.get('n_supersteps')} supersteps, graph "
                f"{bool(st.get('plan_graph'))}")
            if graphs == 2 or (device.type != "cuda" and k == 2):
                break
        if device.type == "cuda" and graphs < 2:
            raise RuntimeError("the plan's CUDA graph was not replayed in "
                               "set-up")
        for m in range(len(self.sums)):
            st = {}
            t = time.perf_counter()
            _, _, n = self._call(m, st)
            log(f"set-up map {m}: {time.perf_counter() - t:.4f} s, {n} "
                f"merges, {st.get('n_supersteps')} supersteps, graph "
                f"{bool(st.get('plan_graph'))}, fallback "
                f"{bool(st.get('fallback'))}")
        self.cycle = map_cycle(seed, len(self.sums))
        self.sample = Reservoir(np.random.default_rng(sub_seed(seed, 3)),
                                int(traffic["sample"]))
        self.lat = [[] for _ in self.sums]
        self.i = 0

    def _call(self, m, st):
        """One call on map ``m``: (the program's order and saliencies on
        the device, the merges); its rows and saliencies end in
        ``self.out`` on the host."""
        order, sal, n = self.merge(*self.uv, self.s[m], self.c, self.R,
                                   dmax=self.dmax, dtype=self.dtype,
                                   stats=st, device=self.dev)
        rows, sals = self.out
        # both copies queued, then one wait: the host holds the outputs
        rows[:n].copy_(order[:n], non_blocking=True)
        sals[:n].copy_(sal[:n], non_blocking=True)
        if self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()
        self.n = n
        return order[:n], sal[:n], n

    def step(self):
        st = {}
        m = int(self.cycle[self.i % len(self.cycle)])
        t = time.perf_counter()
        order, sal, n = self._call(m, st)
        self.lat[m].append(time.perf_counter() - t)
        slot = self.sample.draw()
        if slot is not None:
            # the program's own output tensors of this call, kept as they
            # are (each call returns new ones): no copy in the window
            self.sample.put(slot, (self.i, m, order, sal))
        self.last_map = m
        self.i += 1
        return self.E + n, {"map": m, "stats": {k: st.get(k) for k in (
            "n_supersteps", "plan_graph", "fallback")}}

    def free(self):
        """Drop the program's device state before the reference runs (the
        sampled calls' outputs stay, a few MB)."""
        self.uv = self.c = self.s = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log):
        """(calls checked, calls failing a limit, [(name, widest reading
        over the sampled calls, limit)])."""
        u, v, c = self.host
        log("window calls by map: " + ", ".join(
            f"{m}: {len(x)} x {np.median(x) * 1e3:.3f} ms"
            for m, x in enumerate(self.lat) if x))
        last = self.i - 1
        sample = [x for x in self.sample.items if x[0] != last]
        sample.append((last, self.last_map, self.out[0][:self.n],
                       self.out[1][:self.n]))
        refs = {}
        lim = self.limits
        mism, gap, failed = 0, 0.0, 0
        for _, m, rows, sal in sample:
            if m not in refs:
                t = time.perf_counter()
                s = self.sums[m]
                ref_rows, _, _ = batched_merge(u, v, s, c, self.R,
                                               dmax=self.dmax,
                                               dtype=self.dtype)
                refs[m] = ref_rows, exact_saliency(u, v, s, c, ref_rows,
                                                   self.R)
                log(f"reference, map {m}: {len(ref_rows)} merges "
                    f"({time.perf_counter() - t:.1f} s)")
            ref_rows, ref_stat = refs[m]
            mm = rows_mismatched(rows.cpu().numpy(), ref_rows)
            g = saliency_gap(sal.double().cpu().numpy(), ref_stat)
            failed += mm > lim["rows_mismatched"] or g > lim["saliency_gap"]
            mism, gap = max(mism, mm), max(gap, g)
        return len(sample), failed, [
            ("rows_mismatched", mism, lim["rows_mismatched"]),
            ("saliency_gap", gap, lim["saliency_gap"])]


def setup(cell, seed, device, log):
    return State(cell, seed, device, log)
