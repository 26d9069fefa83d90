"""The correctness check fails what it must, on the CPU at a tiny size.

- The lower-precision control (the reference in bfloat16, put in the
  program's place: ``benchmark/control.py``) reads above every limit it is
  meant to catch.
- A run with the timed path broken underneath (the harness's look for a
  card skipped, the rest of the run driven as it is) comes out not
  correct, for each fault the cell can have: a call that returns the
  state unchanged, half of the work left out, an answer altered where it
  is produced (the cell runs on one card: no exchange between cards), the
  engine's stale start-of-superstep saliencies in place of the exact
  ones, and every call merging one boundary map whatever map it is given.

``test_control_on_the_card`` runs the control at the cell's own size on
three seeds; it needs the card's machine for its time and memory, not its
card.
"""

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.core.registry import Registry

from bm_helpers import tiny_cells

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Registry([tiny_cells(tmp_path_factory.mktemp("tiny"))])


def test_merge_control_fails(tiny):
    cell = tiny.cell("tiny.replay")
    got = control.merge_control(cell, SEED, torch.bfloat16)
    assert got["rows_mismatched"] > cell["limits"]["rows_mismatched"]
    assert got["saliency_gap"] > cell["limits"]["saliency_gap"]


def _merge_fault(kind):
    import glia_tpu_torch.graph.merge_device as md

    real = md.merge_batched_device_exact
    first = []

    def broken(*a, **k):
        if kind == "other_map":
            # every call merges the first call's boundary map
            first[:] = first or [a[2].clone()]
            return real(a[0], a[1], first[0], *a[3:], **k)
        if kind == "stale":
            # the engine's start-of-superstep saliencies, not the exact ones
            return md.merge_batched_device(*a, mode="fused_ms", **k)
        order, sal, n = real(*a, **k)
        if kind == "unchanged":
            return order, sal, 0
        if kind == "half":
            return order, sal, n // 2
        order = order.clone()
        order[n // 2, [0, 1]] = order[n // 2, [1, 0]]
        return order, sal, n
    return md, "merge_batched_device_exact", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "stale",
                                  "other_map"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, kind):
    mod, name, broken = _merge_fault(kind)
    monkeypatch.setattr(mod, name, broken)
    out = run.run_cell("tiny.replay", SEED, 0.3, 0, CPU, registry=tiny)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.card
def test_control_on_the_card(card):
    cell = Registry().cell("bench4096.replay")
    lim = cell["limits"]
    for seed in (1_000_003, 2 ** 31 + 11, 3 * 2 ** 30 + 7):
        got = control.merge_control(cell, seed, torch.bfloat16)
        assert any(got[k] > lim[k] for k in got), got
        assert np.isfinite(list(lim.values())).all()
