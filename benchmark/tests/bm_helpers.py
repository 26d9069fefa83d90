"""A tiny cell for the CPU tests: the benchmark's configuration and cell
at a few hundred pixels, written as added files under a directory of
their own, which the registry searches before the benchmark's."""

import json
import os

from benchmark.core.registry import BENCH_DIR


def _load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def _write(root, kind, name, data):
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(root, kind, name + ".json"), "w") as f:
        json.dump(data, f)


def tiny_cells(root) -> str:
    """Adds ``tiny.replay`` (bench4096's recipe at 256^2, four boundary
    maps) under ``root``; returns ``root``."""
    root = str(root)
    c = dict(_load("configs", "bench4096"), side=256)
    _write(root, "configs", "tiny", c)
    w = _load("workloads", "bench4096.replay")
    w.update(config="tiny", traffic=dict(w["traffic"], maps=4))
    _write(root, "workloads", "tiny.replay", w)
    return root
