"""Finding the benchmark's parts by name.

Each part is a file of its own, found by the name ``BENCHMARK.json`` or a
cell file gives it:

- ``workloads/<cell>.json``: the cell (its configuration, traffic driver,
  traffic parameters, end-to-end metrics, traced stretch and ``why``);
- ``configs/<config>.json``: the configuration;
- ``drivers/<driver>.py``: one kind of traffic;
- ``end_to_end/<metric>.py``: one end-to-end metric (``value(window)``);
- ``layer_metrics/<metric>.py``: one per-layer metric (``LAYER``, ``UNIT``,
  ``SOURCE``, ``MOVES``, ``WORKLOADS``, ``read(ctx)``).

A later change adds a cell, a configuration or a metric by adding files.
``roots`` lists directories searched in turn, the benchmark's own last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import List, Optional, Sequence

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Registry:
    def __init__(self, roots: Optional[Sequence[str]] = None):
        self.roots: List[str] = [*(roots or ()), BENCH_DIR]

    def path(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + ext)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{', '.join(self.roots)}")

    def json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        mod_name = f"benchmark_{kind}_{name}".replace(".", "_")
        if mod_name in sys.modules:
            return sys.modules[mod_name]
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        """The cell file with its configuration under ``config_data``."""
        cell = self.json("workloads", name)
        cell["name"] = name
        cell["config_data"] = self.json("configs", cell["config"])
        return cell

    def names(self, kind: str, ext: str) -> List[str]:
        seen = []
        for root in self.roots:
            d = os.path.join(root, kind)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.endswith(ext) and not f.startswith("_"):
                    n = f[:-len(ext)]
                    if n not in seen:
                        seen.append(n)
        return seen

    def layer_metrics(self, cell_name: str):
        """(name, module) of every per-layer metric whose ``WORKLOADS``
        lists ``cell_name``; a metric file without the list is refused."""
        out = []
        for name in self.names("layer_metrics", ".py"):
            mod = self.module("layer_metrics", name)
            if not hasattr(mod, "WORKLOADS"):
                raise ValueError(f"layer_metrics/{name}.py lists no "
                                 f"WORKLOADS")
            if cell_name in mod.WORKLOADS:
                out.append((name, mod))
        return out
