"""Checkpoint / resume for models and pipeline stage artifacts
(counterpart of glia_tpu.utils.checkpoint).

The reference's recovery story is its file bus: every stage's outputs are
files, so a failed pipeline resumes from the last stage.  Here the same
restartability comes from a stage store: each stage's arrays (merge
order, saliencies, features, probabilities, label images) checkpoint into
a directory keyed by stage name, as ``.npz`` plus ``.json`` metadata, the
files glia_tpu's StageStore reads and writes.  Parameters (a pytree of
tensors: dicts, lists and tuples of them) go through ``torch.save``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


class StageStore:
    """Directory-backed store of per-stage arrays + metadata."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, stage: str) -> str:
        return os.path.join(self.root, f"{stage}.npz")

    def has(self, stage: str) -> bool:
        return os.path.exists(self._path(stage))

    def save(self, stage: str, **arrays):
        meta = {k: v for k, v in arrays.items()
                if not isinstance(v, np.ndarray)}
        arrs = {k: v for k, v in arrays.items()
                if isinstance(v, np.ndarray)}
        np.savez_compressed(self._path(stage), **arrs)
        if meta:
            with open(os.path.join(self.root, f"{stage}.json"), "w") as f:
                json.dump(meta, f)

    def load(self, stage: str) -> Dict[str, Any]:
        with np.load(self._path(stage), allow_pickle=False) as z:
            out = {k: z[k] for k in z.files}
        meta_path = os.path.join(self.root, f"{stage}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                out.update(json.load(f))
        return out

    def run(self, stage: str, fn, *args, **kwargs):
        """Memoized stage execution: load if checkpointed, else compute
        and save.  fn must return a dict of arrays."""
        if self.has(stage):
            return self.load(stage)
        out = fn(*args, **kwargs)
        self.save(stage, **out)
        return out


def save_params(path: str, params):
    """Save a pytree of tensors (model weights, optimizer state dicts)
    to the file ``path``."""
    torch.save(params, os.path.abspath(path))


def _like(x, template):
    """``x`` with ``template``'s structure, each tensor on the template
    leaf's device and in its dtype."""
    if torch.is_tensor(template):
        return x.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if set(x) != set(template):
            raise ValueError(f"restored keys {sorted(x)} differ from the "
                             f"template's {sorted(template)}")
        return {k: _like(x[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(x) != len(template):
            raise ValueError(f"restored {len(x)} items, the template has "
                             f"{len(template)}")
        return type(template)(_like(a, t) for a, t in zip(x, template))
    return x


def restore_params(path: str, template=None):
    """Load what ``save_params`` wrote (tensors and plain containers
    only: ``weights_only``).  With a ``template`` the result takes its
    structure, devices and dtypes."""
    params = torch.load(os.path.abspath(path), map_location="cpu",
                        weights_only=True)
    return params if template is None else _like(params, template)
