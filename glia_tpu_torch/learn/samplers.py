"""Epoch-aware minibatch samplers (the port's copy of
glia_tpu.learn.samplers, numpy on the host).

Reference: code/type/sampler.hxx -- UniformBatchSampler draws consecutive
batches from a per-epoch shuffle; ClassBatchSampler balances each batch
across label classes (sampler.hxx:105-177).  Used by the minibatch GD
paths (alg/gd.hxx:86-157).
"""

from __future__ import annotations

import numpy as np


class UniformBatchSampler:
    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.n = n
        self.batch_size = min(batch_size, n)
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self._perm = None
        self._pos = 0

    def _new_epoch(self):
        self._perm = (self.rng.permutation(self.n) if self.shuffle
                      else np.arange(self.n))
        self._pos = 0

    def next_batch(self) -> np.ndarray:
        if self._perm is None or self._pos + self.batch_size > self.n:
            self._new_epoch()
        out = self._perm[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return out


class ClassBatchSampler:
    """Class-balanced batches: an equal share per class each batch, each
    class cycling through its own shuffled epoch."""

    def __init__(self, labels, batch_size: int, seed: int = 0):
        labels = np.asarray(labels)
        self.classes = np.unique(labels)
        self.idx = {c: np.nonzero(labels == c)[0] for c in self.classes}
        per = max(1, batch_size // len(self.classes))
        self.samplers = {
            c: UniformBatchSampler(len(self.idx[c]), min(per, len(self.idx[c])),
                                   seed + i)
            for i, c in enumerate(self.classes)
        }

    def next_batch(self) -> np.ndarray:
        parts = [self.idx[c][self.samplers[c].next_batch()]
                 for c in self.classes]
        return np.concatenate(parts)
