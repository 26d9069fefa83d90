"""Random forest inference: numpy model, plain PyTorch walk, CUDA scorer.

The reference's forest predicts vote fractions,
``predict(x, label) = votes[label] / ntree``, each tree voting its leaf
class; a sample descends left iff ``x[bestvar] <= split``
(code/ml/rf/rf.hxx:362-372, classForest).  Forests reach the port as
node arrays: ``ForestModel.load`` reads the ``.npz`` that
glia_tpu.models.forest.ForestModel.save writes, and ``from_arrays`` takes
the arrays directly; ``train_forest`` grows one with the port's own CART
trainer (``native/src/glia_forest.cc``), as glia_tpu's grows one with
sklearn.  Both walks here compare in float32, as the JAX walk
and the TPU kernel do: features are cast to float32 first, since float64
features against float32 thresholds would flip ties.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..native import forest_train_native


@dataclass
class ForestModel:
    """Dense node-array forest (all trees padded to max_nodes)."""

    feature: np.ndarray     # int32 [T, N]; -1 at leaves
    threshold: np.ndarray   # float32 [T, N]
    left: np.ndarray        # int32 [T, N]
    right: np.ndarray       # int32 [T, N]
    leaf_class: np.ndarray  # int32 [T, N] (argmax class at node; valid at leaves)
    n_classes: int
    max_depth: int
    classes: np.ndarray     # original class labels [n_classes]
    # the width of the samples the forest was trained on; None for a
    # forest carried over without it (then only its splits are checked)
    n_features: Optional[int] = None

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @classmethod
    def from_arrays(cls, feature, threshold, left, right, leaf_class,
                    n_classes, max_depth, classes,
                    n_features=None) -> "ForestModel":
        """Build from node arrays [T, N] (glia_tpu's ForestModel fields),
        casting each to the dtype the walks use; ``n_features``, the
        training width, is optional."""
        feature = np.ascontiguousarray(feature, dtype=np.int32)
        arrays = dict(
            threshold=np.ascontiguousarray(threshold, dtype=np.float32),
            left=np.ascontiguousarray(left, dtype=np.int32),
            right=np.ascontiguousarray(right, dtype=np.int32),
            leaf_class=np.ascontiguousarray(leaf_class, dtype=np.int32))
        if feature.ndim != 2 or any(a.shape != feature.shape
                                    for a in arrays.values()):
            raise ValueError("forest node arrays must all be [T, N]")
        N = feature.shape[1]
        for k in ("left", "right"):
            a = arrays[k]
            if a.size and (a.min() < 0 or a.max() >= N):
                raise ValueError(f"forest {k} child index out of [0, {N})")
        return cls(feature=feature, n_classes=int(n_classes),
                   max_depth=int(max_depth), classes=np.asarray(classes),
                   n_features=None if n_features is None
                   else int(n_features), **arrays)

    @classmethod
    def load(cls, path) -> "ForestModel":
        """Read the ``.npz`` written by glia_tpu's ForestModel.save (or by
        ``save``, which adds the training width when the forest has one)."""
        with np.load(path) as z:
            return cls.from_arrays(
                z["feature"], z["threshold"], z["left"], z["right"],
                z["leaf_class"], int(z["n_classes"]), int(z["max_depth"]),
                z["classes"],
                int(z["n_features"]) if "n_features" in z else None)

    def save(self, path):
        width = {} if self.n_features is None else {
            "n_features": self.n_features}
        np.savez_compressed(
            path, feature=self.feature, threshold=self.threshold,
            left=self.left, right=self.right, leaf_class=self.leaf_class,
            n_classes=self.n_classes, max_depth=self.max_depth,
            classes=self.classes, **width)


def check_width(n_features: Optional[int], max_feature: int, D: int):
    """Refuse samples of ``D`` features for a forest trained on
    ``n_features`` (when known) or splitting on feature ``max_feature``:
    a forest scores only the columns it was trained on, in their places."""
    if n_features is not None and n_features != D:
        raise ValueError(f"forest was trained on {n_features} features but "
                         f"the samples have {D}")
    if max_feature >= D:
        raise ValueError(f"forest splits on feature {max_feature} but the "
                         f"samples have {D} features")


def predict_votes_np(model: ForestModel, X) -> np.ndarray:
    """Host reference evaluation: vote fraction per class [B, n_classes].

    Standard Breiman descent: go left iff x[bestvar] <= split
    (classForest semantics)."""
    X = np.asarray(X, dtype=np.float64)
    B = X.shape[0]
    T = model.n_trees
    votes = np.zeros((B, model.n_classes), dtype=np.float64)
    for t in range(T):
        node = np.zeros(B, dtype=np.int64)
        for _ in range(model.max_depth + 1):
            f = model.feature[t, node]
            leaf = f < 0
            if leaf.all():
                break
            fv = X[np.arange(B), np.maximum(f, 0)]
            go_left = fv <= model.threshold[t, node]
            nxt = np.where(go_left, model.left[t, node],
                           model.right[t, node])
            node = np.where(leaf, node, nxt)
        cls = model.leaf_class[t, node]
        votes[np.arange(B), cls] += 1.0
    return votes / T


def pack_nodes(model: ForestModel):
    """The forest as one 16-byte record per real node, trees back to back.

    Record = int32 ``[feature, threshold bits, left, right]``; a leaf holds
    ``feature = -1`` and its class in the ``left`` field.  The real nodes of
    a tree are its root, its split nodes and their children; they must be a
    prefix of the tree's N slots (the padding comes last), or this raises.
    Child indices stay tree-local.  Returns (packed int32 [total, 4],
    tree_start int64 [T + 1], n_real int64 [T]): tree ``t`` owns records
    ``tree_start[t] : tree_start[t + 1]``."""
    feat = model.feature
    T, N = feat.shape
    inner = feat >= 0
    real = inner.copy()
    real[:, 0] = True
    t, n = np.nonzero(inner)
    real[t, model.left[t, n]] = True
    real[t, model.right[t, n]] = True
    n_real = N - np.argmax(real[:, ::-1], axis=1).astype(np.int64)
    prefix = np.arange(N)[None, :] < n_real[:, None]
    gaps = (prefix & ~real).any(axis=1)
    if gaps.any():
        bad = int(np.nonzero(gaps)[0][0])
        raise ValueError(
            f"tree {bad}: the real nodes (root, splits and their children) "
            f"are not a prefix of its {N} slots; padding must come last")
    rec = np.zeros((T, N, 4), np.int32)
    rec[..., 0] = np.where(inner, feat, -1)
    rec[..., 1] = np.where(inner, model.threshold.view(np.int32), 0)
    rec[..., 2] = np.where(inner, model.left, model.leaf_class)
    rec[..., 3] = np.where(inner, model.right, 0)
    tree_start = np.concatenate([[0], np.cumsum(n_real)])
    if tree_start[-1] >= 2 ** 31:
        raise ValueError("forest has 2**31 or more real nodes")
    return np.ascontiguousarray(rec[prefix]), tree_start, n_real


@dataclass
class ForestTables:
    """A forest's node tables on one device.  Uploaded once per model and
    passed to every call (the contract of glia_tpu's
    ``make_label_scorer(embed=True)``).

    Two forms of the same forest: the flat arrays [T * N], node ``n`` of
    tree ``t`` at ``t * N + n``, which the plain walk gathers from; and the
    packed records of ``pack_nodes``, which the CUDA kernel loads 16 bytes
    at a time."""

    feature: torch.Tensor     # int32
    threshold: torch.Tensor   # float32
    left: torch.Tensor        # int32
    right: torch.Tensor       # int32
    leaf_class: torch.Tensor  # int32
    packed: torch.Tensor      # int32 [total real nodes, 4]
    tree_start: torch.Tensor  # int32 [T + 1]
    n_real: np.ndarray        # int64 [T], on the host (launch planning)
    n_trees: int
    n_nodes: int
    n_classes: int
    max_depth: int
    max_feature: int          # largest split feature index (-1: no splits)
    n_features: Optional[int]  # training width (None: not known)
    # block geometries of the CUDA kernel, by (D, shared-memory limit)
    plans: dict = field(default_factory=dict)

    @classmethod
    def from_model(cls, model: ForestModel, device) -> "ForestTables":
        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                                   dtype=dtype, device=device)

        packed, tree_start, n_real = pack_nodes(model)
        return cls(
            feature=up(model.feature, torch.int32),
            threshold=up(model.threshold, torch.float32),
            left=up(model.left, torch.int32),
            right=up(model.right, torch.int32),
            leaf_class=up(model.leaf_class, torch.int32),
            packed=torch.as_tensor(packed, device=device),
            tree_start=up(tree_start, torch.int32), n_real=n_real,
            n_trees=model.n_trees, n_nodes=model.feature.shape[1],
            n_classes=int(model.n_classes), max_depth=int(model.max_depth),
            max_feature=int(model.feature.max(initial=-1)),
            n_features=model.n_features)


def check_features(tables: ForestTables, D: int):
    check_width(tables.n_features, tables.max_feature, D)


def forest_leaves_torch(X: torch.Tensor, tables: ForestTables) -> torch.Tensor:
    """Plain PyTorch forest walk: the node each (sample, tree) walk ends
    on, as flat indices [B, T] into the tables.

    Lock-step gather walk over [B, T] node indices for ``max_depth + 1``
    levels, a node that is a leaf staying put (the counterpart of
    glia_tpu's forest_votes_jax_fn)."""
    X = X.to(torch.float32)
    B, D = X.shape
    check_features(tables, D)
    T, N = tables.n_trees, tables.n_nodes
    dev = X.device
    Xf = X.reshape(-1)
    feat = tables.feature.long()
    left = tables.left.long()
    right = tables.right.long()
    tree_base = torch.arange(T, device=dev)[None, :] * N       # [1, T]
    row_base = (torch.arange(B, device=dev) * D)[:, None]      # [B, 1]
    node = torch.zeros((B, T), dtype=torch.long, device=dev)
    for _ in range(tables.max_depth + 1):
        flat = tree_base + node
        f = feat[flat]
        fv = Xf[row_base + f.clamp(min=0)]
        nxt = torch.where(fv <= tables.threshold[flat], left[flat],
                          right[flat])
        node = torch.where(f < 0, node, nxt)
    return tree_base + node


def forest_leaves_packed_torch(X: torch.Tensor,
                               tables: ForestTables) -> torch.Tensor:
    """The walk of ``forest_leaves_torch`` over the packed records, step
    for step what the CUDA kernel does: one record per step, a negative
    feature ends the walk.  Returns the same flat indices [B, T]
    (``t * N + n``) into the flat tables."""
    X = X.to(torch.float32)
    B, D = X.shape
    check_features(tables, D)
    T, N = tables.n_trees, tables.n_nodes
    dev = X.device
    rec = tables.packed.long()
    thr = tables.packed[:, 1].contiguous().view(torch.float32)
    start = tables.tree_start[:T].long()[None, :]               # [1, T]
    rows = torch.arange(B, device=dev)[:, None]
    node = torch.zeros((B, T), dtype=torch.long, device=dev)
    for _ in range(tables.max_depth + 1):
        at = start + node
        f = rec[at, 0]
        fv = X[rows, f.clamp(min=0)]
        nxt = torch.where(fv <= thr[at], rec[at, 2], rec[at, 3])
        node = torch.where(f < 0, node, nxt)
    return torch.arange(T, device=dev)[None, :] * N + node


def forest_votes_torch(X: torch.Tensor, tables: ForestTables) -> torch.Tensor:
    """Plain PyTorch forest walk: vote fractions [B, C] float32.  The CPU
    path and the yardstick the CUDA kernel is held against."""
    cls = tables.leaf_class[forest_leaves_torch(X, tables)]    # [B, T]
    classes = torch.arange(tables.n_classes, dtype=cls.dtype,
                           device=cls.device)
    votes = (cls[..., None] == classes).sum(dim=1).to(torch.float32)
    return votes * inv_trees(tables.n_trees, cls.device)


def inv_trees(T: int, device) -> torch.Tensor:
    """fl32(1 / T) as a float32 scalar tensor.  Vote fractions are
    ``count * fl32(1/T)``: that is what glia_tpu's walk computes for
    ``votes / T`` (XLA rewrites a division by a constant as a
    multiplication by its reciprocal), and it differs from the correctly
    rounded ``count / T`` in the last bit for some counts."""
    return torch.tensor(np.float32(1.0) / np.float32(T), device=device)


def forest_votes(X: torch.Tensor, tables: ForestTables) -> torch.Tensor:
    """Vote fractions [B, C]: the CUDA kernel for a CUDA tensor, the plain
    walk for a CPU tensor."""
    if X.device.type == "cuda":
        from ..ops.cuda import forest_votes_cuda

        return forest_votes_cuda(X.to(torch.float32).contiguous(), tables)
    if X.device.type == "cpu":
        return forest_votes_torch(X, tables)
    raise ValueError(f"no forest walk for device {X.device}")


def make_label_scorer(model: ForestModel, label=-1,
                      device: DeviceLike = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Vote-fraction scorer for one label (Model::predict semantics,
    rf.hxx:362-372): fn(X [B, D]) -> fraction [B] float32.  The node
    tables go to ``device`` (the CUDA card by default) once, here."""
    dev = resolve_device(device)
    li = int(np.nonzero(model.classes == label)[0][0])
    tables = ForestTables.from_model(model, dev)

    def score(X: torch.Tensor) -> torch.Tensor:
        return forest_votes(X, tables)[:, li]

    return score


def predict_label_fraction(model: ForestModel, X, label=1, backend="np",
                           device: DeviceLike = None) -> np.ndarray:
    """Vote fraction for one label: Model::predict semantics
    (rf.hxx:362-372).  ``label`` is an original class label.

    backend="np" is the host walk in float64 (``predict_votes_np``,
    votes / T); backend="device" is the device walk in float32
    (``forest_votes``: the CUDA kernel on the card, the plain walk on the
    CPU; count * fl32(1/T)) on ``device``, the CUDA card by default.
    Returns a numpy array [B]."""
    li = int(np.nonzero(model.classes == label)[0][0])
    if backend == "np":
        return predict_votes_np(model, X)[:, li]
    if backend != "device":
        raise ValueError(f"forest backend {backend!r} (np|device)")
    dev = resolve_device(device)
    tables = ForestTables.from_model(model, dev)
    Xd = torch.as_tensor(np.asarray(X), device=dev).to(torch.float32)
    return forest_votes(Xd, tables)[:, li].cpu().numpy()


def bootstrap_draws(y, n_trees, sample_ratio=0.7, balance_classes=True,
                    seed=0):
    """Each tree's bootstrap counts and feature-stream seed, drawn as
    sklearn's RandomForestClassifier(bootstrap=True, max_samples=
    sample_ratio, class_weight="balanced" or None, random_state=seed)
    draws them.

    Tree seeds come one per tree from RandomState(seed).randint(2**31 - 1).
    Tree t draws ``n_bs`` row indices with replacement from
    RandomState(seed_t): uniformly, n_bs = max(int(sample_ratio * n), 1),
    or, balanced, with probabilities proportional to the class weights
    ``w = n / (k * bincount(y))`` of each row's class, n_bs =
    max(int(sample_ratio * w.sum()), 1).  The counts of the draw are the
    tree's sample weights.  Its feature stream starts from
    RandomState(seed_t).randint(0, 2**31 - 1).  Returns (classes,
    class index of each row, counts int32 [n_trees, n], seeds uint32
    [n_trees])."""
    y = np.asarray(y).astype(np.int64)
    n = len(y)
    classes, y_idx = np.unique(y, return_inverse=True)
    if balance_classes:
        class_counts = np.bincount(y_idx, weights=np.ones(n))
        recip = np.sum(class_counts) / (len(classes) * class_counts)
        w = recip[y_idx]
        p = w / np.sum(w)
        n_bs = max(int(sample_ratio * w.sum()), 1)
    else:
        n_bs = max(int(sample_ratio * n), 1)
    top = np.iinfo(np.int32).max
    rs = np.random.RandomState(seed)
    tree_seeds = [rs.randint(top) for _ in range(n_trees)]
    counts = np.empty((n_trees, n), np.int32)
    seeds = np.empty(n_trees, np.uint32)
    for t, s in enumerate(tree_seeds):
        draw = np.random.RandomState(s)
        idx = (draw.choice(n, n_bs, replace=True, p=p) if balance_classes
               else draw.randint(0, n, n_bs))
        counts[t] = np.bincount(idx, minlength=n)
        seeds[t] = np.random.RandomState(s).randint(0, top)
    return classes, y_idx, counts, seeds


def train_forest(X, y, n_trees=255, mtry=None, sample_ratio=0.7,
                 balance_classes=True, seed=0, max_depth=None,
                 n_jobs=1) -> ForestModel:
    """Host CART training with reference defaults
    (main_train_rf.cxx:18-70: nTree=255, mtry=sqrt(D), sampsize=0.7,
    class-balancing weights), without sklearn.

    The forest glia_tpu's train_forest gets from sklearn's
    RandomForestClassifier with these arguments: the same per-tree
    bootstrap draws (``bootstrap_draws``), trees grown to purity on them by
    ``native/src/glia_forest.cc`` (Gini, best split over ``mtry`` drawn
    features, default ``int(sqrt(D))``), packed into ForestModel's [T, N]
    arrays as ForestModel.from_sklearn packs sklearn's trees (padded to the
    largest tree, ``max_depth`` the deepest tree's depth).  ``n_jobs``
    trees grow at once on threads (-1 or None: every core); the forest does
    not depend on it.  Features must be finite."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2 or len(X) != len(y) or len(X) == 0:
        raise ValueError(f"X must be [n, D] with n = len(y) > 0; got "
                         f"{X.shape} and {len(y)} labels")
    with np.errstate(over="ignore"):
        X32 = np.ascontiguousarray(X, dtype=np.float32)
    if not np.isfinite(X32).all():
        raise ValueError("forest training features must be finite in "
                         "float32")
    D = X.shape[1]
    mtry = max(1, int(np.sqrt(D))) if mtry is None else int(mtry)
    if mtry < 1:
        raise ValueError(f"mtry {mtry} < 1")
    if max_depth is not None and max_depth < 1:
        raise ValueError(f"max_depth {max_depth} < 1")
    if n_jobs is None or n_jobs < 0:
        n_jobs = os.cpu_count() or 1
    classes, y_idx, counts, seeds = bootstrap_draws(
        y, n_trees, sample_ratio, balance_classes, seed)
    trees, depth = forest_train_native(X32, y_idx, len(classes), counts,
                                       seeds, mtry, max_depth, n_jobs)
    N = max(len(t[0]) for t in trees)
    feature = np.full((n_trees, N), -1, np.int32)
    threshold = np.zeros((n_trees, N), np.float32)
    left, right, leaf_class = (np.zeros((n_trees, N), np.int32)
                               for _ in range(3))
    for i, t in enumerate(trees):
        c = len(t[0])
        for a, v in zip((feature, threshold, left, right, leaf_class), t):
            a[i, :c] = v
    return ForestModel(feature=feature, threshold=threshold, left=left,
                       right=right, leaf_class=leaf_class,
                       n_classes=len(classes), max_depth=int(depth.max()),
                       classes=classes, n_features=D)
