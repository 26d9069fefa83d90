"""Legacy random-forest binary model IO (reference interchange format; the
port of glia_tpu.models.rf_legacy).

The reference's ``train_rf``/``pred_rf``/``merge_order_bc`` exchange models
via ``rf_old::writeModelToBinaryFile`` / ``readModelFromBinaryFile``
(reference: code/ml/rf/ml_rf_model.cxx:378-528, struct layout
code/ml/rf/ml_rf.h:97-269).  This module reads and writes that format so
forests trained by reference binaries load here (and vice versa), giving
the SURVEY §7 "train once with reference binaries, achieve inference
parity" path.

On-disk layout (x86-64 g++/libstdc++, the reference's only deployment):

1. a raw ``sizeof(Model)`` = 520-byte struct dump.  The four
   ``std::vector`` headers (begin/end/cap pointers) and the raw data
   pointers are writer heap addresses -- garbage on read except that
   vector *sizes* are recovered as (end-begin)/elt_size.  The format is
   only self-consistent when the uniques vectors are empty (no
   categorical features -- always true for GLIA's continuous features;
   a reference-written file with categorical features would crash the
   reference's own reader on heap pointers).  The meaningful blob fields
   are the ``n_*[2]`` dimension pairs and nrnodes/ntree/mtry/nclass.
2. payload arrays in fixed order, each with the sparse codec
   (ml_rf_model.cxx:6-71): arrays of size > 128 get a 1-byte flag;
   sparse (= nonzeros < size/2) stores int32 count + (int32 index,
   value) pairs of the NONZERO entries; otherwise raw little-endian.

Tree semantics (classForest of the Breiman/Liaw port): per tree t, node k
(0-based), ``treemap`` holds interleaved 1-based (left, right) child pairs
in a 2*nrnodes block; nodestatus == -1 marks terminals; descend left iff
x[bestvar-1] <= xbestsplit; terminal votes nodeclass (1-based index into
orig_labels).

Layout twist: the trainer TRANSPOSES the classForest buffers before
storing them in the Model (ml_rf_train.cxx:696-717), and the reader
transposes them back after reading (ml_rf_model.cxx:541-557).  The file
therefore holds, for each of {xbestsplit, classwt, cutoff, treemap,
nodestatus, nodeclass, bestvar, ndbigtree}, the row-major (n0, n1)
transpose of the raw layout; this module's ``raw`` dicts always hold the
RAW (classForest) layout and the (un)transpose happens at file IO.
"""

from __future__ import annotations

import struct

import numpy as np

from .forest import ForestModel

_MIN_SPARSE_SIZE = 128
_SIZEOF_MODEL = 520

# (name, dtype) of the dimension-pair fields in blob order; scalars
# interleaved per the struct layout below
_ARRAYS = [
    ("ncat", np.int32), ("categorical_feature", np.int32),
    ("xbestsplit", np.float64), ("classwt", np.float64),
    ("cutoff", np.float64), ("treemap", np.int32),
    ("nodestatus", np.int32), ("nodeclass", np.int32),
    ("bestvar", np.int32), ("ndbigtree", np.int32),
    ("orig_labels", np.int32), ("new_labels", np.int32),
    ("outcl", np.int32), ("outclts", np.int32), ("counttr", np.int32),
    ("proximity", np.float64), ("proximity_tst", np.float64),
    ("localImp", np.float64), ("importance", np.float64),
    ("importanceSD", np.float64), ("errtr", np.float64),
    ("errts", np.float64), ("inbag", np.int32), ("votes", np.int32),
    ("oob_times", np.int32),
]

# blob offsets of each n_<field>[2] dim pair (x86-64 g++ layout of
# rf_old::Model, ml_rf.h:97-155)
_DIM_OFFSETS = {
    "ncat": 104, "categorical_feature": 120,
    "xbestsplit": 144, "classwt": 160, "cutoff": 176, "treemap": 192,
    "nodestatus": 208, "nodeclass": 224, "bestvar": 240,
    "ndbigtree": 256, "orig_labels": 280, "new_labels": 296,
    "outcl": 320, "outclts": 336, "counttr": 352, "proximity": 368,
    "proximity_tst": 384, "localImp": 400, "importance": 416,
    "importanceSD": 432, "errtr": 448, "errts": 464, "inbag": 480,
    "votes": 496, "oob_times": 512,
}
_OFF_NRNODES = 128
_OFF_NTREE = 132
_OFF_MTRY = 264
_OFF_NCLASS = 304

# fields stored transposed on disk (ml_rf_model.cxx:541-557: file shape is
# the dim pair (n0, n1); raw classForest layout is its row-major transpose)
_TRANSPOSED = ("xbestsplit", "classwt", "cutoff", "treemap", "nodestatus",
               "nodeclass", "bestvar", "ndbigtree")


def _untranspose(arr, d0, d1):
    """File (d0, d1) row-major -> raw layout (the reader's transpose)."""
    return np.ascontiguousarray(arr.reshape(d0, d1).T).ravel()


def _retranspose(arr, d0, d1):
    """Raw layout -> file (d0, d1) row-major (the trainer's transpose)."""
    return np.ascontiguousarray(arr.reshape(d1, d0).T).ravel()


def _read_array(buf, pos, size, dtype):
    """Sparse codec reader (ml_rf_model.cxx:48-71)."""
    if size <= 0:
        return np.zeros(0, dtype=dtype), pos
    itemsize = np.dtype(dtype).itemsize
    if size > _MIN_SPARSE_SIZE:
        is_sparse = buf[pos] != 0
        pos += 1
        if is_sparse:
            (num,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            out = np.zeros(size, dtype=dtype)
            rec = np.dtype([("i", "<i4"), ("v", np.dtype(dtype).newbyteorder("<"))])
            # (int32 index, value) pairs are packed without padding
            raw = np.frombuffer(buf, dtype=np.uint8,
                                count=num * (4 + itemsize), offset=pos)
            pos += num * (4 + itemsize)
            pairs = raw.view(rec) if rec.itemsize == 4 + itemsize else None
            if pairs is None:  # alignment padding would break layout
                raise ValueError("unexpected record padding")
            out[pairs["i"]] = pairs["v"]
            return out, pos
    out = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"),
                        count=size, offset=pos).astype(dtype)
    pos += size * itemsize
    return out, pos


def _write_array(parts, arr):
    """Sparse codec writer (ml_rf_model.cxx:6-45)."""
    arr = np.ascontiguousarray(arr)
    size = arr.size
    if size <= 0:
        return
    if size > _MIN_SPARSE_SIZE:
        nz = np.nonzero(np.abs(arr.astype(np.float64)) > 1e-8)[0]
        is_sparse = len(nz) < size // 2
        parts.append(struct.pack("<?", is_sparse))
        if is_sparse:
            parts.append(struct.pack("<i", len(nz)))
            for i in nz:
                parts.append(struct.pack("<i", int(i)))
                parts.append(arr[i : i + 1].tobytes())
            return
    parts.append(arr.tobytes())


def read_legacy_model(path) -> dict:
    """Parse a reference-written model file into raw named arrays."""
    with open(path, "rb") as f:
        buf = f.read()
    # vector sizes = (end - begin) / elt_size from the blob's vector headers
    def vec_size(off, elt):
        begin, end = struct.unpack_from("<qq", buf, off)
        return (end - begin) // elt

    n_uniq = vec_size(0, 8)
    n_mapped = vec_size(48, 8)
    if n_uniq != 0 or n_mapped != 0:
        raise ValueError(
            "legacy model has categorical-feature uniques; such files are "
            "not round-trippable even by the reference reader "
            "(ml_rf_model.cxx:463-487 reads into writer heap pointers)")
    dims = {k: struct.unpack_from("<ii", buf, off)
            for k, off in _DIM_OFFSETS.items()}
    out = {
        "nrnodes": struct.unpack_from("<i", buf, _OFF_NRNODES)[0],
        "ntree": struct.unpack_from("<i", buf, _OFF_NTREE)[0],
        "mtry": struct.unpack_from("<i", buf, _OFF_MTRY)[0],
        "nclass": struct.unpack_from("<i", buf, _OFF_NCLASS)[0],
        "dims": dims,
    }
    pos = _SIZEOF_MODEL
    # payload order (ml_rf_model.cxx:384-448); uniques skipped (empty);
    # nrnodes/ntree and mtry/nclass scalars are re-stored inline
    for name, dtype in _ARRAYS:
        if name == "xbestsplit":
            nr, nt = struct.unpack_from("<ii", buf, pos)
            if nr != out["nrnodes"] or nt != out["ntree"]:
                raise ValueError(f"payload dims ({nr}, {nt}) differ from the "
                                 f"header's ({out['nrnodes']}, "
                                 f"{out['ntree']})")
            pos += 8
        elif name == "orig_labels":
            pos += 4  # mtry
        elif name == "outcl":
            pos += 4  # nclass
        d0, d1 = dims[name]
        arr, pos = _read_array(buf, pos, d0 * d1, dtype)
        if name in _TRANSPOSED and arr.size:
            arr = _untranspose(arr, d0, d1)
        out[name] = arr
    if pos != len(buf):
        raise ValueError(f"trailing bytes: read {pos} of {len(buf)}")
    return out


def write_legacy_model(path, raw: dict) -> None:
    """Write raw named arrays as a reference-readable model file."""
    blob = bytearray(_SIZEOF_MODEL)
    # empty std::vector headers = null pointers (offsets 0..95): already 0
    dims = raw["dims"]
    for k, off in _DIM_OFFSETS.items():
        struct.pack_into("<ii", blob, off, *dims[k])
    struct.pack_into("<i", blob, _OFF_NRNODES, raw["nrnodes"])
    struct.pack_into("<i", blob, _OFF_NTREE, raw["ntree"])
    struct.pack_into("<i", blob, _OFF_MTRY, raw["mtry"])
    struct.pack_into("<i", blob, _OFF_NCLASS, raw["nclass"])
    parts = [bytes(blob)]
    for name, dtype in _ARRAYS:
        if name == "xbestsplit":
            parts.append(struct.pack("<ii", raw["nrnodes"], raw["ntree"]))
        elif name == "orig_labels":
            parts.append(struct.pack("<i", raw["mtry"]))
        elif name == "outcl":
            parts.append(struct.pack("<i", raw["nclass"]))
        arr = np.asarray(raw.get(name, np.zeros(0, dtype)), dtype=dtype)
        d0, d1 = dims[name]
        if arr.size != d0 * d1:
            raise ValueError(f"{name}: {arr.size} values for dims "
                             f"{dims[name]}")
        if name in _TRANSPOSED and arr.size:
            arr = _retranspose(arr, d0, d1)
        _write_array(parts, arr)
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def legacy_to_forest(raw: dict) -> ForestModel:
    """Convert raw legacy arrays to the dense node-array ForestModel.

    classForest descent semantics (see module docstring); evaluation
    through ForestModel reproduces the reference's vote fractions.
    """
    nrnodes = int(raw["nrnodes"])
    T = int(raw["ntree"])
    treemap = np.asarray(raw["treemap"]).reshape(T, 2 * nrnodes)
    left1 = treemap[:, 0::2]   # interleaved (left, right) pairs per node
    right1 = treemap[:, 1::2]
    nodestatus = np.asarray(raw["nodestatus"]).reshape(T, nrnodes)
    bestvar1 = np.asarray(raw["bestvar"]).reshape(T, nrnodes)
    xbestsplit = np.asarray(raw["xbestsplit"]).reshape(T, nrnodes)
    nodeclass1 = np.asarray(raw["nodeclass"]).reshape(T, nrnodes)
    terminal = nodestatus == -1
    feature = np.where(terminal, -1, bestvar1 - 1).astype(np.int32)
    left = np.where(terminal, 0, np.maximum(left1 - 1, 0)).astype(np.int32)
    right = np.where(terminal, 0, np.maximum(right1 - 1, 0)).astype(np.int32)
    # unused padding slots (status 0) must also read as leaves
    feature[nodestatus == 0] = -1
    leaf_class = np.maximum(nodeclass1 - 1, 0).astype(np.int32)
    # depth per tree via frontier walk
    depth = 0
    for t in range(T):
        frontier = [0]
        d = 0
        while frontier:
            nxt = []
            for k in frontier:
                if not terminal[t, k] and nodestatus[t, k] != 0:
                    nxt.extend((int(left[t, k]), int(right[t, k])))
            if nxt:
                d += 1
            frontier = nxt
            if d > nrnodes:
                raise ValueError("cyclic treemap")
        depth = max(depth, d)
    classes = np.asarray(raw["orig_labels"], dtype=np.int64)
    return ForestModel(
        feature=feature, threshold=xbestsplit.astype(np.float32),
        left=left, right=right, leaf_class=leaf_class,
        n_classes=int(raw["nclass"]), max_depth=depth, classes=classes)


def forest_to_legacy(model: ForestModel, mtry: int = 0) -> dict:
    """Convert a ForestModel to raw legacy arrays (for write_legacy_model).

    Optional analytics arrays (proximity, importance, errtr, votes, ...)
    are written empty; the reference reader skips size-0 arrays
    (ml_rf_model.cxx readArray size<=0 branch).
    """
    T = model.n_trees
    nrnodes = model.feature.shape[1]
    C = model.n_classes
    is_leaf = model.feature < 0
    treemap = np.zeros((T, 2 * nrnodes), dtype=np.int32)
    treemap[:, 0::2] = np.where(is_leaf, 0, model.left + 1)
    treemap[:, 1::2] = np.where(is_leaf, 0, model.right + 1)
    nodestatus = np.where(is_leaf, -1, 1).astype(np.int32)
    # padding slots (unreachable) get status 0
    for t in range(T):
        reach = np.zeros(nrnodes, bool)
        frontier = [0]
        reach[0] = True
        while frontier:
            nxt = []
            for k in frontier:
                if not is_leaf[t, k]:
                    for c in (int(model.left[t, k]), int(model.right[t, k])):
                        if not reach[c]:
                            reach[c] = True
                            nxt.append(c)
            frontier = nxt
        nodestatus[t, ~reach] = 0
    ndbigtree = (nodestatus != 0).sum(axis=1).astype(np.int32)
    dims = {name: (0, 0) for name, _ in _ARRAYS}
    dims.update({
        "xbestsplit": (nrnodes, T), "treemap": (nrnodes, 2 * T),
        "nodestatus": (nrnodes, T), "nodeclass": (nrnodes, T),
        "bestvar": (nrnodes, T), "ndbigtree": (T, 1),
        "orig_labels": (1, C), "new_labels": (1, C),
        "classwt": (1, C), "cutoff": (1, C),
    })
    return {
        "nrnodes": nrnodes, "ntree": T,
        "mtry": int(mtry) if mtry else max(1, int(np.sqrt(
            max(model.feature.max() + 1, 1)))),
        "nclass": C, "dims": dims,
        "treemap": treemap.ravel(),
        "nodestatus": nodestatus.ravel(),
        # class votes only exist at terminals; 0 elsewhere like the trainer
        "nodeclass": np.where(nodestatus == -1, model.leaf_class + 1, 0
                              ).astype(np.int32).ravel(),
        "bestvar": np.where(is_leaf, 0, model.feature + 1
                            ).astype(np.int32).ravel(),
        # split values only at split nodes (sklearn leaves carry -2.0)
        "xbestsplit": np.where(nodestatus == 1, model.threshold, 0.0
                               ).astype(np.float64).ravel(),
        "ndbigtree": ndbigtree,
        "orig_labels": np.asarray(model.classes, dtype=np.int32),
        "new_labels": np.arange(1, C + 1, dtype=np.int32),
        "classwt": np.ones(C, dtype=np.float64),
        "cutoff": np.full(C, 1.0 / C, dtype=np.float64),
    }


def load_legacy_forest(path) -> ForestModel:
    """Read a reference-binary model file directly into a ForestModel."""
    return legacy_to_forest(read_legacy_model(path))


def save_legacy_forest(path, model: ForestModel, mtry: int = 0) -> None:
    """Write a ForestModel as a reference-readable binary model file."""
    write_legacy_model(path, forest_to_legacy(model, mtry))
