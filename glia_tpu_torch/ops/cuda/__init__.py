"""Hand-written CUDA kernels for Hopper: build, bind and launch.

Each ``.cu`` file here has a plain C entry point.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``.build/glia_tpu_torch/`` the first time it is needed, and called through
ctypes on PyTorch's current stream.  Nothing is compiled or loaded when the
module is imported, so the package imports on machines without CUDA.

Every wrapper takes CUDA tensors only and raises on anything else; a
failed build or launch raises too.  ``launches`` counts each kernel's
launches (and only those), so a run can show which kernels its main path
went through; ``bytes_moved`` counts the bytes those launches must move
at the least, from the shapes the wrapper holds (B2: the ids and the
values once each, and the output rows its ids can reach, an upper bound
on the segments they keep; B1: the samples once, 16 bytes a real inner
node, 8 a real leaf, the output once), and ``utils.profiling.count``
adds them to the open root span as ``<kernel>.bytes``.  A call made while a CUDA graph captures launches
nothing then: it counts into the tally of ``graph_launch_tally``, and the
graph adds that tally, bytes included, at each replay
(``count_graph_replay``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..._build import SharedLibBuild
from ...models.forest import ForestTables, check_features
from ...utils import profiling

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"forest_votes": os.path.join(_HERE, "forest_votes.cu"),
           "segment_sum": os.path.join(_HERE, "segment_sum.cu")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_CLASSES = 8
FOREST_THREADS = 1024
# bytes of a block's shared-memory limit kept back for the forest kernel's
# statically declared shared variables
FOREST_STATIC_SMEM = 64

launches: Dict[str, int] = {name: 0 for name in SOURCES}
bytes_moved: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# the tallies of the CUDA graphs being captured, innermost last
_graph_tallies: list = []


def reset_launches():
    for name in launches:
        launches[name] = 0
        bytes_moved[name] = 0


class LaunchTally(dict):
    """Launches per kernel of one replay of a captured graph, with the
    bytes they move per kernel in ``nbytes``."""

    def __init__(self):
        super().__init__((name, 0) for name in SOURCES)
        self.nbytes = {name: 0 for name in SOURCES}


@contextlib.contextmanager
def graph_launch_tally():
    """Collect, per kernel, the launches (and their bytes) that a CUDA
    graph captured in this block will make at each replay.  A captured
    call runs nothing until the graph replays, so it counts here and not
    in ``launches``; the graph's owner passes the tally to
    ``count_graph_replay`` after every replay.  A capture outside such a
    block counts nowhere."""
    tally = LaunchTally()
    _graph_tallies.append(tally)
    try:
        yield tally
    finally:
        _graph_tallies.pop()


def count_graph_replay(tally: LaunchTally):
    """Add the launches of one replay of a graph to ``launches``, and
    their bytes to ``bytes_moved``."""
    for name, n in tally.items():
        launches[name] += n
    for name, nbytes in tally.nbytes.items():
        if nbytes:
            _count_bytes(name, nbytes)


def _count_bytes(name: str, nbytes: int):
    bytes_moved[name] += nbytes
    profiling.count(name + ".bytes", nbytes)


def _count_launch(name: str, nbytes: int = 0):
    if torch.cuda.is_current_stream_capturing():
        if _graph_tallies:
            _graph_tallies[-1][name] += 1
            _graph_tallies[-1].nbytes[name] += nbytes
    else:
        launches[name] += 1
        if nbytes:
            _count_bytes(name, nbytes)


def forest_bytes(tables: ForestTables, B: int, D: int) -> int:
    """Bytes a B1 launch on ``B`` samples of ``D`` float32 features must
    move: the samples once, 16 bytes a real inner node, 8 a real leaf,
    the float32 output once."""
    n_leaves = int(tables.n_real.sum()) - tables.n_inner
    return (4 * B * D + 16 * tables.n_inner + 8 * n_leaves
            + 4 * B * tables.n_classes)


def segment_sum_bytes(B: int, F: int, S: int, itemsize: int,
                      kept: Optional[int] = None) -> int:
    """Bytes a B2 launch of ``B`` rows of ``F`` values into ``S`` segments
    must move at most: the int64 ids once, the values of the ``kept``
    rows (ids in [0, S); all ``B`` when not known, as a launch knows it
    only from a device read) once, and the output rows they can reach
    once, min(kept, S) of them (the output's zeroing is a fill of its
    own, not the kernel's work)."""
    kept = B if kept is None else kept
    return 8 * B + (kept + min(kept, S)) * F * itemsize


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) -- the CUDA kernels cannot be built")
    return path


def kernel_build(name: str) -> SharedLibBuild:
    return SharedLibBuild(name, [SOURCES[name]], [_nvcc(), *NVCC_FLAGS])


def _bind(name: str, lib: ctypes.CDLL):
    """Declare the C entry points of library ``name``: every one returns
    the CUDA error of its call (0: none)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "forest_votes":
        entries = {"glia_forest_votes":
                   [p, i, i, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p],
                   "glia_forest_votes_limits": [p, p]}
    else:
        args = [p, p, ll, i, ll, i, p, p]
        entries = {"glia_segment_sum": args, "glia_segment_sum_sorted": args}
    for fn_name, argtypes in entries.items():
        fn = getattr(lib, fn_name)
        fn.restype = i
        fn.argtypes = argtypes


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        with _lock:
            if name not in _libs:
                lib = ctypes.CDLL(kernel_build(name).wait())
                _bind(name, lib)
                _libs[name] = lib
    return _libs[name]


def _check(t: torch.Tensor, what: str, dtype, device, numel=None):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what} has {t.numel()} elements, expected {numel}")


def _call(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream; the device is
    made current only when it is not already."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


# ---------------------------------------------------------------------------
# forest vote walk
# ---------------------------------------------------------------------------

def forest_launch_plan(n_real: np.ndarray, D: int, smem_limit: int) -> dict:
    """Block geometry of ``forest_votes.cu`` for a forest whose trees have
    ``n_real`` real nodes and samples of ``D`` features, on a device whose
    blocks may use ``smem_limit`` bytes of shared memory.

    A block of 1024 threads takes ``TS = 2**ts_log2`` samples and
    ``1024 / TS`` tree lanes.  Its shared memory holds the vote counts
    (TS * 8 words), ``tree_start`` (T + 1 words, rounded up to 4), the
    tile's rows of X at an odd stride of ``x_stride`` words, and two
    buffers of ``buf_nodes`` 16-byte records (``FOREST_STATIC_SMEM`` bytes
    of the limit stay free for the kernel's static variables).  The trees
    are staged ``G`` consecutive trees at a time, and G is the largest count
    (a multiple of the tree lanes where one fits) whose every group fits a
    buffer.  The largest TS from 256 down to 32 whose buffers hold a stage
    for every tree lane is taken, else the largest that holds one tree;
    when not even TS = 32 does (``smem_limit`` 0 asks for that), ``staged``
    is False and the kernel walks global memory."""
    n_real = np.asarray(n_real, np.int64)
    T = len(n_real)
    start = np.concatenate([[0], np.cumsum(n_real)])
    tree_words = (T + 1 + 3) // 4 * 4
    x_stride = D | 1
    best = None
    for ts_log2 in (8, 7, 6, 5):
        TS = 1 << ts_log2
        TL = FOREST_THREADS // TS
        fixed = 4 * (TS * MAX_CLASSES + tree_words + TS * x_stride)
        buf_nodes = (smem_limit - FOREST_STATIC_SMEM - fixed) // 32
        if buf_nodes < n_real.max():
            continue
        G = _largest_group(start, T, TL, buf_nodes)
        plan = dict(staged=True, ts_log2=ts_log2, x_stride=x_stride, G=G,
                    buf_nodes=int(buf_nodes))
        if G >= TL:
            return plan
        if best is None:
            best = plan
    if best is None:
        best = dict(staged=False, ts_log2=8, x_stride=D,
                    G=FOREST_THREADS >> 8, buf_nodes=0)
    return best


def forest_splits(plan: dict, T: int, B: int, n_sm: int) -> int:
    """How many blocks share a sample tile's stages (``blockIdx.y``): as
    many as make one wave of blocks over ``n_sm`` SMs, so that a small
    batch also fills the card; one when the tiles alone fill it."""
    tiles = -(-B // (1 << plan["ts_log2"]))
    n_stages = -(-T // plan["G"])
    return max(1, min(n_stages, n_sm // tiles))


def _largest_group(start, T, TL, buf_nodes) -> int:
    """Largest G such that every group of G consecutive trees (from tree
    0) has at most ``buf_nodes`` records; multiples of ``TL`` first."""
    def fits(G):
        edges = np.minimum(np.arange(0, T + G, G), T)
        return int(np.diff(start[edges]).max(initial=0)) <= buf_nodes

    top = -(-T // TL) * TL
    for G in list(range(top, 0, -TL)) + list(range(TL - 1, 0, -1)):
        if fits(G):
            return G
    raise ValueError("no tree fits the buffer")


_limits: Dict[int, tuple] = {}


def device_limits(device: torch.device) -> tuple:
    """(SM count, bytes of shared memory a block may ask for) of
    ``device``, read once."""
    key = device.index if device.index is not None else -1
    if key not in _limits:
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _lib("forest_votes").glia_forest_votes_limits(
                ctypes.byref(n_sm), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"reading the device's limits failed: CUDA "
                               f"error {rc}")
        _limits[key] = (n_sm.value, smem.value)
    return _limits[key]


def forest_plan_on(tables: ForestTables, B: int, D: int,
                   device: torch.device, global_memory: bool = False) -> dict:
    """The launch plan ``forest_votes_cuda`` uses for ``B`` samples of
    ``D`` features on ``device``: the block geometry (made once per D and
    kept in ``tables.plans``) and ``n_splits`` for this batch."""
    n_sm, smem_limit = device_limits(device)
    key = (D, 0 if global_memory else smem_limit)
    geometry = tables.plans.get(key)
    if geometry is None:
        geometry = tables.plans[key] = forest_launch_plan(tables.n_real, *key)
    return dict(geometry, n_splits=forest_splits(geometry, tables.n_trees,
                                                 B, n_sm))


def forest_votes_cuda(X: torch.Tensor, tables: ForestTables,
                      global_memory: bool = False) -> torch.Tensor:
    """Forest vote fractions [B, C] float32 by the CUDA kernel
    ``forest_votes.cu``.  X: float32 [B, D] contiguous on a CUDA device;
    ``tables``: the forest's node tables on the same device.
    ``global_memory=True`` takes the instantiation that walks global
    memory, which a forest too large for shared memory takes by itself
    (same result; for checks)."""
    if X.device.type != "cuda":
        raise ValueError(f"forest_votes_cuda takes CUDA tensors, got X on "
                         f"{X.device}")
    if X.ndim != 2:
        raise ValueError(f"X must be [B, D], got shape {tuple(X.shape)}")
    _check(X, "X", torch.float32, X.device)
    B, D = X.shape
    T, N, C = tables.n_trees, tables.n_nodes, tables.n_classes
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"forest_votes_cuda supports 1..{MAX_CLASSES} "
                         f"classes, got {C}")
    if T < 1 or D < 1:
        raise ValueError(f"forest_votes_cuda needs at least one tree and "
                         f"one feature, got T = {T}, D = {D}")
    check_features(tables, D)
    _check(tables.leaf_class, "tables.leaf_class", torch.int32, X.device,
           T * N)
    _check(tables.tree_start, "tables.tree_start", torch.int32, X.device,
           T + 1)
    _check(tables.packed, "tables.packed", torch.int32, X.device,
           4 * int(tables.n_real.sum()))
    out = torch.empty((B, C), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    lib = _lib("forest_votes")
    plan = forest_plan_on(tables, B, D, X.device, global_memory)
    tiles = -(-B // (1 << plan["ts_log2"]))
    scratch = torch.zeros(B * C + tiles, dtype=torch.int32, device=X.device)
    rc = _call(X.device, lib.glia_forest_votes, X.data_ptr(), B, D,
               tables.packed.data_ptr(), tables.tree_start.data_ptr(),
               tables.leaf_class.data_ptr(), T, N, C, tables.max_depth + 1,
               int(plan["staged"]), plan["ts_log2"], plan["x_stride"],
               plan["G"], plan["buf_nodes"], plan["n_splits"],
               scratch.data_ptr(), out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"forest_votes kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    _count_launch("forest_votes", forest_bytes(tables, B, D))
    return out


# ---------------------------------------------------------------------------
# segment sum
# ---------------------------------------------------------------------------

def segment_sum_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                     n_segments: int, sorted: bool = False) -> torch.Tensor:
    """Segment sum by the CUDA kernel ``segment_sum.cu``: values [B, F] or
    [B] (float32 or float64), seg_ids int64 [B], both contiguous on one
    CUDA device -> [S, F] or [S].  Rows whose id is negative or
    >= n_segments are dropped.  ``sorted=True`` states that the ids are
    non-decreasing and selects the entry point without atomics (same bits
    on every launch); it is not verified on the card."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_cuda takes CUDA tensors, got values "
                         f"on {dev}")
    if values.ndim not in (1, 2):
        raise ValueError(f"values must be [B] or [B, F], got shape "
                         f"{tuple(values.shape)}")
    dtype = values.dtype
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise ValueError(f"values has dtype {dtype}, expected "
                         f"float32 or float64")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    B = values.shape[0]
    F = values.shape[1] if values.ndim == 2 else 1
    S = int(n_segments)
    if S < 0:
        raise ValueError(f"n_segments must be >= 0, got {S}")
    if seg_ids.ndim != 1:
        raise ValueError(f"seg_ids must be [B], got shape "
                         f"{tuple(seg_ids.shape)}")
    _check(seg_ids, "seg_ids", torch.int64, dev, B)
    out = torch.zeros((S,) + values.shape[1:], dtype=dtype, device=dev)
    if B == 0 or S == 0 or F == 0:
        return out
    fns = _segment_fns or _load_segment_fns()
    rc = _call(dev, fns[bool(sorted)], values.data_ptr(), seg_ids.data_ptr(),
               B, F, S, int(dtype is torch.float64), out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launch("segment_sum",
                  segment_sum_bytes(B, F, S, values.element_size()))
    return out


# the two entry points of segment_sum.cu, [atomic, sorted], looked up once
_segment_fns: list = []


def _load_segment_fns() -> list:
    lib = _lib("segment_sum")
    _segment_fns[:] = [lib.glia_segment_sum, lib.glia_segment_sum_sorted]
    return _segment_fns
