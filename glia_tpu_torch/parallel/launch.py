"""Start the ranks of a mesh on one host (the port's counterpart of XLA's
``--xla_force_host_platform_device_count``, which gives glia_tpu a mesh
of virtual CPU devices in one process).

``spawn_ranks`` starts ``world`` processes with the ``spawn`` method,
joins them into one process group through a ``FileStore`` in a private
temporary directory (no TCP port to collide with a neighbour's), builds
each rank's ``Mesh`` and calls ``fn(mesh, *args)`` in every rank.  It
returns the ranks' results in rank order, or kills every rank and raises
as soon as one fails or the timeout passes, so that a hang fails its
caller instead of holding it forever.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import DeviceLike
from .mesh import make_mesh


def _rank_main(fn, rank, world, backend, device, store_path, args, out_q):
    try:
        torch.set_num_threads(1)
        if backend == "gloo":
            # every rank of a spawn_ranks mesh lives on this host
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend,
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        out = fn(make_mesh(device=device), *args)
        dist.destroy_process_group()
        # pickled here, by value: the parent reads it after this rank ends
        out_q.put((rank, True, pickle.dumps(out)))
    except Exception:
        out_q.put((rank, False, traceback.format_exc()))


def _stop(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(timeout=30)


def spawn_ranks(fn: Callable, world: int, backend: str = "gloo",
                device: DeviceLike = None, args: Sequence = (),
                timeout_s: float = 600.0,
                rank_args: Optional[Sequence[Sequence]] = None) -> List[Any]:
    """Run ``fn(mesh, *args, *rank_args[rank])`` on ``world`` ranks;
    return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable.  Each rank's process is sent
    ``args`` and its own ``rank_args`` entry only, so a rank can take its
    block of a large input without the others' blocks.  ``device``: each
    rank's device as ``make_mesh`` resolves it (the CUDA card by default,
    ``"cpu"`` for the plain path).  Raises RuntimeError with the failing
    rank's traceback, or TimeoutError after ``timeout_s`` seconds; no
    rank outlives the call."""
    if rank_args is None:
        rank_args = [()] * world
    if len(rank_args) != world:
        raise ValueError(f"rank_args has {len(rank_args)} entries for "
                         f"{world} ranks")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    results: List[Any] = [None] * world
    with tempfile.TemporaryDirectory(prefix="glia_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, store,
                                   tuple(args) + tuple(rank_args[r]), out_q),
                             daemon=True)
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            done = 0
            while done < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn_ranks: {world - done} of {world} ranks did "
                        f"not finish within {timeout_s} s")
                try:
                    rank, ok, payload = out_q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawn_ranks: rank {dead[0]} died with exit "
                            f"code {procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(
                        f"spawn_ranks: rank {rank} of {world} failed:\n"
                        f"{payload}")
                results[rank] = pickle.loads(payload)
                done += 1
            for p in procs:
                p.join(timeout=60)
        finally:
            _stop(procs)
    return results
