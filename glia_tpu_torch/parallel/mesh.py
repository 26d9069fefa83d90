"""A 1-D mesh of ranks over torch.distributed (counterpart of
glia_tpu.parallel.mesh).

glia_tpu runs one SPMD program over a jax.sharding.Mesh with one axis,
``EDGE_AXIS``: RAG edges are partitioned across devices, and region
results are reduced into per-device blocks of the same axis.  The port
runs one process per rank instead, each holding a ``Mesh``: its process
group, rank, world size, device and backend, and the collectives the
JAX code uses along the axis.

Every rank calls a sharded function with the same full host inputs; the
function takes the rank's block (``Mesh.shard``, what ``P(EDGE_AXIS)``
gives a device inside ``shard_map``) and returns the same full result on
every rank (``Mesh.all_gather`` for what JAX returns edge-sharded).

Backends: ``nccl`` keeps tensors on the card; ``gloo`` reduces on the
host, so a CUDA tensor goes through an explicit host copy inside the
collective, counted in ``stats["host_staged_bytes"]`` (both directions).
The backend is the process group's, chosen by whoever initialized it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

EDGE_AXIS = "edge"


class Mesh:
    """One rank's view of the 1-D mesh along ``EDGE_AXIS``.

    Collectives take and return tensors on ``device``; each one is a
    blocking call that every rank of the group must make in the same
    order."""

    def __init__(self, group, rank: int, world: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        self.stats = {"host_staged_bytes": 0}

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")

    # -- blocks --------------------------------------------------------------
    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x`` along axis 0 (what a device holds of
        an array sharded ``P(EDGE_AXIS)``); axis 0 must divide evenly."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"axis 0 of length {n} does not split over "
                             f"{self.world} ranks")
        b = n // self.world
        return x[self.rank * b:(self.rank + 1) * b]

    # -- staging for the host backend ---------------------------------------
    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            self.stats["host_staged_bytes"] += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _from_wire(self, x: torch.Tensor, like: torch.Tensor):
        if x.device != like.device:
            self.stats["host_staged_bytes"] += x.numel() * x.element_size()
            return x.to(like.device)
        return x

    # -- collectives ----------------------------------------------------------
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [world, ...]: slab s goes to rank s; returns [world, ...] whose
        slab s came from rank s (``lax.all_to_all``, split and concat on
        axis 0, not tiled)."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs [{self.world}, ...], got "
                             f"{tuple(x.shape)}")
        wire = self._to_wire(x)
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        return self._from_wire(out, x)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, each keeping its block of axis 0
        (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"axis 0 of length {n} does not split over "
                             f"{self.world} ranks")
        wire = self._to_wire(x)
        out = wire.new_empty((n // self.world,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, wire, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return self._from_wire(out, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block, concatenated on axis 0
        (``lax.all_gather(..., axis=0, tiled=True)``)."""
        wire = self._to_wire(x)
        out = wire.new_empty((x.shape[0] * self.world,) + tuple(x.shape[1:]))
        # torch 2.13 warns that this name (and reduce_scatter_tensor) is
        # deprecated for *_single; older releases have only this one
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return self._from_wire(out, x)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if x.dtype == torch.bool:
            return self._all_reduce(x.to(torch.int32), op).to(torch.bool)
        wire = self._to_wire(x)
        if wire is x:
            wire = x.clone()
        dist.all_reduce(wire, op=op, group=self.group)
        return self._from_wire(wire, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of ``rank``: the CPU when asked for, else a CUDA card,
    ``cuda:{rank % device_count}`` unless ``device`` names an index.  A
    missing card raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(group=None, device: DeviceLike = None) -> Mesh:
    """The mesh of ``group`` (the initialized default group when None) on
    ``device`` (the CUDA card by default, as ``rank_device`` picks it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launch.spawn_ranks, or "
                           "torch.distributed.init_process_group)")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    dev = rank_device(device, rank)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not "
                             f"{dev}")
        torch.cuda.set_device(dev)
    return Mesh(group, rank, world, dev, backend)


def pad_to_multiple(arr, multiple, axis=0, fill=0):
    """Pad along axis so shape[axis] % multiple == 0; returns (padded,
    n_valid)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, constant_values=fill), n


def to_device(x, mesh: Mesh, dtype: Optional[torch.dtype] = None):
    """A host array (or tensor) as a tensor on the mesh's device: the
    port's ``jax.device_put`` of a full array."""
    t = x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=mesh.device, dtype=dtype)
