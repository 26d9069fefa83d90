"""Edge-partitioned RAG aggregation across the ranks of a mesh
(counterpart of glia_tpu.parallel.rag_shard).

The pattern, on every rank:

  1. segment-reduce the rank's edges into a full-width region
     accumulator [R_pad, F] (two segment sums in a fixed order,
     ``incident_sums``: kernel B2's sorted entry on the card);
  2. one ``psum_scatter`` over the mesh both sums the partial
     accumulators and leaves each rank its own region block;
  3. region results needed back at the edges return through an
     ``all_gather`` of the region blocks (the dense halo; halo.py moves
     only the cut regions' rows).

Functions take the full arrays on every rank, work on the rank's block
and return the full result on every rank (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segment_csr import segment_order, segment_sum_ordered
from .mesh import Mesh, pad_to_multiple, to_device


def shard_edges(rag, pb_image, mesh: Mesh, max_pixels_per_edge=32):
    """Host-side prep: per-edge boundary-pixel values packed into a dense
    [E_pad, K] tensor (+mask), padded to a multiple of the world size.

    Returns a dict of tensors on the mesh's device: u, v (int64 [E_pad]),
    px ([E_pad, K]), px_mask ([E_pad, K]), edge_valid ([E_pad]), and
    n_edges, n_regions."""
    from ..ops.pack import pack_edge_pixels

    n_dev = mesh.world
    E = rag.n_edges
    u, v, px, mask = pack_edge_pixels(rag, pb_image, max_pixels_per_edge)
    u, _ = pad_to_multiple(u, n_dev)
    v, _ = pad_to_multiple(v, n_dev)
    px, _ = pad_to_multiple(px, n_dev)
    mask, _ = pad_to_multiple(mask, n_dev)
    valid = np.zeros(len(u), dtype=np.float32)
    valid[:E] = 1.0
    return {
        "u": to_device(u, mesh, torch.int64),
        "v": to_device(v, mesh, torch.int64),
        "px": to_device(px, mesh), "px_mask": to_device(mask, mesh),
        "edge_valid": to_device(valid, mesh),
        "n_edges": E, "n_regions": rag.n_regions,
    }


def incident_order(u: torch.Tensor, v: torch.Tensor):
    """The fixed order of ``incident_sums`` over the endpoints ``u``,
    ``v``: one ``segment_order`` each.  Computed once where the endpoints
    stay fixed (a batch of the train step, a call of a forward)."""
    return segment_order(u), segment_order(v)


def incident_sums(vals: torch.Tensor, order, n_segments: int) -> torch.Tensor:
    """Per-region sums of ``vals`` over incident edges, both endpoints
    (``order`` from ``incident_order``): two segment sums through B2's
    sorted entry on the card, each region's edges added in edge order, so
    two runs give the same bits."""
    ou, ov = order
    return (segment_sum_ordered(vals, ou, n_segments)
            + segment_sum_ordered(vals, ov, n_segments))


def edge_pixel_stats(px: torch.Tensor, px_mask: torch.Tensor):
    """Per-edge boundary stats from padded pixels: (mean, min, max,
    count), min and max 0 on an edge without pixels."""
    cnt = px_mask.sum(dim=1)
    s = (px * px_mask).sum(dim=1)
    mean = s / torch.clamp(cnt, min=1.0)
    inf = torch.tensor(float("inf"), dtype=px.dtype, device=px.device)
    mn = torch.where(px_mask > 0, px, inf).amin(dim=1)
    mn = torch.where(cnt > 0, mn, 0.0)
    mx = torch.where(px_mask > 0, px, -inf).amax(dim=1)
    mx = torch.where(cnt > 0, mx, 0.0)
    return mean, mn, mx, cnt


def make_region_aggregate(mesh: Mesh, n_regions_padded: int):
    """The SPMD edge->region aggregation.

    f(u, v, edge_vals [E_pad, F]) -> [R_pad, F]: per-region sums over
    incident edges, both endpoints; each rank sums its block of the edges
    and keeps its block of the regions, which are then gathered."""
    n_dev = mesh.world
    if n_regions_padded % n_dev:
        raise ValueError(f"{n_regions_padded} regions do not split over "
                         f"{n_dev} ranks")

    def agg(u, v, ev):
        order = incident_order(mesh.shard(u), mesh.shard(v))
        part = incident_sums(mesh.shard(ev), order, n_regions_padded)
        return mesh.all_gather(mesh.psum_scatter(part))

    return agg


def make_edge_scoring_step(mesh: Mesh, n_regions_padded: int,
                           mlp_dims=(8, 16, 8)):
    """The edge-scoring forward: boundary-pixel segment stats -> edge
    features -> region context by psum_scatter aggregation -> all_gather
    halo -> gathered back to the edges -> MLP2 merge probabilities.

    score(u, v, px, px_mask, edge_valid, w) -> [E_pad]."""
    from ..models.mlp import mlp2_forward

    D, N1, N2 = mlp_dims

    def score(u, v, px, px_mask, edge_valid, w):
        u, v = mesh.shard(u), mesh.shard(v)
        mean, mn, mx, cnt = edge_pixel_stats(mesh.shard(px),
                                             mesh.shard(px_mask))
        # edge messages -> region context (degree, sum-mean, min, max)
        msgs = torch.stack([torch.ones_like(mean), mean, mn, mx], dim=1)
        part = incident_sums(msgs * mesh.shard(edge_valid)[:, None],
                             incident_order(u, v), n_regions_padded)
        rfull = mesh.all_gather(mesh.psum_scatter(part))
        feats = torch.cat([torch.stack([mean, mn, mx, cnt], dim=1),
                           rfull[u][:, :2], rfull[v][:, :2]], dim=1)
        return mesh.all_gather(mlp2_forward(w, feats.to(torch.float32),
                                            D, N1, N2))

    return score
