"""Sharded boundary-classifier training step (counterpart of
glia_tpu.parallel.train).

Edge data (boundary pixel blocks, endpoints, labels) is partitioned over
the ranks; the MLP weights are replicated, float32 as in glia_tpu.  The
forward includes the edge->region aggregation over the mesh (dense
``psum_scatter`` + ``all_gather`` in ``make_train_step``, the
routing-planned halo of halo.py in ``make_halo_train_step``).  The
messages that cross the mesh depend on the pixels, not on the weights,
so autograd runs through the MLP only; each rank's gradient is then
all-reduced.

glia_tpu's gradient is ``world`` times the true gradient: it takes
``value_and_grad`` of a loss that already ``psum``s over the mesh, and
psums the gradient again (glia_tpu/parallel/train.py:97 and :337), while
the cotangent of the replicated weights is already summed.  The port
copies that factor (ROADMAP F5), so that its updates equal glia_tpu's:
under ``make_halo_train_step``'s global-norm clip the update depends on
it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import mlp2_forward, mlp2_init
from .halo import fold_order, group_edges, halo_exchange
from .mesh import Mesh, to_device
from .rag_shard import edge_pixel_stats, incident_order, incident_sums

MLP_DIMS = (8, 16, 8)  # D (edge feature width), N1, N2
P_CLIP = 1e-7


def edge_forward(w, u, v, px, px_mask, edge_valid, n_regions_padded,
                 mesh: Mesh = None):
    """Edge scoring forward on one rank's edges: single-process with
    ``mesh=None``, else the region context is summed over the mesh
    (``psum_scatter``) and gathered back (``all_gather``), as glia_tpu's
    ``axis_name=EDGE_AXIS`` form under shard_map."""
    D, N1, N2 = MLP_DIMS
    mean, mn, mx, cnt = edge_pixel_stats(px, px_mask)
    msgs = torch.stack([torch.ones_like(mean), mean, mn, mx], dim=1)
    part = incident_sums(msgs * edge_valid[:, None], incident_order(u, v),
                         n_regions_padded)
    rfull = part if mesh is None else mesh.all_gather(mesh.psum_scatter(part))
    feats = torch.cat([torch.stack([mean, mn, mx, cnt], dim=1),
                       rfull[u][:, :2], rfull[v][:, :2]],
                      dim=1).to(torch.float32)
    return mlp2_forward(w, feats, D, N1, N2)


def _cross_entropy(p, labels, edge_valid):
    p = torch.clamp(p, P_CLIP, 1 - P_CLIP)
    ce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return ce * edge_valid


def _sharded_loss_and_grad(mesh: Mesh, w, forward, labels, edge_valid):
    """(loss, gradient) of the mean cross entropy over every rank's edges;
    the gradient carries glia_tpu's factor ``world`` (module docstring)."""
    w_ = w.detach().requires_grad_(True)
    num = _cross_entropy(forward(w_), labels, edge_valid).sum()
    den = torch.clamp(mesh.psum(edge_valid.sum().detach()), min=1.0)
    (g_local,) = torch.autograd.grad(num / den, w_)
    g = mesh.psum(g_local) * mesh.world
    loss = mesh.psum(num.detach()) / den
    return loss, g


def _init_fn(D, N1, N2, lr, device):
    def init(seed=0):
        w = torch.tensor(mlp2_init(D, N1, N2, seed), dtype=torch.float32,
                         device=device)
        return w, torch.optim.Adam([w], lr=lr)

    return init


def _apply(w, opt, g):
    w.grad = g
    opt.step()
    w.grad = None
    return w


def make_train_step(mesh: Mesh, n_regions_padded: int, lr=1e-3):
    """Returns (init, step): init(seed) -> (w, opt_state);
    step(w, opt_state, batch) -> (w, opt_state, loss) with Adam(lr).
    ``batch`` holds u, v, px, px_mask, edge_valid, labels as full
    tensors, each rank taking its block.  ``w`` is updated in place."""
    D, N1, N2 = MLP_DIMS

    def step(w, opt_state, batch):
        b = {k: mesh.shard(batch[k]) for k in
             ("u", "v", "px", "px_mask", "edge_valid", "labels")}

        def forward(w_):
            return edge_forward(w_, b["u"], b["v"], b["px"], b["px_mask"],
                                b["edge_valid"], n_regions_padded, mesh)

        loss, g = _sharded_loss_and_grad(mesh, w, forward, b["labels"],
                                         b["edge_valid"])
        return _apply(w, opt_state, g), opt_state, loss

    return _init_fn(D, N1, N2, lr, mesh.device), step


# ---------------------------------------------------------------------------
# full feature width + routing-planned halo
# ---------------------------------------------------------------------------

def _log_compress(x):
    """Signed log1p on the region-context sums, which grow with the graph
    (counts, sums); the same move as the reference's log shape features
    (hmt/bc_feat.hxx)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def halo_feat_dims(n_images=2, n_bins=16):
    """Edge feature width and MLP input width of the halo train step."""
    edge_w = n_images * (4 + n_bins) + 1          # per-image stats + count
    return edge_w, edge_w + 2 * (edge_w + 1)      # + 2 region contexts


def _edge_feats_from_pixels(px, px_mask, n_bins):
    """Per-edge full-width boundary stats: for each feature image
    mean/std/min/max + a normalized n_bins histogram, plus the shared
    pixel count (bc_feat.hxx:132-215 on the device).  px [E, n_img, K],
    px_mask [E, K]."""
    cnt = px_mask.sum(dim=1)                      # [E]
    denom = torch.clamp(cnt, min=1.0)
    m = px_mask[:, None, :]
    mean = (px * m).sum(dim=2) / denom[:, None]
    ss = (px * px * m).sum(dim=2)
    var = torch.clamp(ss / denom[:, None] - mean * mean, min=0.0)
    # safe sqrt: the gradient of sqrt at 0 is inf, and var == 0 is common
    std = torch.where(var > 0, torch.sqrt(torch.where(var > 0, var, 1.0)),
                      0.0)
    inf = torch.tensor(float("inf"), dtype=px.dtype, device=px.device)
    mn = torch.where(m > 0, px, inf).amin(dim=2)
    mn = torch.where(cnt[:, None] > 0, mn, 0.0)
    mx = torch.where(m > 0, px, -inf).amax(dim=2)
    mx = torch.where(cnt[:, None] > 0, mx, 0.0)
    bins = torch.clamp((px * n_bins).to(torch.int32), 0, n_bins - 1)
    # the bin counts are whole numbers below 2**24, exact in any order of
    # addition: scattered into [E, n_img, n_bins] they give the bits of
    # glia_tpu's one-hot sum, without its [E, n_img, K, n_bins] block
    # (17 GB at SNEMI3D's 1.4M edges)
    counts = torch.zeros(px.shape[:2] + (n_bins,), dtype=px.dtype,
                         device=px.device)
    counts.scatter_add_(2, bins.long(), m.expand_as(px))
    hist = counts / denom[:, None, None]
    per_img = torch.cat([torch.stack([mean, std, mn, mx], dim=2), hist],
                        dim=2)
    E = px.shape[0]
    return torch.cat([per_img.reshape(E, -1), cnt[:, None]], dim=1), cnt


def _context_msgs(px, px_mask, edge_valid, n_bins):
    feats_e, cnt = _edge_feats_from_pixels(px, px_mask, n_bins)
    msgs = torch.cat([torch.ones_like(cnt)[:, None], feats_e], dim=1)
    return feats_e, msgs * edge_valid[:, None]


def edge_forward_full(w, u, v, px, px_mask, edge_valid, n_regions,
                      n_bins=16, n1=64, n2=16):
    """Single-process full-width edge scoring: per-edge boundary stats ->
    region-context segment sums (kernel B2 on the card) -> MLP2 merge
    probabilities.  The sharded halo step computes exactly this with the
    table assembled by the halo exchange."""
    feats_e, msgs = _context_msgs(px, px_mask, edge_valid, n_bins)
    table = _log_compress(incident_sums(msgs, incident_order(u, v),
                                        n_regions))
    feats = torch.cat([feats_e, table[u], table[v]], dim=1).to(torch.float32)
    return mlp2_forward(w, feats, feats.shape[1], n1, n2)


def halo_train_host_inputs(plan, part, rag, images, labels, k_pixels=32):
    """Host prep for the halo train step, every shard's rows: per-edge
    boundary pixel blocks of each feature image grouped by owning shard
    (px [n, E_max, n_img, K] float32, px_mask [n, E_max, K] bool), the
    endpoints u, v (global rows) and u_loc, v_loc (rows of the shard's
    [own; halo] table), labels and edge_valid [n, E_max], and the plan's
    routing rows: send_ids, recv_local, fetch_local [n, n, H], own_ids
    [n, R_own_max].  ``halo_rank_block`` cuts out what one rank reads."""
    from ..ops.pack import pack_csr_values
    from .halo import local_endpoint_indices

    n = plan.n
    ui = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    px_imgs = []
    mask = None
    for img in images:
        flat = np.asarray(img, np.float32).ravel()
        vals, mask = pack_csr_values(flat[rag.edge_pixels], rag.edge_ptr,
                                     k_pixels)
        px_imgs.append(vals)
    px = np.stack(px_imgs, axis=1)                 # [E, n_img, K]
    groups, E_max = group_edges(part, n)
    n_img = len(images)
    u_p = np.full((n, E_max), rag.n_regions, np.int32)
    v_p = np.full((n, E_max), rag.n_regions, np.int32)
    px_p = np.zeros((n, E_max, n_img, k_pixels), np.float32)
    mask_p = np.zeros((n, E_max, k_pixels), bool)
    lab_p = np.zeros((n, E_max), np.float32)
    val_p = np.zeros((n, E_max), np.float32)
    labels = np.asarray(labels, np.float32)
    for s, g in enumerate(groups):
        u_p[s, : len(g)] = ui[g]
        v_p[s, : len(g)] = vi[g]
        px_p[s, : len(g)] = px[g]
        mask_p[s, : len(g)] = mask[g] > 0
        lab_p[s, : len(g)] = labels[g]
        val_p[s, : len(g)] = 1.0
    u_loc, v_loc = local_endpoint_indices(plan, part, rag, groups, E_max)
    return {"u": u_p, "v": v_p, "px": px_p, "px_mask": mask_p,
            "labels": lab_p, "edge_valid": val_p, "u_loc": u_loc,
            "v_loc": v_loc, "send_ids": plan.send_ids,
            "recv_local": plan.recv_local, "fetch_local": plan.fetch_local,
            "own_ids": plan.own_ids, "E_max": E_max}


_HALO_BLOCKS = ("u", "v", "px", "px_mask", "labels", "edge_valid", "u_loc",
                "v_loc", "send_ids", "recv_local", "fetch_local", "own_ids")


def halo_rank_block(host: dict, rank: int) -> dict:
    """The rows of ``halo_train_host_inputs`` that rank ``rank``'s train
    step reads (views, numpy), and the padded row count E_max."""
    block = {k: host[k][rank] for k in _HALO_BLOCKS}
    block["E_max"] = host["E_max"]
    return block


def halo_train_batch(mesh: Mesh, block: dict) -> dict:
    """A rank's block (``halo_rank_block``) as tensors on the mesh's
    device: the batch of ``make_halo_train_step``.  The endpoints and the
    routing rows stay fixed over the steps, so the batch carries their
    orders of addition, sorted once here: ``incident`` (``incident_order``
    of u, v) and ``fold`` (``fold_order`` of the recv_local rows)."""
    out = {k: to_device(block[k], mesh, torch.int64)
           for k in ("u", "v", "u_loc", "v_loc", "send_ids", "fetch_local",
                     "own_ids")}
    out.update({k: to_device(block[k], mesh, torch.float32)
                for k in ("px", "px_mask", "labels", "edge_valid")})
    out["E_max"] = block["E_max"]
    out["incident"] = incident_order(out["u"], out["v"])
    out["fold"] = fold_order(to_device(block["recv_local"], mesh,
                                       torch.int64),
                             out["own_ids"].shape[0])
    return out


def shard_halo_train_inputs(mesh: Mesh, plan, part, rag, images, labels,
                            k_pixels=32, n_bins=16):
    """This rank's batch of the halo train step, prepared from the full
    host inputs (``halo_train_host_inputs``, then the rank's block).
    ``n_bins`` is glia_tpu's argument; the host prep does not use it."""
    host = halo_train_host_inputs(plan, part, rag, images, labels, k_pixels)
    return halo_train_batch(mesh, halo_rank_block(host, mesh.rank))


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on one flat gradient: ``g`` when its norm
    is below ``max_norm``, else ``g / norm * max_norm``."""
    norm = torch.linalg.vector_norm(g)
    return torch.where(norm < max_norm, g, g / norm * max_norm)


def make_halo_train_step(mesh: Mesh, plan, n_regions: int, n_images=2,
                         k_pixels=32, n_bins=16, n1=64, n2=16, lr=1e-3):
    """The sharded train step at full feature width with the
    routing-planned halo (halo.py) instead of the dense gather: traffic a
    step ~ the cut, not R.

    Forward on a rank: boundary-pixel stats -> edge features -> segment
    sum partials (kernel B2's sorted entry, in the batch's fixed order) ->
    all_to_all reduce to owners -> all_to_all
    halo fetch -> region context -> MLP2 -> cross entropy; the gradient
    all-reduced, clipped to global norm 1 and applied by Adam(lr) (optax's
    ``chain(clip_by_global_norm(1.0), adam(lr))``).
    ``batch`` is the rank's own (``shard_halo_train_inputs``, or
    ``halo_train_batch`` of its ``halo_rank_block``).
    Returns (init, step, (edge_w, D)); ``step.loss_and_grad(w, batch)``
    gives the loss and the gradient before the clip."""
    edge_w, D = halo_feat_dims(n_images, n_bins)

    def loss_and_grad(w, b):
        feats_e, msgs = _context_msgs(b["px"], b["px_mask"],
                                      b["edge_valid"], n_bins)
        partials = incident_sums(msgs, b["incident"], n_regions + 1)
        own, halo_rows = halo_exchange(mesh, partials, b["send_ids"],
                                       b["fold"], b["own_ids"],
                                       b["fetch_local"])
        table = _log_compress(torch.cat([own, halo_rows], dim=0))
        feats = torch.cat([feats_e, table[b["u_loc"]], table[b["v_loc"]]],
                          dim=1).to(torch.float32)

        def forward(w_):
            return mlp2_forward(w_, feats, D, n1, n2)

        return _sharded_loss_and_grad(mesh, w, forward, b["labels"],
                                      b["edge_valid"])

    def step(w, opt_state, batch):
        loss, g = loss_and_grad(w, batch)
        return _apply(w, opt_state, clip_by_global_norm(g, 1.0)), \
            opt_state, loss

    step.loss_and_grad = loss_and_grad
    return _init_fn(D, n1, n2, lr, mesh.device), step, (edge_w, D)
