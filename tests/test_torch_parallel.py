"""The port's sharded RAG path (glia_tpu_torch.parallel: pack,
partition, halo plan, dense and halo aggregation, edge scoring, train
steps) against glia_tpu.parallel on the same inputs.

glia_tpu runs on its 8-device CPU mesh (tests/conftest.py); the port runs
gloo ranks on the CPU through ``spawn_ranks``: one world of 4 ranks for
every sharded case of this file (``world4``), and one rank for the
gradient factor (``world1``).  Tolerances: 1e-12 where the data are
float64; 1e-6 relative on float32 data (glia_tpu computes these paths in
float32: its halo inputs are cast to float32, its MLP runs in float32),
where the two sides sum in different orders; trained weights within
1e-5 relative after 5 Adam steps (optax and torch.optim round Adam's
update differently).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from glia_tpu.data.synthetic import synthetic_em_slice as jx_slice
from glia_tpu.graph.rag import build_rag as jx_build_rag
from glia_tpu.native import watershed_native as jx_watershed
from glia_tpu.ops import pack as jx_pack
from glia_tpu.parallel import halo as jx_halo
from glia_tpu.parallel import partition as jx_partition
from glia_tpu.parallel import rag_shard as jx_rag_shard
from glia_tpu.parallel import train as jx_train
from glia_tpu.parallel.mesh import EDGE_AXIS, make_mesh as jx_mesh

from glia_tpu_torch.data.synthetic import synthetic_em_slice
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.native import watershed_native
from glia_tpu_torch.ops import pack
from glia_tpu_torch.parallel import halo, partition
from glia_tpu_torch.parallel.launch import spawn_ranks

import torch_parallel_ranks as ranks

WORLD = 4
K, BINS = 16, 8
N_STEPS = 5
F32_RTOL = 1e-6
W_RTOL = 1e-5


def _section(slice_fn, watershed_fn, rag_fn):
    """glia_tpu's halo test section (96^2, seed 44) through one
    package's own pipeline."""
    data = slice_fn((96, 96), n_cells=24, seed=44)
    seg = watershed_fn(ndi.gaussian_filter(data["pb"], 1.0), 0.01)
    return data, rag_fn(seg, contour_only=False)


@pytest.fixture(scope="module")
def sections():
    jx = _section(jx_slice, jx_watershed, jx_build_rag)
    pt = _section(synthetic_em_slice, watershed_native, build_rag)
    np.testing.assert_array_equal(jx[1].edges, pt[1].edges)
    return jx, pt


def _toy_batch(n_edges, n_regions, k=8, seed=0):
    """__graft_entry__._toy_rag_batch's toy edges."""
    from __graft_entry__ import _toy_rag_batch

    u, v, px, mask, valid, labels = _toy_rag_batch(
        n_edges=n_edges, n_regions=n_regions, k=k, seed=seed)
    return {"u": u, "v": v, "px": px, "px_mask": mask, "edge_valid": valid,
            "labels": labels}


@pytest.fixture(scope="module")
def case(sections):
    (data, _), (_, rag) = sections
    rng = np.random.default_rng(0)
    E, R, F = 64, 16, 3
    agg = (rng.integers(0, R, E), rng.integers(0, R, E), rng.random((E, F)))
    return {
        "agg": agg, "agg_R": R, "rag": rag, "pb": data["pb"],
        "toy": _toy_batch(128, 16), "toy_R": 16, "n_steps": N_STEPS,
        "halo_ev": np.random.default_rng(0).random((rag.n_edges, 3)),
        "halo_pb": np.random.default_rng(3).random(rag.shape),
        "K": K, "BINS": BINS, "images": [data["pb"], data["intensity"]],
        "labels": np.random.default_rng(0).integers(
            0, 2, rag.n_edges).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world4(case):
    out = spawn_ranks(ranks.parallel_rank, WORLD, "gloo", "cpu",
                      args=(case,), timeout_s=300)
    return out


@pytest.fixture(scope="module")
def world1(case):
    return spawn_ranks(ranks.halo_grad_rank, 1, "gloo", "cpu",
                       args=(case,), timeout_s=300)[0]


def _dev(mesh, x, spec=P(EDGE_AXIS)):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-300))


# ---------------------------------------------------------------------------
# host tables (no ranks)
# ---------------------------------------------------------------------------

def test_pack_matches_glia_tpu(sections):
    (data, jrag), (_, rag) = sections
    for k in (4, 8, 32):
        for a, b in zip(jx_pack.pack_edge_pixels(jrag, data["pb"], k),
                        pack.pack_edge_pixels(rag, data["pb"], k)):
            np.testing.assert_array_equal(a, b)
    ptr = np.array([0, 0, 3, 4, 9])
    vals = np.arange(9.0)
    for a, b in zip(jx_pack.pack_csr_values(vals, ptr, 3),
                    pack.pack_csr_values(vals, ptr, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_and_halo_plan_match_glia_tpu(sections, n_shards):
    (_, jrag), (_, rag) = sections
    jp = jx_partition.partition_rag(jrag, n_shards)
    pp = partition.partition_rag(rag, n_shards)
    for f in ("region_shard", "edge_shard", "cut_mask"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(pp, f))
    assert len(jp.halo_regions) == len(pp.halo_regions) == n_shards
    for a, b in zip(jp.halo_regions, pp.halo_regions):
        np.testing.assert_array_equal(a, b)
    assert jp.cut_fraction == pp.cut_fraction
    assert jp.balance() == pp.balance()
    jh, ph = jx_halo.HaloPlan(jp, jrag), halo.HaloPlan(pp, rag)
    assert (jh.H, jh.n, jh.R_own_max, jh.comm_rows) == \
        (ph.H, ph.n, ph.R_own_max, ph.comm_rows)
    for f in ("send_ids", "recv_local", "own_ids", "local_of_global",
              "halo_ids", "fetch_local"):
        np.testing.assert_array_equal(getattr(jh, f), getattr(ph, f))
    groups = [np.nonzero(pp.edge_shard == s)[0] for s in range(n_shards)]
    E_max = max(len(g) for g in groups)
    for a, b in zip(
            jx_halo.local_endpoint_indices(jh, jp, jrag, groups, E_max),
            halo.local_endpoint_indices(ph, pp, rag, groups, E_max)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sharded functions at world 4
# ---------------------------------------------------------------------------

def test_world4_ranks_agree(world4):
    for res in world4[1:]:
        for k in ("aggregate", "scoring", "train_w", "halo_own",
                  "halo_rows", "halo_forward", "halo_w", "halo_grad0"):
            np.testing.assert_array_equal(res[k], world4[0][k])


def test_region_aggregate_matches_glia_tpu(case, world4):
    mesh = jx_mesh(WORLD)
    u, v, ev = case["agg"]
    want = np.asarray(jx_rag_shard.make_region_aggregate(mesh, case["agg_R"])(
        _dev(mesh, u.astype(np.int32)), _dev(mesh, v.astype(np.int32)),
        _dev(mesh, ev)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(world4[0]["aggregate"], want, rtol=1e-12,
                               atol=0)


def test_edge_scoring_step_matches_glia_tpu(sections, world4):
    (data, jrag), _ = sections
    mesh = jx_mesh(WORLD)
    b = jx_rag_shard.shard_edges(jrag, data["pb"], mesh,
                                 max_pixels_per_edge=8)
    R_pad = -(-jrag.n_regions // WORLD) * WORLD
    w = jnp.asarray(jx_train.mlp2_init(*jx_train.MLP_DIMS, 0), jnp.float32)
    want = np.asarray(jx_rag_shard.make_edge_scoring_step(mesh, R_pad)(
        b["u"], b["v"], b["px"], b["px_mask"], b["edge_valid"], w))
    got = world4[0]["scoring"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)


def test_train_step_matches_glia_tpu(case, world4):
    mesh = jx_mesh(WORLD)
    batch = {k: _dev(mesh, v) for k, v in case["toy"].items()}
    init, step = jx_train.make_train_step(mesh, case["toy_R"], lr=5e-2)
    w, st = init()
    losses = []
    for _ in range(N_STEPS):
        w, st, loss = step(w, st, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(world4[0]["train_losses"], losses,
                               rtol=W_RTOL)
    assert _rel(world4[0]["train_w"], w) < W_RTOL


@pytest.fixture(scope="module")
def jx_halo_case(sections, case):
    (_, jrag), _ = sections
    mesh = jx_mesh(WORLD)
    part = jx_partition.partition_rag(jrag, WORLD)
    plan = jx_halo.HaloPlan(part, jrag)
    return jrag, mesh, part, plan


def test_halo_aggregate_matches_glia_tpu(case, world4, jx_halo_case):
    jrag, mesh, part, plan = jx_halo_case
    inp = jx_halo.shard_halo_inputs(mesh, plan, part, jrag, case["halo_ev"])
    own, rows = jx_halo.make_halo_aggregate(mesh, plan, jrag.n_regions, 3)(
        inp["u"], inp["v"], inp["ev"], inp["send_ids"], inp["recv_local"],
        inp["own_ids"], inp["halo_ids"], inp["fetch_local"])
    for got, want in ((world4[0]["halo_own"], own),
                      (world4[0]["halo_rows"], rows)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
    assert plan.comm_rows > 0


def test_halo_edge_forward_matches_glia_tpu(case, world4, jx_halo_case):
    jrag, mesh, part, plan = jx_halo_case
    u, v, px, mask = jx_pack.pack_edge_pixels(jrag, case["halo_pb"], 8)
    groups = world4[0]["halo_groups"]
    E_max = max(len(g) for g in groups)
    n = plan.n
    u_p = np.full((n, E_max), jrag.n_regions, np.int32)
    v_p = np.full((n, E_max), jrag.n_regions, np.int32)
    px_p = np.zeros((n, E_max, px.shape[1]), np.float32)
    mask_p = np.zeros((n, E_max, px.shape[1]), np.float32)
    valid_p = np.zeros((n, E_max), np.float32)
    for s, g in enumerate(groups):
        u_p[s, : len(g)] = u[g]
        v_p[s, : len(g)] = v[g]
        px_p[s, : len(g)] = px[g]
        mask_p[s, : len(g)] = mask[g]
        valid_p[s, : len(g)] = 1.0
    u_loc, v_loc = jx_halo.local_endpoint_indices(plan, part, jrag, groups,
                                                  E_max)
    w = jnp.asarray(jx_train.mlp2_init(*jx_train.MLP_DIMS, 0), jnp.float32)
    d = lambda x: _dev(mesh, x)  # noqa: E731
    want = np.asarray(jx_halo.make_halo_edge_forward(
        mesh, plan, jrag.n_regions)(
        w, d(u_p.reshape(-1)), d(v_p.reshape(-1)),
        d(px_p.reshape(-1, px.shape[1])), d(mask_p.reshape(-1, px.shape[1])),
        d(valid_p.reshape(-1)), d(u_loc.reshape(-1)), d(v_loc.reshape(-1)),
        d(plan.send_ids), d(plan.recv_local), d(plan.own_ids.reshape(-1)),
        d(plan.fetch_local)))
    np.testing.assert_allclose(world4[0]["halo_forward"], want,
                               rtol=F32_RTOL, atol=0)


def test_halo_train_step_matches_glia_tpu(case, world4, jx_halo_case):
    """Weights after 5 steps of glia_tpu's clipped Adam, from the same
    mlp2_init; the clip fires on glia_tpu's 4x gradient (F5), so equal
    weights also show the port carries that factor."""
    jrag, mesh, part, plan = jx_halo_case
    init, step, dims = jx_train.make_halo_train_step(
        mesh, plan, jrag.n_regions, n_images=2, k_pixels=K, n_bins=BINS,
        n1=16, n2=8)
    batch = jx_train.shard_halo_train_inputs(
        mesh, plan, part, jrag, case["images"], case["labels"], k_pixels=K,
        n_bins=BINS)
    w, st = init()
    losses = []
    for _ in range(N_STEPS):
        w, st, loss = step(w, st, batch)
        losses.append(float(loss))
    got = world4[0]
    assert tuple(got["halo_dims"]) == tuple(dims)
    np.testing.assert_allclose(got["halo_losses"], losses, rtol=W_RTOL)
    assert _rel(got["halo_w"], w) < W_RTOL
    assert got["halo_losses"][-1] < got["halo_losses"][0]


def test_gradient_is_world_times_the_world1_gradient(world4, world1):
    """F5, copied from glia_tpu: at world n the step's gradient is n times
    the true gradient, which a single rank computes."""
    g4, g1 = world4[0]["halo_grad0"], world1["halo_grad0"]
    assert np.abs(g1).max() > 0
    assert _rel(g4, WORLD * g1) < W_RTOL
    assert abs(world4[0]["halo_loss0"] - world1["halo_loss0"]) \
        < F32_RTOL * abs(world1["halo_loss0"])
