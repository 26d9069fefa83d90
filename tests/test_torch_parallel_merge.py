"""The port's sharded merge (glia_tpu_torch.parallel.merge_shard) against
glia_tpu.parallel.merge_shard and against the port's single-process fused
engine, on glia_tpu's 192^2 test section.

glia_tpu runs on its CPU mesh of 2 and of 4 devices; the port on 2 and
on 4 gloo ranks, one world each for every case of this file.  Rows,
merge counts and every ``stats`` counter of glia_tpu's are equal;
saliencies float64 within 1e-12 relative.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

from glia_tpu.data.synthetic import synthetic_em_slice as jx_slice
from glia_tpu.graph.merge_device import edge_mean_arrays as jx_uvsc
from glia_tpu.graph.rag import build_rag as jx_build_rag
from glia_tpu.native import watershed_native as jx_watershed
from glia_tpu.parallel import merge_shard as jx_ms
from glia_tpu.parallel.mesh import make_mesh as jx_mesh

from glia_tpu_torch.data.synthetic import synthetic_em_slice
from glia_tpu_torch.graph.merge import apply_merge_order
from glia_tpu_torch.graph.merge_device import (edge_mean_arrays,
                                               merge_batched_device,
                                               order_to_keys,
                                               replay_exact_saliency,
                                               threshold_cut)
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.metrics import eval_vi
from glia_tpu_torch.native import greedy_merge_native, watershed_native
from glia_tpu_torch.parallel import merge_shard
from glia_tpu_torch.parallel.launch import spawn_ranks

import torch_parallel_ranks as ranks

WORLDS = (2, 4)
SMALL_CAP = 8
# at 4 ranks glia_tpu stops doubling this capacity at 56, one step early
# (ROADMAP F6)
F6_CAP = 14
GLIA_STATS = ("n_supersteps", "capacity", "route_cap", "routed_rows",
              "moved_rows", "allreduce_bytes", "a2a_padded_rows",
              "a2a_wire_bytes")


def _section(slice_fn, watershed_fn, rag_fn, uvsc_fn):
    data = slice_fn((192, 192), n_cells=80, seed=21, blur=1.2, noise=0.12)
    seg = watershed_fn(ndi.gaussian_filter(data["pb"], 1.0), level=0.004)
    rag = rag_fn(seg, contour_only=False)
    return data, seg, rag, uvsc_fn(rag, data["pb"])


@pytest.fixture(scope="module")
def sections():
    jx = _section(jx_slice, jx_watershed, jx_build_rag, jx_uvsc)
    pt = _section(synthetic_em_slice, watershed_native, build_rag,
                  edge_mean_arrays)
    for a, b in zip(jx[3], pt[3]):
        np.testing.assert_array_equal(a, b)
    return jx, pt


@pytest.fixture(scope="module")
def port(sections):
    _, (_, _, rag, (u, v, s, c)) = sections
    case = {"u": u, "v": v, "s": s, "c": c, "R": rag.n_regions,
            "caps": {"small_cap": SMALL_CAP, "f6_cap": F6_CAP}}
    return {n: spawn_ranks(ranks.merge_rank, n, "gloo", "cpu", args=(case,),
                           timeout_s=300) for n in WORLDS}


@pytest.fixture(scope="module")
def glia(sections):
    (_, _, rag, (u, v, s, c)), _ = sections
    out = {}
    for n in WORLDS:
        res = {}
        for name, cap in (("default", None), ("small_cap", SMALL_CAP),
                          ("f6_cap", F6_CAP)):
            stats = {}
            o, sal, n_m = jx_ms.merge_batched_sharded(
                u, v, s, c, rag.n_regions, jx_mesh(n), dmax=4, stats=stats,
                route_cap=cap)
            res[name] = {"order": np.asarray(o), "sal": np.asarray(sal),
                         "n_m": n_m, "stats": stats}
        out[n] = res
    return out


def test_pair_owner_matches_the_host_hash():
    import torch

    rng = np.random.default_rng(1)
    lo = rng.integers(0, 2 ** 31 - 1, 20000)
    hi = rng.integers(0, 2 ** 31 - 1, 20000)
    lo[:3], hi[:3] = 0, [0, 1, 2 ** 31 - 1]
    for n in (1, 2, 3, 4, 8):
        want = jx_ms.pair_owner_np(lo, hi, n)
        np.testing.assert_array_equal(merge_shard.pair_owner_np(lo, hi, n),
                                      want)
        got = merge_shard.pair_owner(torch.from_numpy(lo),
                                     torch.from_numpy(hi), n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WORLDS)
def test_shard_merge_inputs_match_glia_tpu(sections, n):
    (_, _, _, (u, v, s, c)), _ = sections
    sc = np.stack([s, c], axis=1)
    for a, b in zip(jx_ms.shard_merge_inputs(u, v, sc, n),
                    merge_shard.shard_merge_inputs(u, v, sc, n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("run", ["default", "small_cap"])
def test_sharded_merge_matches_glia_tpu(port, glia, n, run):
    for r, res in enumerate(port[n]):
        got, want = res[run], glia[n][run]
        assert got["n_m"] == want["n_m"], f"rank {r}"
        np.testing.assert_array_equal(got["order"], want["order"])
        np.testing.assert_allclose(got["sal"], want["sal"], rtol=1e-12,
                                   atol=0)
        for k in GLIA_STATS:
            assert got["stats"][k] == want["stats"][k], (r, k)
        assert got["stats"]["host_staged_bytes"] == 0   # CPU tensors


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_merge_matches_the_single_process_engine(sections, port, n):
    _, (_, _, rag, (u, v, s, c)) = sections
    o1, s1, n1 = merge_batched_device(u, v, s, c, rag.n_regions, dmax=4,
                                      device="cpu")
    for run in ("default", "small_cap", "f6_cap"):
        got = port[n][0][run]
        assert got["n_m"] == n1
        np.testing.assert_array_equal(got["order"][:n1], o1[:n1].numpy())
        np.testing.assert_allclose(got["sal"][:n1], s1[:n1].numpy(),
                                   rtol=1e-12, atol=0)


def test_small_route_cap_retries_to_the_same_rows(port, glia):
    for n in WORLDS:
        got = port[n][0]
        assert got["small_cap"]["stats"]["retries"] > 0
        assert got["small_cap"]["stats"]["route_cap"] > SMALL_CAP
        assert got["default"]["stats"]["retries"] == 0
        np.testing.assert_array_equal(got["small_cap"]["order"],
                                      got["default"]["order"])
        # glia_tpu's retry (one shard's overflow flag) ends on the same
        # capacity and rows here
        np.testing.assert_array_equal(glia[n]["small_cap"]["order"],
                                      glia[n]["default"]["order"])


def test_glia_tpu_misses_a_route_overflow_off_its_read_shard(port, glia):
    """ROADMAP F6, a fault of glia_tpu: its overflow flag leaves
    shard_map through ``out_specs=P()`` with ``check_vma=False``, which
    reads one shard's value.  At 4 shards from route_cap 14 another
    shard still overflows at 56; glia_tpu stops there with rows that
    differ from its own default run.  The port all-reduces the flag with
    MAX, doubles to 112 and returns the default rows."""
    got, want = port[4][0]["f6_cap"], glia[4]["f6_cap"]
    assert got["stats"]["route_cap"] == 112
    np.testing.assert_array_equal(got["order"], port[4][0]["default"]["order"])
    assert want["stats"]["route_cap"] == 56
    assert not np.array_equal(want["order"], glia[4]["default"]["order"])
    # at 2 shards both end on the same capacity and rows
    assert (port[2][0]["f6_cap"]["stats"]["route_cap"]
            == glia[2]["f6_cap"]["stats"]["route_cap"])
    np.testing.assert_array_equal(port[2][0]["f6_cap"]["order"],
                                  glia[2]["f6_cap"]["order"])


def test_sharded_threshold_cut_components(sections, port):
    """glia_tpu's test_sharded_merge_threshold_cut_components on the
    port: the 4-rank cut equals the single-process engine's (VI 0)."""
    _, (data, seg, rag, (u, v, s, c)) = sections
    order_h, sal_h = greedy_merge_native(rag, data["pb"], policy="mean")
    k = rag.n_regions - 80
    tau = -sal_h[k - 1]
    got = port[4][0]["default"]
    n8 = got["n_m"]
    okeys = order_to_keys(got["order"], n8, rag)
    ex = replay_exact_saliency(u, v, s, c, got["order"][:n8])
    seg_8 = apply_merge_order(seg, okeys[threshold_cut(okeys, ex, tau)])
    o1, _, n1 = merge_batched_device(u, v, s, c, rag.n_regions, dmax=4,
                                     device="cpu")
    o1 = o1.numpy()
    okeys1 = order_to_keys(o1, n1, rag)
    ex1 = replay_exact_saliency(u, v, s, c, o1[:n1])
    seg_1 = apply_merge_order(seg, okeys1[threshold_cut(okeys1, ex1, tau)])
    assert eval_vi(seg_8, seg_1)[2] == 0.0
    seg_ser = apply_merge_order(seg, order_h, threshold_index=k)
    assert abs(eval_vi(seg_8, data["truth"])[2]
               - eval_vi(seg_ser, data["truth"])[2]) < 0.05


def test_exact_saliency_sharded_matches_glia_tpu(sections, port):
    (_, _, rag, (u, v, s, c)), _ = sections
    got = port[4][0]
    order = got["default"]["order"][:got["default"]["n_m"]]
    want = jx_ms.exact_saliency_sharded(u, v, s, c, order, rag.n_regions,
                                        jx_mesh(4))
    np.testing.assert_array_equal(np.isnan(got["exact"]), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got["exact"][ok], want[ok], rtol=1e-12,
                               atol=0)
    host = replay_exact_saliency(u, v, s, c, order)
    np.testing.assert_allclose(got["exact"][ok], host[ok], rtol=1e-12,
                               atol=0)
