"""Port graph/merge_device.py vs glia_tpu's single-phase fused engine.

Inputs are seeded synthetic slices (the cases of tests/test_merge_device.py:
64x64 seed 33 and 192x192 seed 31) turned into RAG edge arrays by
glia_tpu; both sides run on the CPU in float64, glia_tpu jitted as it
runs itself.  Required: identical order rows, merge and superstep counts
for the three policies; saliencies at rtol 1e-12; exact saliencies at
rtol 1e-12 against glia_tpu's device pass and 1e-6 relative against the
serial replay, NaN in the same rows; replays and threshold cuts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import glia_tpu.graph.merge_device as jm
import glia_tpu_torch.graph.merge_device as tm
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.graph.rag import build_rag
from glia_tpu.native import watershed_native


def _case(name):
    if name == "64":
        data = synthetic_em_slice(shape=(64, 64), n_cells=12, seed=33)
        seg = watershed_native(data["pb"], level=0.08)
    else:
        data = synthetic_em_slice((192, 192), n_cells=100, seed=31,
                                  blur=1.2, noise=0.12)
        seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                               level=0.004)
    return data, seg, build_rag(seg, contour_only=False)


@pytest.fixture(scope="module", params=["64", "192"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def case64():
    return _case("64")


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_same_run(got, want, st_got, st_want):
    (o_g, s_g, n_g), (o_w, s_w, n_w) = got, want
    assert n_g == n_w and n_g > 0
    assert st_got["n_supersteps"] == st_want["n_supersteps"]
    np.testing.assert_array_equal(_np(o_g), np.asarray(o_w))
    np.testing.assert_allclose(_np(s_g), np.asarray(s_w), rtol=1e-12,
                               atol=0)


def test_edge_arrays_match(case):
    data, _, rag = case
    for a, b in zip(tm.edge_mean_arrays(rag, data["pb"]),
                    jm.edge_mean_arrays(rag, data["pb"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.edge_hist_arrays(rag, data["pb"], n_bins=16),
                    jm.edge_hist_arrays(rag, data["pb"], n_bins=16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dmax", [4, 1])
def test_mean_engine_rows_identical(case, dmax):
    data, _, rag = case
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    sw, sg = {}, {}
    want = jm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                   dmax=dmax, stats=sw)
    got = tm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                  dmax=dmax, stats=sg, device="cpu")
    _assert_same_run(got, want, sg, sw)
    assert sg["buckets"] == sw["buckets"]


def test_hist_engine_rows_identical(case):
    data, _, rag = case
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=32)
    sw, sg = {}, {}
    want = jm.merge_batched_device_hist(u, v, h, rag.n_regions,
                                        mode="fused", stats=sw)
    got = tm.merge_batched_device_hist(u, v, h, rag.n_regions,
                                       mode="fused", stats=sg, device="cpu")
    _assert_same_run(got, want, sg, sw)


def test_hist_minsize_engine_rows_identical(case):
    data, _, rag = case
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=32)
    sw, sg = {}, {}
    want = jm.merge_batched_device_hist_minsize(
        u, v, h, rag.sizes, rag.n_regions, mode="fused", stats=sw)
    got = tm.merge_batched_device_hist_minsize(
        u, v, h, rag.sizes, rag.n_regions, mode="fused", stats=sg,
        device="cpu")
    _assert_same_run(got, want, sg, sw)


def test_max_supersteps_cut_matches(case64):
    """A run cut short leaves the same padded rows (-1) as glia_tpu's."""
    data, _, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    sw, sg = {}, {}
    want = jm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                   max_supersteps=2, stats=sw)
    got = tm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                  max_supersteps=2, stats=sg, device="cpu")
    _assert_same_run(got, want, sg, sw)
    assert got[2] < rag.n_regions - 1
    assert (_np(got[0])[got[2]:] == -1).all()


def test_unpacked_hop_and_sort_form_gives_the_same_rows(case):
    """The form used when (dmax+2)*(n_ids+1) >= 2**31 (two gathers per
    hop, three stable sorts) equals the packed form."""
    data, _, rag = case
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    sc = torch.as_tensor(np.stack([s, c], axis=1))
    runs = [tm._fused_merge_core(u, v, (sc,), tm._mean_stat_packed,
                                 rag.n_regions, 256, torch.float64,
                                 torch.device("cpu"), pack_hr=p)
            for p in (True, False)]
    assert runs[0][2] == runs[1][2]
    np.testing.assert_array_equal(_np(runs[0][0]), _np(runs[1][0]))
    np.testing.assert_array_equal(_np(runs[0][1]), _np(runs[1][1]))


def test_float32_payload_rows_identical(case64):
    data, _, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    want = jm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                   dtype=jnp.float32)
    got = tm.merge_batched_device(u, v, s, c, rag.n_regions, mode="fused",
                                  dtype=torch.float32, device="cpu")
    assert got[2] == want[2]
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    assert got[1].dtype == torch.float32
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-6)


def test_statistic_order_ties_and_denormals():
    """A path 0-1-2-3 whose statistics are a float32 denormal, a tie of
    two equal values and a value that differs from them only in float64:
    the order is that of the float32 bit patterns with denormals flushed,
    ties going to the lowest edge index, as in glia_tpu."""
    u = np.array([0, 1, 2, 3], np.int32)
    v = np.array([1, 2, 3, 4], np.int32)
    c = np.ones(4)
    for s in ([1e-40, 0.0, 0.5, 0.5 + 1e-12],
              [0.25, 0.25, 0.25, 0.25],
              [0.0, 1e-39, 2e-39, 0.0]):
        want = jm.merge_batched_device(u, v, np.array(s), c, 5,
                                       mode="fused")
        got = tm.merge_batched_device(u, v, np.array(s), c, 5, mode="fused",
                                      device="cpu")
        assert got[2] == want[2] == 4
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_hist_median_stat_matches():
    rows = np.array([[2.0, 1.0, 0.0, 2.0],      # tests/test_merge_device.py
                     [0.0, 0.0, 0.0, 0.0],      # empty row -> bin 0
                     [0.0, 0.0, 0.0, 7.0],
                     [1.0, 1.0, 1.0, 1.0],
                     [3.0, 0.0, 0.0, 3.0]])
    got = tm.hist_median_stat(torch.as_tensor(rows), 0.0, 1.0).numpy()
    want = np.asarray(jm.hist_median_stat(jnp.asarray(rows), 0.0, 1.0))
    np.testing.assert_array_equal(got, want)
    assert got[0] == pytest.approx(0.375)
    assert got[1] == pytest.approx(0.125)
    rng = np.random.default_rng(5)
    h = rng.integers(0, 6, (200, 32)).astype(np.float64)
    np.testing.assert_array_equal(
        tm.hist_median_stat(torch.as_tensor(h), 0.1, 0.9).numpy(),
        np.asarray(jm.hist_median_stat(jnp.asarray(h), 0.1, 0.9)))


def test_exact_saliency_device_matches(case):
    data, _, rag = case
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    order, _, n_m = jm.merge_batched_device(u, v, s, c, rag.n_regions,
                                            mode="fused")
    # the padded order buffer (rows beyond n_m are -1) and the cut one
    for rows in (np.asarray(order), np.asarray(order)[:n_m]):
        want = np.asarray(jm.exact_saliency_device(u, v, s, c, rows,
                                                   rag.n_regions))
        st = {}
        got = tm.exact_saliency_device(u, v, s, c, rows, rag.n_regions,
                                       device="cpu", stats=st).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)
        assert st["sal_L"] >= 1
    assert np.isnan(got).sum() == 0
    host = tm.replay_exact_saliency(u, v, s, c, np.asarray(order)[:n_m])
    np.testing.assert_array_equal(np.isnan(host), np.isnan(got))
    np.testing.assert_allclose(got, host, rtol=1e-6, atol=1e-12)


def test_exact_saliency_nan_rows_and_depth_escalation():
    """A serial chain order 300 deep needs more than the first depth
    capacity (L = 8 covers depth 128); a non-adjacent pair row gives NaN
    on both sides."""
    n = 300
    u = np.arange(n, dtype=np.int32)
    v = u + 1
    rng = np.random.default_rng(3)
    s = rng.random(n)
    c = rng.integers(1, 9, n).astype(np.float64)
    R = n + 1
    order = np.stack([np.concatenate([[0], R + np.arange(n - 1)]),
                      np.arange(1, n + 1), R + np.arange(n)], axis=1)
    st = {}
    got = tm.exact_saliency_device(u, v, s, c, order, R, device="cpu",
                                   stats=st).numpy()
    want = np.asarray(jm.exact_saliency_device(u, v, s, c, order, R))
    assert st["sal_L"] > 8
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, s / c, rtol=1e-12)
    # regions 0 and 2 are not adjacent: the first row pops nothing
    order2 = np.array([[0, 2, 4], [4, 1, 5]])
    got2 = tm.exact_saliency_device(u[:3], v[:3], s[:3], c[:3], order2, 4,
                                    device="cpu").numpy()
    want2 = np.asarray(jm.exact_saliency_device(u[:3], v[:3], s[:3], c[:3],
                                                order2, 4))
    np.testing.assert_array_equal(np.isnan(got2), [True, False])
    np.testing.assert_array_equal(np.isnan(want2), np.isnan(got2))
    np.testing.assert_allclose(got2[1], want2[1], rtol=1e-12)
    # the serial replay gives NaN there too (and, never having merged
    # the pair, for every later merge of that region)
    host2 = tm.replay_exact_saliency(u[:3], v[:3], s[:3], c[:3], order2)
    assert np.isnan(host2[0])


def test_merge_batched_device_exact_matches(case64):
    data, _, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    order, sal, n_m = jm.merge_batched_device(u, v, s, c, rag.n_regions,
                                              mode="fused")
    ex = np.asarray(jm.exact_saliency_device(u, v, s, c, order,
                                             rag.n_regions))
    want = np.where(np.isnan(ex), np.asarray(sal), -ex)
    st = {}
    o, got, n = tm.merge_batched_device_exact(u, v, s, c, rag.n_regions,
                                              device="cpu", stats=st)
    assert n == n_m
    np.testing.assert_array_equal(_np(o), np.asarray(order))
    np.testing.assert_allclose(_np(got), want, rtol=1e-12, atol=0)
    assert {"t_merge_loop", "t_exact_saliency", "n_supersteps",
            "sal_L"} <= set(st)


@pytest.mark.parametrize("engine", ["native", "py"])
def test_replay_mean_matches(case64, engine):
    data, _, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    order, _, n_m = jm.merge_batched_device(u, v, s, c, rag.n_regions,
                                            mode="fused")
    order = np.asarray(order)[:n_m]
    want = jm.replay_exact_saliency(u, v, s, c, order, engine=engine)
    got = tm.replay_exact_saliency(u, v, s, c, order, engine=engine)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, tm.replay_exact_saliency(u, v, s, c, order, engine="py"),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("engine", ["native", "py"])
@pytest.mark.parametrize("sized", [False, True])
def test_replay_median_matches(case64, engine, sized):
    data, _, rag = case64
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=16)
    order, _, n_m = jm.merge_batched_device_hist(u, v, h, rag.n_regions,
                                                 mode="fused")
    order = np.asarray(order)[:n_m]
    vals = np.asarray(data["pb"], np.float64).ravel()[rag.edge_pixels]
    sizes = rag.sizes if sized else None
    want = jm.replay_exact_saliency_median(u, v, rag.edge_ptr, vals, order,
                                           engine=engine,
                                           region_sizes=sizes)
    got = tm.replay_exact_saliency_median(u, v, rag.edge_ptr, vals, order,
                                          engine=engine, region_sizes=sizes)
    np.testing.assert_array_equal(got, want)
    other = tm.replay_exact_saliency_median(u, v, rag.edge_ptr, vals, order,
                                            engine="py", region_sizes=sizes)
    np.testing.assert_array_equal(got, other)


def test_replay_rejects_unknown_engine(case64):
    data, _, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    with pytest.raises(ValueError, match="native|py"):
        tm.replay_exact_saliency(u, v, s, c, np.zeros((0, 3)), engine="jax")


def test_threshold_cut_and_order_to_keys_match(case):
    data, _, rag = case
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    order, sal, n_m = jm.merge_batched_device(u, v, s, c, rag.n_regions,
                                              mode="fused")
    want_keys = jm.order_to_keys(order, n_m, rag)
    np.testing.assert_array_equal(
        tm.order_to_keys(np.asarray(order), n_m, rag), want_keys)
    np.testing.assert_array_equal(
        tm.order_to_keys(torch.tensor(np.asarray(order)), n_m, rag),
        want_keys)
    stat = -np.asarray(sal)[:n_m]
    for tau in np.quantile(stat, [0.0, 0.3, 0.7, 1.0]):
        want = jm.threshold_cut(want_keys, stat, tau)
        got = tm.threshold_cut(want_keys, stat, tau)
        np.testing.assert_array_equal(got, want)
    assert tm.threshold_cut(np.zeros((0, 3)), np.zeros(0), 0.5).shape == (0,)


@pytest.mark.parametrize("policy", ["mean", "median", "median_minsize"])
def test_greedy_merge_device_matches(case, policy):
    data, _, rag = case
    want_keys, want_sal = jm.greedy_merge_device(rag, data["pb"],
                                                 policy=policy, mode="fused")
    st = {}
    keys, sal = tm.greedy_merge_device(rag, data["pb"], policy=policy,
                                       device="cpu", stats=st)
    assert keys.dtype == np.int64 and len(keys) > 10
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_allclose(sal, np.asarray(want_sal), rtol=1e-12, atol=0)
    assert {"t_merge_loop", "t_exact_saliency", "n_supersteps"} <= set(st)


@pytest.mark.parametrize("kw", [{"exact_saliency": False},
                                {"saliency_engine": "native"},
                                {"saliency_engine": "py"}])
def test_greedy_merge_device_mean_saliency_options(case64, kw):
    data, _, rag = case64
    want_keys, want_sal = jm.greedy_merge_device(rag, data["pb"],
                                                 policy="mean", mode="fused",
                                                 **kw)
    keys, sal = tm.greedy_merge_device(rag, data["pb"], policy="mean",
                                       device="cpu", **kw)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_allclose(sal, np.asarray(want_sal), rtol=1e-12, atol=0)


@pytest.mark.parametrize("mode", ["fused_ms", "chunked"])
def test_unported_modes_raise(case64, mode):
    data, _, rag = case64
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.greedy_merge_device(rag, data["pb"], mode=mode, device="cpu")
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    with pytest.raises(NotImplementedError, match="item 5"):
        tm.merge_batched_device(u, v, s, c, rag.n_regions, mode=mode,
                                device="cpu")


def test_bad_policy_and_mode_raise(case64):
    data, _, rag = case64
    with pytest.raises(ValueError, match="policy"):
        tm.greedy_merge_device(rag, data["pb"], policy="max", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tm.greedy_merge_device(rag, data["pb"], mode="serial", device="cpu")


def test_no_cuda_raises_instead_of_running_on_the_cpu(case64, monkeypatch):
    data, _, rag = case64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.greedy_merge_device(rag, data["pb"])
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.merge_batched_device(u, v, s, c, rag.n_regions)
