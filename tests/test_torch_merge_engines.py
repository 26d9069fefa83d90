"""Port graph/merge_device.py's serial, chunked and multi-phase engines vs
glia_tpu's, and the defaults of the user surface.

Inputs are seeded synthetic slices turned into RAG edge arrays by
glia_tpu: the 64x64 case of tests/test_merge_device.py, the six random
label images of tests/test_fuzz_engines.py, the 192x192 case, and
bench.py's generator (n_cells = (side // 14)**2, seed 11, blur 1.2, noise
0.12, watershed 0.004 on the Gaussian-filtered pb) at 256x256, 512x512
(a multi-phase plan of 2 phases) and 768x768 (3 phases).  Both sides run
on the CPU in float64, glia_tpu jitted as it runs itself.  Required:
identical order rows, merge and superstep counts and capacity buckets;
saliencies at rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import glia_tpu.graph.merge_device as jm
import glia_tpu_torch.graph.merge_device as tm
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.graph.merge import greedy_merge_order
from glia_tpu.graph.rag import build_rag
from glia_tpu.native import watershed_native


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_same_run(got, want, st_got=None, st_want=None):
    (o_g, s_g, n_g), (o_w, s_w, n_w) = got, want
    assert n_g == n_w and n_g > 0
    np.testing.assert_array_equal(_np(o_g), np.asarray(o_w))
    np.testing.assert_allclose(_np(s_g), np.asarray(s_w), rtol=1e-12,
                               atol=0)
    if st_want is not None:
        for k in ("n_supersteps", "buckets", "fallback"):
            assert st_got.get(k) == st_want.get(k), k


def _bench_case(side):
    data = synthetic_em_slice((side, side), n_cells=(side // 14) ** 2,
                              seed=11, blur=1.2, noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    return data, build_rag(seg, contour_only=False)


@pytest.fixture(scope="module")
def case64():
    data = synthetic_em_slice(shape=(64, 64), n_cells=12, seed=33)
    seg = watershed_native(data["pb"], level=0.08)
    return data, build_rag(seg, contour_only=False)


@pytest.fixture(scope="module")
def case192():
    data = synthetic_em_slice((192, 192), n_cells=100, seed=31, blur=1.2,
                              noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0),
                           level=0.004)
    return data, build_rag(seg, contour_only=False)


@pytest.fixture(scope="module")
def bench512():
    return _bench_case(512)


# ---------------------------------------------------------------------------
# the serial engine
# ---------------------------------------------------------------------------

def _fuzz_rag(seed):
    """tests/test_fuzz_engines.py's random label image of ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    pb = rng.random((40, 40)).astype(np.float32)
    seg = watershed_native(ndi.gaussian_filter(pb, rng.uniform(0.5, 2.0)),
                           level=rng.uniform(0.0, 0.1))
    return pb, build_rag(seg, contour_only=False)


@pytest.mark.parametrize("seed", ["case64"] + list(range(6)))
def test_serial_engine_matches(seed, case64):
    """Rows equal and saliencies at rtol 1e-12; the serial host order too
    (the order glia_tpu's own test holds its serial engine to)."""
    if seed == "case64":
        pb, rag = case64[0]["pb"], case64[1]
    else:
        pb, rag = _fuzz_rag(seed)
    u, v, s, c = jm.edge_mean_arrays(rag, pb)
    want = jm.merge_serial_device(u, v, s, c, rag.n_regions)
    got = tm.merge_serial_device(u, v, s, c, rag.n_regions, device="cpu")
    _assert_same_run(got, want)
    o, sal, n = got
    host, host_sal = greedy_merge_order(rag, pb, policy="mean")
    np.testing.assert_array_equal(tm.order_to_keys(o, n, rag), host)
    np.testing.assert_allclose(_np(sal)[:n], host_sal, rtol=1e-12)
    assert (_np(o)[n:] == -1).all()


def test_serial_engine_reads_its_condition_every_few_merges(case64,
                                                            monkeypatch):
    """The loop condition is read every _SERIAL_READ_EVERY merges; the
    iterations past the last merge change nothing."""
    data, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    want = tm.merge_serial_device(u, v, s, c, rag.n_regions, device="cpu")
    for every in (1, 7, 1000):
        monkeypatch.setattr(tm, "_SERIAL_READ_EVERY", every)
        got = tm.merge_serial_device(u, v, s, c, rag.n_regions,
                                     device="cpu")
        assert got[2] == want[2]
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def test_serial_engine_sums_are_order_free(case64, monkeypatch):
    """Every partner sum of the serial engine has at most two non-zero
    addends, so it gives the same bits in any order of addition: here
    the rows are summed in reversed order."""
    data, rag = case64
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    want = tm.merge_serial_device(u, v, s, c, rag.n_regions, device="cpu")
    real = tm.segment_sum_auto
    nonzero = []

    def reversed_sum(values, ids, n, sorted=False):
        nonzero.append(int(torch.bincount(ids[values != 0],
                                          minlength=n).max()))
        return real(values.flip(0), ids.flip(0), n, sorted=sorted)

    monkeypatch.setattr(tm, "segment_sum_auto", reversed_sum)
    got = tm.merge_serial_device(u, v, s, c, rag.n_regions, device="cpu")
    assert max(nonzero) <= 2
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


# ---------------------------------------------------------------------------
# the chunked engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select_rounds", [1, 2])
@pytest.mark.parametrize("policy", ["mean", "median"])
@pytest.mark.parametrize("name", ["64", "192"])
def test_chunked_engine_matches(name, policy, select_rounds, case64,
                                case192):
    data, rag = case64 if name == "64" else case192
    sw, sg = {}, {}
    if policy == "mean":
        u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
        want = jm.merge_batched_device(u, v, s, c, rag.n_regions,
                                       mode="chunked", stats=sw,
                                       select_rounds=select_rounds)
        got = tm.merge_batched_device(u, v, s, c, rag.n_regions,
                                      mode="chunked", stats=sg,
                                      select_rounds=select_rounds,
                                      device="cpu")
    else:
        u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=32)
        want = jm.merge_batched_device_hist(u, v, h, rag.n_regions,
                                            mode="chunked", stats=sw,
                                            select_rounds=select_rounds)
        got = tm.merge_batched_device_hist(u, v, h, rag.n_regions,
                                           mode="chunked", stats=sg,
                                           select_rounds=select_rounds,
                                           device="cpu")
    _assert_same_run(got, want, sg, sw)
    if name == "192":
        assert len(sg["buckets"]) > 1    # the edges were compacted


def test_chunked_engine_refused_for_minsize(case64):
    data, rag = case64
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=8)
    with pytest.raises(ValueError, match="fused|fused_ms"):
        tm.merge_batched_device_hist_minsize(u, v, h, rag.sizes,
                                             rag.n_regions, mode="chunked",
                                             device="cpu")


# ---------------------------------------------------------------------------
# the multi-phase engine
# ---------------------------------------------------------------------------

def _policy_run(mod, policy, data, rag, **kw):
    if policy == "mean":
        u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
        return mod.merge_batched_device(u, v, s, c, rag.n_regions, **kw)
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=32)
    if policy == "median":
        return mod.merge_batched_device_hist(u, v, h, rag.n_regions, **kw)
    return mod.merge_batched_device_hist_minsize(u, v, h, rag.sizes,
                                                 rag.n_regions, **kw)


@pytest.mark.parametrize("policy", ["mean", "median", "median_minsize"])
def test_multiphase_engine_matches(bench512, policy):
    """Two phases at 512x512, then a second call that replays the
    memoized plan: the same rows again."""
    data, rag = bench512
    sw, sg, sg2 = {}, {}, {}
    want = _policy_run(jm, policy, data, rag, mode="fused_ms", stats=sw)
    tm._PLAN_MEMO.clear()
    got = _policy_run(tm, policy, data, rag, mode="fused_ms", stats=sg,
                      device="cpu")
    _assert_same_run(got, want, sg, sw)
    assert len(sg["buckets"]) == 2 and sg["fallback"] is False
    assert len(tm._PLAN_MEMO) == 1
    again = _policy_run(tm, policy, data, rag, mode="fused_ms", stats=sg2,
                        device="cpu")
    _assert_same_run(again, want, sg2, sw)


def test_multiphase_engine_three_phases():
    data, rag = _bench_case(768)
    sw, sg = {}, {}
    want = _policy_run(jm, "mean", data, rag, mode="fused_ms", stats=sw)
    got = _policy_run(tm, "mean", data, rag, mode="fused_ms", stats=sg,
                      device="cpu")
    _assert_same_run(got, want, sg, sw)
    assert len(sg["buckets"]) >= 3


def test_multiphase_fallback_on_tight_plan():
    """glia_tpu's test_multiphase_fallback_on_tight_plan: caps at the
    256 / 128-row floor after one superstep cannot hold the survivors, so
    the engine falls back to the single-phase one (flagged), whose rows
    both packages give."""
    data = synthetic_em_slice((256, 256), n_cells=160, seed=31, blur=1.2,
                              noise=0.12)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0), 0.004)
    rag = build_rag(seg, contour_only=False)
    assert rag.n_edges > 2048
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    R = rag.n_regions
    plan = [(1, 1.0, 1.0), (None, 0.002, 0.002)]
    sc = np.stack([s, c], axis=1)
    sw, sg = {}, {}
    want = jm._fused_multiphase_core(u, v, (jnp.asarray(sc),),
                                     jm._mean_stat_packed, R, 256,
                                     jnp.float64, plan=plan, stats=sw)
    got = tm._fused_multiphase_core(u, v, (torch.as_tensor(sc),),
                                    tm._mean_stat_packed, R, 256,
                                    torch.float64, torch.device("cpu"),
                                    plan=plan, stats=sg)
    assert sg["fallback"] is True and sw["fallback"] is True
    _assert_same_run(got, want, sg, sw)
    fused = tm.merge_batched_device(u, v, s, c, R, mode="fused",
                                    device="cpu")
    _assert_same_run(got, fused)


def test_phase_transition_keeps_edges_and_flags_overflow():
    """The transition compacts live edges in order, renumbers present
    vertices in order, composes the id table and carries vertex sizes;
    capacities too small give the overflow flag."""
    u = torch.tensor([0, 5, 2, 3, 4])
    v = torch.tensor([1, 6, 4, 6, 2])
    alive = torch.tensor([False, True, True, False, True])
    p = (torch.arange(10, dtype=torch.float64).reshape(5, 2),)
    g_prev = torch.tensor([10, 11, 12, 13, 14])      # R_loc_prev = 5
    vsz = (torch.arange(9, dtype=torch.float64),)    # 5 + 4 vertices
    u2, v2, p2, vs2, a2, g2, ovf = tm._phase_transition(
        u, v, p, vsz, alive, g_prev, 3, 5, 100, 4, 4)
    # present: 2, 4, 5, 6 -> 0, 1, 2, 3; 5 and 6 are fresh ids 0 and 1 of
    # the previous phase, globally 100 + 3 + 0 and + 1
    assert not bool(ovf)
    np.testing.assert_array_equal(g2, [12, 14, 103, 104])
    np.testing.assert_array_equal(u2, [2, 0, 1, 0])
    np.testing.assert_array_equal(v2, [3, 1, 0, 0])
    np.testing.assert_array_equal(a2, [True, True, True, False])
    np.testing.assert_array_equal(p2[0][:3], [[2, 3], [4, 5], [8, 9]])
    np.testing.assert_array_equal(vs2[0][:4], [2, 4, 5, 6])
    assert bool(tm._phase_transition(u, v, p, vsz, alive, g_prev, 3, 5,
                                     100, 2, 4)[-1])
    assert bool(tm._phase_transition(u, v, p, vsz, alive, g_prev, 3, 5,
                                     100, 4, 3)[-1])


def test_capacity_rounding_matches():
    for x in (1, 200, 257, 1000, 4097, 9378, 149084, 597140):
        assert tm._cap_quantize(x) == jm._cap_quantize(x)
        assert tm._cap_quantize(x, lo=128, tile=128) == jm._cap_quantize(
            x, lo=128, tile=128)
        assert tm._tile_ceil(x) == jm._tile_ceil(x)


# ---------------------------------------------------------------------------
# the defaults of the user surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["mean", "median", "median_minsize"])
def test_greedy_merge_device_defaults_match(bench512, policy):
    """Default arguments on both sides: mode="fused_ms", exact
    saliencies (the mean on the device, the medians by the host
    replay)."""
    data, rag = bench512
    want_keys, want_sal = jm.greedy_merge_device(rag, data["pb"],
                                                 policy=policy)
    st = {}
    keys, sal = tm.greedy_merge_device(rag, data["pb"], policy=policy,
                                       device="cpu", stats=st)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_allclose(sal, np.asarray(want_sal), rtol=1e-12,
                               atol=0)
    assert len(st["buckets"]) == 2 and st["fallback"] is False


def test_merge_batched_device_exact_default_matches(bench512):
    """A first call on the shape (no plan, no depth capacity memoized):
    the discovery path, whose two stages are timed apart."""
    data, rag = bench512
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    for memo in (tm._PLAN_MEMO, tm._EXACT_SAL_L):
        memo.clear()
    want = jm.merge_batched_device_exact(u, v, s, c, rag.n_regions)
    st = {}
    got = tm.merge_batched_device_exact(u, v, s, c, rag.n_regions,
                                        device="cpu", stats=st)
    _assert_same_run(got, want)
    assert len(st["buckets"]) == 2 and st["fallback"] is False
    assert {"t_merge_loop", "t_exact_saliency", "sal_L"} <= set(st)


@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_greedy_merge_device_other_modes_match(case192, mode):
    data, rag = case192
    want_keys, want_sal = jm.greedy_merge_device(rag, data["pb"],
                                                 policy="mean", mode=mode)
    keys, sal = tm.greedy_merge_device(rag, data["pb"], policy="mean",
                                       mode=mode, device="cpu")
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_allclose(sal, np.asarray(want_sal), rtol=1e-12,
                               atol=0)
