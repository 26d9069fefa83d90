"""Port the multi-phase merge's steady state (a memoized plan run as one
program) and the plan store vs glia_tpu's plan pipeline and store.

bench.py's generator at 512x512 (a plan of 2 phases) and 768x768 (3
phases), as tests/test_torch_merge_engines.py makes them.  Both sides run
on the CPU in float64, glia_tpu jitted as it runs itself; every test
starts from empty plan memos in both packages.  A second call on a shape
takes glia_tpu's one-jit pipeline and the port's plan program (eager on
the CPU: the code a CUDA graph captures on the card).  glia_tpu's two
calls on each (section, policy) run once for the module, from empty
memos, in threads (``_GLIA_WAVES``), and every test that compares with
them shares them; the port runs on one CPU thread.  Required:
equal rows, saliencies at rtol 1e-12, equal superstep counts, buckets and
fallback flags; after a lowered last-phase count (the port then reruns
the plan eagerly once, raises the count back and runs the next call in
the program), with a count above the need (the same bits), an injected
too-tight plan (both fall back and drop it) and through the plan store
(equal plans and depth capacities, key for key; a fresh load replays; a
corrupt store rediscovers).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import glia_tpu.graph.merge_device as jm
import glia_tpu_torch.graph.merge_device as tm
import glia_tpu_torch.utils.cache as tcache
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.graph.rag import build_rag
from glia_tpu.native import watershed_native
from glia_tpu_torch.ops import cuda as kcuda
from glia_tpu_torch.utils import enable_persistent_cache

POLICIES = ["mean", "median", "median_minsize"]


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
def sections():
    """The sections by side, each made once for the module."""
    return {side: _bench_case(side) for side in (512, 768)}


@pytest.fixture(scope="module", params=[512, 768], ids=["2_phases",
                                                        "3_phases"])
def bench(request, sections):
    return request.param, sections[request.param]


@pytest.fixture(scope="module")
def bench512(sections):
    return sections[512]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's calls here are many small CPU ops, which stall on a
    thread pool shared with other busy processes (a lowered-count case:
    0.2 s alone, 10 s beside eight busy cores): this module runs them on
    one thread, and gives the thread count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _glia_memos_emptied(mp):
    """glia_tpu's plan memos empty and its store unread, on ``mp``."""
    mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    mp.setattr(jm, "_PLAN_MEMO", {})
    mp.setattr(jm, "_EXACT_SAL_L", {})
    mp.setattr(jm, "_PLAN_STORE_LOADED", [True])


@pytest.fixture
def fresh(monkeypatch):
    """Empty plan memos in both packages, and neither reads a store."""
    _glia_memos_emptied(monkeypatch)
    for name in ("_PLAN_MEMO", "_EXACT_SAL_L"):
        monkeypatch.setattr(tm, name, {})
    monkeypatch.setattr(tm, "_PLAN_STORE_LOADED", [None])
    monkeypatch.setattr(tcache, "_store_dir", [None])


# glia_tpu's calls for the module in two waves, the calls of a wave in
# threads so that their jit compiles (most of this file's time) overlap.
# Each wave starts from empty memos; no two calls of a wave share a plan
# memo key (the exact flow's plan is the mean's of its side) or a
# statistic closure that glia_tpu makes on its first use
_GLIA_WAVES = ([(512, p) for p in POLICIES] + [(768, "exact")],
               [(768, p) for p in POLICIES] + [(512, "exact")])


@pytest.fixture(scope="module")
def glia(sections):
    """``glia(side, what)``: glia_tpu's two calls on the section of
    ``side`` from empty memos (what = a policy's fused_ms merge, or
    "exact" for merge_batched_device_exact), as ``_two_calls`` returns
    them; each (side, what) runs once for the module."""
    def calls(side_what):
        side, what = side_what
        run = _runner(what, *sections[side])
        return _two_calls(lambda st: run(jm, st))

    done = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4) as pool:
        for wave in _GLIA_WAVES:
            _glia_memos_emptied(mp)
            done.update(zip(wave, pool.map(calls, wave)))
    return lambda side, what: done[side, what]


def _policy_run(mod, policy, data, rag, **kw):
    if policy == "mean":
        u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
        return mod.merge_batched_device(u, v, s, c, rag.n_regions, **kw)
    u, v, h = jm.edge_hist_arrays(rag, data["pb"], n_bins=32)
    if policy == "median":
        return mod.merge_batched_device_hist(u, v, h, rag.n_regions, **kw)
    return mod.merge_batched_device_hist_minsize(u, v, h, rag.sizes,
                                                 rag.n_regions, **kw)


def _exact_run(mod, data, rag, **kw):
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    return mod.merge_batched_device_exact(u, v, s, c, rag.n_regions, **kw)


def _two_calls(run):
    """``run(stats)`` twice: (first result, first stats, second result,
    second stats)."""
    st1, st2 = {}, {}
    out1 = run(st1)
    out2 = run(st2)
    return out1, st1, out2, st2


@pytest.mark.parametrize("policy", POLICIES)
def test_steady_state_matches_glia_tpu_pipeline(bench, policy, fresh, glia):
    """glia_tpu's second call (its one-jit pipeline) against the port's
    second call (its plan program), and both against their first calls."""
    side, (data, rag) = bench
    want1, sw1, want, sw = glia(side, policy)
    got1, sg1, got, sg = _two_calls(lambda st: _policy_run(
        tm, policy, data, rag, mode="fused_ms", stats=st, device="cpu"))
    assert sg1["plan_replayed"] is False and sg["plan_replayed"] is True
    assert sg["plan_graph"] is False            # eager on the CPU
    assert len(sg["buckets"]) == (2 if side == 512 else 3)
    _assert_same_run(got, want, sg, sw)
    _assert_same_run(got1, want1, sg1, sw1)
    _assert_same_run(got, got1, sg, sg1)


def test_exact_steady_state_matches_glia_tpu_pipeline(bench, fresh, glia):
    """merge_batched_device_exact: the second call is merge and exact
    saliencies as one program on both sides."""
    side, (data, rag) = bench
    want1, sw1, want, sw = glia(side, "exact")
    got1, sg1, got, sg = _two_calls(lambda st: _exact_run(
        tm, data, rag, stats=st, device="cpu"))
    assert {"t_merge_loop", "t_exact_saliency"} <= set(sg1)
    assert "t_plan_program" in sg and "t_merge_loop" not in sg
    assert sg["plan_replayed"] is True and sg["sal_L"] == sg1["sal_L"]
    _assert_same_run(got, want, sg, sw)
    _assert_same_run(got1, want1)
    _assert_same_run(got, got1)


def _runner(what, data, rag):
    """``run(mod, stats, **kw)``: merge_batched_device_exact (``what`` =
    "exact") or a policy's fused_ms merge, on ``mod``."""
    if what == "exact":
        def run(mod, st, **kw):
            return _exact_run(mod, data, rag, stats=st, **kw)
    else:
        def run(mod, st, **kw):
            return _policy_run(mod, what, data, rag, mode="fused_ms",
                               stats=st, **kw)
    return run


def _discover(glia, what, data, rag):
    """glia_tpu's steady-state call (result, stats; the module's), then
    the port's discovery call: (the port's ``run``, glia_tpu's result, its
    stats, the memo entry, the last-phase count the discovery
    measured)."""
    _, _, want, sw = glia(512, what)
    run = _runner(what, data, rag)
    run(tm, {}, device="cpu")
    (entry,) = tm._PLAN_MEMO.values()
    K = entry.last_steps
    assert K >= 1
    return run, want, sw, entry, K


def _assert_eager_rerun(st, entry, K):
    """A call that reran its plan eagerly: every superstep of the call is
    the rerun's, and the memo entry's count is back at K."""
    assert st["plan_replayed"] is True and st["plan_graph"] is False
    assert st["eager_supersteps"] == st["n_supersteps"] >= K
    assert entry.last_steps == K


@pytest.mark.parametrize("lower", ["to_0", "by_1"])
@pytest.mark.parametrize("what", ["median", "exact"])
def test_last_phase_goes_on_past_a_lowered_count(bench512, fresh, glia,
                                                 lower, what):
    """The program runs the last phase for the recorded count only; with
    the count lowered, the program ends with a live edge and the port
    reruns the plan eagerly, its last phase to completion (and the exact
    saliencies at the memoized depth capacity), raising the count once;
    the rows are still glia_tpu's."""
    run, want, sw, entry, K = _discover(glia, what, *bench512)
    entry.last_steps = 0 if lower == "to_0" else K - 1
    sg = {}
    got = run(tm, sg, device="cpu")
    _assert_eager_rerun(sg, entry, K)
    _assert_same_run(got, want, sg, sw)


@pytest.mark.parametrize("what", ["exact", "mean", "median"])
def test_a_lowered_count_goes_eager_once_then_runs_in_the_program(
        bench512, fresh, glia, what):
    """With the memoized count one short, the next call reruns the plan
    eagerly and raises the count back; the call after it runs every
    superstep in the program, with no eager superstep, and returns
    glia_tpu's rows and saliencies."""
    run, want, sw, entry, K = _discover(glia, what, *bench512)
    entry.last_steps = K - 1
    st1, st2 = {}, {}
    first = run(tm, st1, device="cpu")
    _assert_eager_rerun(st1, entry, K)
    got = run(tm, st2, device="cpu")
    assert st2["plan_replayed"] is True and st2["eager_supersteps"] == 0
    assert entry.last_steps == K
    _assert_same_run(got, want, st2, sw)
    _assert_same_run(first, want, st1, sw)


@pytest.mark.parametrize("what", ["exact", "mean", "median"])
def test_a_count_above_the_need_changes_nothing_and_stays(bench512, fresh,
                                                          glia, what):
    """The last phase run for K + 2 supersteps where the data needs K:
    the same rows, saliencies (bit for bit) and superstep count as at K,
    so the guarded supersteps past the need are no-ops; and a call that
    needed fewer supersteps leaves the count where it was."""
    run, want, sw, entry, K = _discover(glia, what, *bench512)
    st_k, st_a = {}, {}
    at_k = run(tm, st_k, device="cpu")
    entry.last_steps = K + 2
    above = run(tm, st_a, device="cpu")
    assert st_a["plan_replayed"] is True and st_a["eager_supersteps"] == 0
    assert st_a["n_supersteps"] == st_k["n_supersteps"]
    assert above[2] == at_k[2]
    np.testing.assert_array_equal(_np(above[0]), _np(at_k[0]))
    np.testing.assert_array_equal(_np(above[1]), _np(at_k[1]))
    _assert_same_run(above, want, st_a, sw)
    assert entry.last_steps == K + 2


def test_an_explicit_plan_leaves_the_count(bench512, fresh, glia):
    """An explicit plan (here the memoized one, passed in) is rerun
    eagerly, its last phase to completion, and leaves the memo entry's
    count as it was."""
    data, rag = bench512
    _, want, sw, entry, K = _discover(glia, "mean", data, rag)
    entry.last_steps = K - 1
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    sc = torch.stack([torch.as_tensor(s, dtype=torch.float64),
                      torch.as_tensor(c, dtype=torch.float64)], dim=1)
    st = {}
    got = tm._fused_multiphase_core(
        u, v, (sc,), tm._mean_stat_packed, rag.n_regions, 256,
        torch.float64, torch.device("cpu"), plan=entry.phases, stats=st)
    assert st["plan_replayed"] is False
    assert st["eager_supersteps"] == st["n_supersteps"] >= 1
    assert entry.last_steps == K - 1
    _assert_same_run(got, want, st, sw)


def _tight_plan(rag):
    """A plan whose second phase (256 edge rows, 128 regions) cannot hold
    the frontier left after one superstep."""
    return [(1, rag.n_edges, rag.n_regions), (None, 256, 128)]


def test_injected_tight_plan_falls_back_on_both(bench512, fresh):
    """The same too-tight memo entry in both packages: both fall back to
    the single-phase engine with equal rows and drop the entry."""
    data, rag = bench512
    E, R = rag.n_edges, rag.n_regions
    jkey = (E, R, jm._mean_stat_packed, ((2, "float64"),), 4,
            str(jnp.float64), False)
    tkey = (E, R, tm._mean_stat_packed, ((2, "float64"),), 4, "float64",
            False)
    jm._PLAN_MEMO[jkey] = _tight_plan(rag)
    tm._PLAN_MEMO[tkey] = tm._Plan(_tight_plan(rag), 3)
    sw, sg = {}, {}
    want = _policy_run(jm, "mean", data, rag, mode="fused_ms", stats=sw)
    got = _policy_run(tm, "mean", data, rag, mode="fused_ms", stats=sg,
                      device="cpu")
    assert sw["fallback"] is True and sg["fallback"] is True
    _assert_same_run(got, want, sg, sw)
    assert jkey not in jm._PLAN_MEMO and tkey not in tm._PLAN_MEMO


def test_injected_tight_plan_rediscovers_the_exact_flow(bench512, fresh):
    """merge_batched_device_exact with a too-tight plan and a depth
    capacity memoized: both drop them and discover, with equal rows,
    counters and new plans."""
    data, rag = bench512
    E, R = rag.n_edges, rag.n_regions
    M = max(R - 1, 1)
    jkey = (E, R, jm._mean_stat_packed, ((2, "float64"),), 4,
            str(jnp.float64), False)
    tkey = (E, R, tm._mean_stat_packed, ((2, "float64"),), 4, "float64",
            False)
    jm._PLAN_MEMO[jkey] = _tight_plan(rag)
    jm._EXACT_SAL_L[(E, M, R, str(jnp.float64))] = 8
    tm._PLAN_MEMO[tkey] = tm._Plan(_tight_plan(rag))
    tm._EXACT_SAL_L[(E, M, R, "float64")] = 8
    sw, sg = {}, {}
    want = _exact_run(jm, data, rag, stats=sw)
    got = _exact_run(tm, data, rag, stats=sg, device="cpu")
    _assert_same_run(got, want, sg, sw)
    assert sg["plan_replayed"] is False
    assert [tuple(e) for e in tm._PLAN_MEMO[tkey].phases] == [
        tuple(e) for e in jm._PLAN_MEMO[jkey]]
    assert tm._PLAN_MEMO[tkey].phases != _tight_plan(rag)


def _store(path):
    with open(path) as f:
        return json.load(f)


def _jax_key(k):
    """A glia_tpu store key with its dtype spelled as numpy's: glia_tpu
    writes str() of the jnp type ("<class 'jax.numpy.float64'>")."""
    return json.dumps([x.replace("<class 'jax.numpy.", "").rstrip("'>")
                       if isinstance(x, str) else x for x in json.loads(k)])


def test_plan_store_matches_glia_tpu(bench512, fresh, monkeypatch,
                                     tmp_path):
    """Both packages write their stores after the same calls (the exact
    flow and a mean merge at dmax 3 persist; the median's closure plans
    do not): equal plans and depth capacities, key for key."""
    data, rag = bench512
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    assert enable_persistent_cache(str(tmp_path / "port")) == str(
        tmp_path / "port")
    u, v, s, c = jm.edge_mean_arrays(rag, data["pb"])
    R = rag.n_regions
    jm.merge_batched_device_exact(u, v, s, c, R)
    jm.merge_batched_device(u, v, s, c, R, mode="fused_ms", dmax=3)
    _policy_run(jm, "median", data, rag, mode="fused_ms")
    tm.merge_batched_device_exact(u, v, s, c, R, device="cpu")
    tm.merge_batched_device(u, v, s, c, R, mode="fused_ms", dmax=3,
                            device="cpu")
    _policy_run(tm, "median", data, rag, mode="fused_ms", device="cpu")
    want = _store(tmp_path / "jax" / "glia_plan_memo.json")
    got = _store(tmp_path / "port" / "glia_plan_memo.json")
    assert len(got["plans"]) == 2 and len(got["sal_L"]) == 1
    assert got["plans"] == {_jax_key(k): p for k, p in want["plans"].items()}
    assert got["sal_L"] == {_jax_key(k): L for k, L in want["sal_L"].items()}


def _reload(monkeypatch):
    """A fresh process's memos: empty, the store not yet read."""
    for name in ("_PLAN_MEMO", "_EXACT_SAL_L"):
        monkeypatch.setattr(tm, name, {})
    monkeypatch.setattr(tm, "_PLAN_STORE_LOADED", [None])


def test_plan_store_replays_after_a_fresh_load(bench512, fresh, monkeypatch,
                                               tmp_path):
    """A new process's first exact call replays the stored plan and depth
    capacity (with no recorded last-phase count, the plan is rerun
    eagerly), records the count, and gives the first process's rows."""
    data, rag = bench512
    enable_persistent_cache(str(tmp_path))
    first = {}
    want = _exact_run(tm, data, rag, stats=first, device="cpu")
    assert first["plan_replayed"] is False
    _reload(monkeypatch)
    st = {}
    got = _exact_run(tm, data, rag, stats=st, device="cpu")
    assert st["plan_replayed"] is True and st["fallback"] is False
    assert "t_plan_program" in st
    assert st["eager_supersteps"] == st["n_supersteps"]
    _assert_same_run(got, want, st, first)
    (entry,) = tm._PLAN_MEMO.values()
    assert entry.last_steps >= 1


@pytest.mark.parametrize("content", ["{not json", '{"plans": {"[1, 2]": 5}}',
                                     '{"plans": [], "sal_L": 3}'],
                         ids=["not_json", "bad_key", "bad_layout"])
def test_corrupt_plan_store_rediscovers(bench512, fresh, monkeypatch,
                                        tmp_path, content):
    data, rag = bench512
    enable_persistent_cache(str(tmp_path))
    want = _exact_run(tm, data, rag, device="cpu")
    (tmp_path / "glia_plan_memo.json").write_text(content)
    _reload(monkeypatch)
    st = {}
    got = _exact_run(tm, data, rag, stats=st, device="cpu")
    assert st["plan_replayed"] is False and st["fallback"] is False
    _assert_same_run(got, want)
    # the rediscovered plan is written over the corrupt store
    assert len(_store(tmp_path / "glia_plan_memo.json")["plans"]) == 1


def test_no_store_without_enable(bench512, fresh):
    """Plans stay in memory until enable_persistent_cache names a
    directory; the default directory is under the repository's .build/."""
    _exact_run(tm, bench512[0], bench512[1], device="cpu")
    assert tm._plan_store_path() is None and len(tm._PLAN_MEMO) == 1
    assert tcache.REPO_CACHE.split("/")[-3:] == [".build", "glia_tpu_torch",
                                                 "plan_cache"]


def test_graph_launch_tally(monkeypatch):
    """A launch made while a graph captures counts into the capture's
    tally, and each replay adds the tally to the launch counts; outside
    a tally a capture counts nowhere."""
    kcuda.reset_launches()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with kcuda.graph_launch_tally() as tally:
        kcuda._count_launch("segment_sum")
        kcuda._count_launch("segment_sum")
    kcuda._count_launch("segment_sum")
    assert tally == {"forest_votes": 0, "segment_sum": 2}
    assert kcuda.launches["segment_sum"] == 0
    for _ in range(3):
        kcuda.count_graph_replay(tally)
    assert kcuda.launches == {"forest_votes": 0, "segment_sum": 6}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    kcuda._count_launch("forest_votes")
    assert kcuda.launches["forest_votes"] == 1
    kcuda.reset_launches()
