"""The multi-phase merge's two environment switches, the port against
glia_tpu on the CPU (float64 on both sides, glia_tpu in x64).

- GLIA_MERGE_DEBUG: with a ``stats`` dict, a fused_ms call runs its
  phases one by one, memoized plan too, and records ``phase_s``,
  ``phase_steps``, ``trans_s`` and ``alive_at_transition``.  The
  supersteps and alive counts equal glia_tpu's, list for list, on a
  discovery call and on a memoized one; the rows equal glia_tpu's and
  those of the same call without the switch; the lists of a dict reused
  by a second call hold only that call's entries.  Any non-empty value
  is on ("0" too), unset or empty is off, in both packages.  A call
  without a dict runs as without the switch.
- GLIA_MERGE_NOPACK64: every phase runs the unpacked hop and sort forms;
  rows and saliencies equal glia_tpu's under the same switch and the
  port's without it, on a fresh shape and on a memoized plan.  (The
  plan graphs, keyed by the setting, exist on the card only:
  chip_smoke.py's slice_merge flips the switch there.)

The sections are bench.py's at 96^2 (one phase) and 384^2 (a transition).
"""

import numpy as np
import pytest

import glia_tpu.graph.merge_device as jmd
import glia_tpu_torch.graph.merge_device as md
from glia_tpu_torch.bench import bench_section

SIDES = (96, 384)


@pytest.fixture(scope="module", params=SIDES, ids=lambda s: f"{s}px")
def case(request):
    side = request.param
    data, _, rag = bench_section(side, (side // 14) ** 2)
    return md.edge_mean_arrays(rag, data["pb"]) + (rag.n_regions,)


def _clear_memos():
    jmd._PLAN_MEMO.clear()
    md._PLAN_MEMO.clear()
    md._PLAN_LAST_STEPS.clear()
    md._EXACT_SAL_L.clear()


def _port(case, stats=None):
    u, v, s, c, R = case
    o, sal, n = md.merge_batched_device(u, v, s, c, R, mode="fused_ms",
                                        stats=stats, device="cpu")
    return o[:n].numpy(), sal[:n].numpy(), n


def _glia(case, stats=None):
    u, v, s, c, R = case
    o, sal, n = jmd.merge_batched_device(u, v, s, c, R, mode="fused_ms",
                                         stats=stats)
    return np.asarray(o)[:n], np.asarray(sal)[:n], n


def _lists_agree(st):
    n_phases = len(st["phase_s"])
    assert len(st["phase_steps"]) == n_phases >= 1
    assert len(st.get("trans_s", [])) == len(
        st.get("alive_at_transition", [])) <= n_phases - 1
    assert sum(st["phase_steps"]) == st["n_supersteps"]


def test_debug_lists_match_glia_tpu(case, monkeypatch):
    _clear_memos()
    want = _port(case)
    _clear_memos()
    monkeypatch.setenv("GLIA_MERGE_DEBUG", "1")
    for call in ("discovery", "memoized"):
        st, jst = {}, {}
        got = _port(case, st)
        ref = _glia(case, jst)
        assert st["plan_replayed"] is (call == "memoized"), call
        assert st["plan_graph"] is False
        for k in ("phase_steps", "alive_at_transition"):
            assert st.get(k) == jst.get(k), (call, k, st, jst)
        _lists_agree(st)
        _lists_agree(jst)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    # a dict passed to a second call holds that call's lists only
    again = dict(st)
    _port(case, again)
    assert {k: len(again[k]) for k in md.DEBUG_KEYS if k in again} == \
        {k: len(st[k]) for k in md.DEBUG_KEYS if k in st}


def test_debug_exact_merge_records_discovery_only(case, monkeypatch):
    """merge_batched_device_exact records the lists on its discovery call
    (the multi-phase core) and nothing in its steady state (the plan
    program), as glia_tpu's."""
    u, v, s, c, R = case
    _clear_memos()
    monkeypatch.setenv("GLIA_MERGE_DEBUG", "1")
    seen = []
    for _ in range(2):
        st, jst = {}, {}
        md.merge_batched_device_exact(u, v, s, c, R, stats=st,
                                      device="cpu")
        jmd.merge_batched_device_exact(u, v, s, c, R, stats=jst)
        seen.append(({k for k in md.DEBUG_KEYS if k in st},
                     {k for k in md.DEBUG_KEYS if k in jst}))
    assert seen[0][0] == seen[0][1] and "phase_steps" in seen[0][0]
    assert seen[1] == (set(), set())


@pytest.mark.parametrize("value,on", [(None, False), ("", False),
                                      ("0", True), ("1", True),
                                      ("yes", True)])
def test_debug_switch_values(value, on, monkeypatch):
    data, _, rag = bench_section(96, (96 // 14) ** 2)
    case = md.edge_mean_arrays(rag, data["pb"]) + (rag.n_regions,)
    if value is None:
        monkeypatch.delenv("GLIA_MERGE_DEBUG", raising=False)
    else:
        monkeypatch.setenv("GLIA_MERGE_DEBUG", value)
    st, jst = {}, {}
    _port(case, st)
    _glia(case, jst)
    assert ("phase_steps" in st) is on
    assert ("phase_steps" in jst) is on


def test_debug_call_without_stats_runs_the_plan_program(monkeypatch):
    """No stats dict: the switch changes nothing, so a memoized plan runs
    as the one program and not phase by phase."""
    data, _, rag = bench_section(96, (96 // 14) ** 2)
    case = md.edge_mean_arrays(rag, data["pb"]) + (rag.n_regions,)
    _clear_memos()
    want = _port(case)
    monkeypatch.setenv("GLIA_MERGE_DEBUG", "1")

    def refuse(*a, **k):
        raise AssertionError("ran phase by phase")

    monkeypatch.setattr(md, "_run_phases", refuse)
    got = _port(case)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_nopack64_gives_the_same_merge(case, monkeypatch):
    _clear_memos()
    packed = [_port(case) for _ in range(2)]
    _clear_memos()
    monkeypatch.setenv("GLIA_MERGE_NOPACK64", "1")
    for call in ("fresh shape", "memoized"):
        st = {}
        got = _port(case, st)
        ref = _glia(case)
        assert st["plan_replayed"] is (call == "memoized")
        for a, b in zip(got, packed[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    # the single-phase engine reads the switch too
    u, v, s, c, R = case
    o, sal, n = md.merge_batched_device(u, v, s, c, R, mode="fused",
                                        device="cpu")
    jo, _, jn = jmd.merge_batched_device(u, v, s, c, R, mode="fused")
    assert n == jn
    np.testing.assert_array_equal(o[:n].numpy(), np.asarray(jo)[:n])


@pytest.mark.parametrize("value,packed", [(None, True), ("", True),
                                          ("0", True), ("off", True),
                                          ("1", False), ("true", False)])
def test_nopack64_reads_the_flag_as_glia_tpu(value, packed, monkeypatch):
    if value is None:
        monkeypatch.delenv("GLIA_MERGE_NOPACK64", raising=False)
    else:
        monkeypatch.setenv("GLIA_MERGE_NOPACK64", value)
    assert md._pack64_enabled() is packed is jmd._pack64_enabled()
    st = md._phase_static(md._mean_stat_packed, 1000, 500, 500, 4, False)
    assert st.pack_hr is packed
    # the explicit unpacked form stays unpacked either way
    assert md._phase_static(md._mean_stat_packed, 1000, 500, 500, 4, False,
                            pack_hr=False).pack_hr is False
