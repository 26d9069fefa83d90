"""Port segment reductions vs glia_tpu's.

ops/segment_csr.py (the plain version of the CUDA segment-sum kernel and
its dispatcher) against glia_tpu's Pallas kernel in interpret mode (rtol
1e-3: the TPU kernel multiplies one-hot rows at bf16 input precision),
against jax.ops.segment_sum and numpy (rtol 1e-5 in float32, 1e-12 in
float64); ops/segment.py against glia_tpu.ops.segment on ragged segments
with empty segments and padding ids (rtol 1e-12, float64); the device_bc
engine's ``_segment_sum`` (sorted ids with a dropped tail, unsorted ids
through a stable sort, counts, the dedupe) against the ``index_add_`` it
replaced, bit for bit.  Inputs come from numpy generators with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glia_tpu.ops.segment as jseg
import glia_tpu_torch.ops.segment as tseg
from glia_tpu.ops.pallas.segment_csr import segment_sum_pallas
from glia_tpu.ops.pallas.segment_csr import segment_sum_auto as jax_auto
from glia_tpu_torch.ops.cuda import launches, segment_sum_cuda
from glia_tpu_torch.ops.segment_csr import segment_sum_auto, segment_sum_torch

# (B, F or None for 1-D values, S, chunk of the Pallas kernel)
SHAPES = {"2d": (1000, 4, 37, 256), "1d": (500, None, 10, 128),
          "wide": (300, 32, 300, 128)}
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _inputs(shape, dtype, seed=12345, pad=0.0):
    B, F, S, _ = SHAPES[shape]
    rng = np.random.default_rng(seed)
    vals = rng.random(B if F is None else (B, F)).astype(dtype)
    segs = rng.integers(0, S, B).astype(np.int32)
    if pad:
        segs[rng.random(B) < pad] = S        # padding ids: dropped
    return vals, segs, S


def _numpy_sum(vals, segs, S):
    want = np.zeros((S + 1,) + vals.shape[1:], np.float64)
    np.add.at(want, np.minimum(segs, S), vals.astype(np.float64))
    return want[:S]


@pytest.mark.parametrize("fn", [segment_sum_torch, segment_sum_auto],
                         ids=["plain", "auto"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_segment_sum_matches_xla_and_numpy(shape, dtype, fn):
    vals, segs, S = _inputs(shape, dtype)
    got = fn(torch.from_numpy(vals), torch.from_numpy(segs), S).numpy()
    assert got.dtype == dtype and got.shape == (S,) + vals.shape[1:]
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                         jnp.asarray(segs), num_segments=S))
    np.testing.assert_allclose(got, xla, rtol=RTOL[dtype])
    np.testing.assert_allclose(got, _numpy_sum(vals, segs, S),
                               rtol=RTOL[dtype])
    np.testing.assert_allclose(
        got, np.asarray(jax_auto(jnp.asarray(vals), jnp.asarray(segs), S)),
        rtol=RTOL[dtype])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_segment_sum_matches_pallas_kernel(shape):
    vals, segs, S = _inputs(shape, np.float32, pad=0.1)
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(vals), jnp.asarray(segs), S, chunk=SHAPES[shape][3],
        interpret=True))
    got = segment_sum_auto(torch.from_numpy(vals), torch.from_numpy(segs),
                           S).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_segment_sum_drops_padding(ids_dtype):
    vals = np.ones(10, np.float32)
    segs = np.array([0, 1, 2, 3, 4, 10, 10, 10, 11, -1], ids_dtype)
    got = segment_sum_auto(torch.from_numpy(vals), torch.from_numpy(segs),
                           10).numpy()
    assert got.sum() == 5
    np.testing.assert_array_equal(got[:5], 1.0)
    got2 = segment_sum_torch(torch.ones((10, 3)), torch.from_numpy(segs), 10)
    assert got2.shape == (10, 3) and float(got2.sum()) == 15.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_sorted_ids_give_the_same_result(dtype):
    """Non-decreasing ids through sorted=True: the same bits as the
    unsorted path (index_add_ on the CPU adds in index order), with runs,
    gaps (empty segments) and a padded tail."""
    rng = np.random.default_rng(7)
    B, F = 400, 5
    first = rng.random(B) < 0.4
    first[0] = True
    segs = np.cumsum(first) - 1 + 3          # segments 0..2 stay empty
    segs[-20:] = 10 ** 6                      # padded tail
    vals = rng.random((B, F)).astype(dtype)
    S = B
    a = segment_sum_auto(torch.from_numpy(vals), torch.from_numpy(segs), S,
                         sorted=True).numpy()
    b = segment_sum_torch(torch.from_numpy(vals), torch.from_numpy(segs),
                          S).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, _numpy_sum(vals, segs, S),
                               rtol=RTOL[dtype])
    assert (a[:3] == 0).all()


def test_sorted_flag_is_checked_on_the_cpu():
    with pytest.raises(ValueError, match="decrease"):
        segment_sum_torch(torch.ones(3), torch.tensor([0, 2, 1]), 3,
                          sorted=True)
    with pytest.raises(ValueError, match="seg_ids"):
        segment_sum_torch(torch.ones(3), torch.tensor([0, 1]), 3)


def test_empty_inputs():
    out = segment_sum_auto(torch.zeros((0, 4)), torch.zeros(0,
                           dtype=torch.int64), 6)
    assert out.shape == (6, 4) and float(out.abs().sum()) == 0.0


def test_cuda_wrapper_refuses_cpu_tensors():
    before = dict(launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_sum_cuda(torch.ones((4, 2)), torch.zeros(4,
                         dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_sum_cuda(torch.ones(4), torch.zeros(4, dtype=torch.int64),
                         3, sorted=True)
    assert launches == before
    assert "segment_sum" in launches


def test_auto_rejects_other_devices():
    with pytest.raises(ValueError, match="no segment sum"):
        segment_sum_auto(torch.ones(3, device="meta"),
                         torch.zeros(3, dtype=torch.int64, device="meta"), 2)


# ---------------------------------------------------------------------------
# ops/segment.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged():
    """Values over 40 segments of which some are empty, with 5 % padding
    ids (== num_segments)."""
    rng = np.random.default_rng(11)
    S, B = 40, 900
    ids = rng.choice(np.delete(np.arange(S), [3, 17, 39]), B)
    ids[rng.random(B) < 0.05] = S
    vals = rng.normal(0.3, 1.0, B)
    return vals, ids.astype(np.int32), S


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["segment_sum", "segment_min",
                                  "segment_max"])
def test_segment_reductions_match(ragged, name):
    vals, ids, S = ragged
    want = np.asarray(getattr(jseg, name)(jnp.asarray(vals),
                                          jnp.asarray(ids), S))
    got = getattr(tseg, name)(_t(vals), _t(ids), S).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # 2-D values reduce row-wise
    v2 = np.stack([vals, -2 * vals], axis=1)
    want2 = np.asarray(getattr(jseg, name)(jnp.asarray(v2),
                                           jnp.asarray(ids), S))
    np.testing.assert_allclose(
        getattr(tseg, name)(_t(v2), _t(ids), S).numpy(), want2, rtol=1e-12)


def test_segment_mean_matches(ragged):
    vals, ids, S = ragged
    want = jseg.segment_mean(jnp.asarray(vals), jnp.asarray(ids), S)
    got = tseg.segment_mean(_t(vals), _t(ids), S)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert got[1][3] == 0 and got[0][3] == 0


def test_segment_stats_matches_and_zeroes_empty_segments(ragged):
    vals, ids, S = ragged
    want = jseg.segment_stats(jnp.asarray(vals), jnp.asarray(ids), S)
    got = tseg.segment_stats(_t(vals), _t(ids), S)
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    cnt, _, _, mn, mx = (g.numpy() for g in got)
    assert cnt[3] == 0 and mn[3] == 0 and mx[3] == 0
    assert np.isfinite(mn).all() and np.isfinite(mx).all()


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 1.0, 8), (0.2, 1.0, 5),
                                        (0.5, 2.0, 4)])
def test_segment_histogram_matches(ragged, lo, hi, bins):
    """The reference's binning, including lo > 0, where values inside
    (lo, hi) above every bin bound are dropped."""
    _, ids, S = ragged
    rng = np.random.default_rng(13)
    vals = rng.random(len(ids)) * 1.2 * hi
    vals[:4] = [lo, hi, 0.0, hi * 0.999]
    want = np.asarray(jseg.segment_histogram(
        jnp.asarray(vals), jnp.asarray(ids), S, bins, lo, hi))
    got = tseg.segment_histogram(_t(vals), _t(ids), S, bins, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    if lo > 0:
        assert got.sum() < (ids < S).sum()     # some rows were dropped


def test_segment_median_sorted_matches():
    rng = np.random.default_rng(17)
    lens = np.array([5, 0, 1, 8, 0, 4])
    ptr = np.concatenate([[0], np.cumsum(lens)])
    vals = np.concatenate([np.sort(rng.random(n)) for n in lens])
    want = np.asarray(jseg.segment_median_sorted(jnp.asarray(vals),
                                                 jnp.asarray(ptr)))
    got = tseg.segment_median_sorted(_t(vals), _t(ptr)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == -1.0 and got[4] == -1.0


# ---------------------------------------------------------------------------
# the device_bc engine's sums: routed through segment_sum_auto, the same bits
# as the index_add_ they replace
# ---------------------------------------------------------------------------

def _index_add(src, index, n):
    """The form merge_bc_device._segment_sum had: one index_add_ on zeros
    (every id inside [0, n))."""
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype)
    return out.index_add_(0, index, src)


def _edge_case(dtype, seed=21, E=600, C=90):
    """Edges sorted by lower endpoint with a tail of dead edges, as a
    superstep's dedupe leaves them."""
    rng = np.random.default_rng(seed)
    eu = np.sort(rng.integers(0, C - 1, E))
    ev = eu + 1 + rng.integers(0, 5, E)
    ev = np.minimum(ev, C - 1)
    alive = rng.random(E) < 0.7
    n_tail = 80
    alive[-n_tail:] = False
    e_lo = eu.copy()
    e_lo[-n_tail:] = C                      # dead before the sort: dropped
    vals = rng.normal(0, 1, (E, 4, 7)).astype(dtype)
    return (torch.from_numpy(a) for a in (eu, ev, alive, e_lo, vals))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("site", ["by_lower", "by_upper", "counts",
                                  "dedupe", "dedupe_3d"])
def test_bc_segment_sum_routing_keeps_the_bits(site, dtype):
    from glia_tpu_torch.graph.merge_bc_device import _segment_sum

    C = 90
    eu, ev, alive, e_lo, vals = _edge_case(dtype, C=C)
    am = alive[:, None]
    side = vals[:, 0] + vals[:, 1]
    if site == "by_lower":
        # sorted ids with a dropped tail; dead edges inside a run add zeros
        src = torch.where(am, side, 0.0)
        got = _segment_sum(src, e_lo, C, sorted=True)
        want = _index_add(src, eu, C)
    elif site == "by_upper":
        # unsorted ids through one stable sort
        src = torch.where(am, side, 0.0)
        ids, perm = torch.sort(torch.where(alive, ev, C), stable=True)
        got = _segment_sum(src[perm], ids, C, sorted=True)
        want = _index_add(src, ev, C)
    elif site == "counts":
        src = torch.where(am & (side > 0), 1.0, 0.0).to(vals.dtype)
        got = _segment_sum(src, ev, C)
        want = _index_add(src, ev, C)
    else:
        first = torch.from_numpy(np.random.default_rng(5).random(len(eu))
                                 < 0.6)
        first[0] = True
        seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
        src = torch.where(alive[:, None, None], vals, 0.0)
        if site == "dedupe":
            src = src.reshape(len(eu), -1)
        got = _segment_sum(src, seg_id, len(eu), sorted=True)
        want = _index_add(src, seg_id, len(eu))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
