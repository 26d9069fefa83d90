"""The port's copy of the C++ host runtime vs glia_tpu.native.

Watershed, the serial pre-merge, connected components and the exact
saliency replays of the port's own build of ``native/src/glia_native.cc`` against glia_tpu's build of the
same functions, on seeded synthetic slices.  Tolerance: exact.
"""

import numpy as np
import pytest

import glia_tpu.native as jn
import glia_tpu.pipeline as jp
import glia_tpu_torch.native as tn
import glia_tpu_torch.pipeline as tp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu_torch.data.synthetic import synthetic_em_slice as port_slice
from glia_tpu_torch.graph.rag import build_rag


CASES = [((64, 64), 12, 3), ((96, 96), 20, 4)]


@pytest.fixture(scope="module", params=CASES)
def data(request):
    shape, cells, seed = request.param
    return synthetic_em_slice(shape, n_cells=cells, seed=seed)


@pytest.mark.parametrize("shape,cells,seed", CASES)
def test_synthetic_slice_copy_matches(shape, cells, seed):
    want = synthetic_em_slice(shape, n_cells=cells, seed=seed)
    got = port_slice(shape, n_cells=cells, seed=seed)
    for k in ("truth", "pb", "intensity"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("level", [0.0, 0.05])
def test_watershed_matches(data, level):
    np.testing.assert_array_equal(tn.watershed_native(data["pb"], level),
                                  jn.watershed_native(data["pb"], level))


def test_pre_merge_matches(data):
    seg = tp.watershed(data["pb"], 0.05)
    rag = build_rag(seg, contour_only=False)
    got = tn.pre_merge_native(rag, data["pb"], (30, 60), 0.4)
    want = jn.pre_merge_native(jp.build_rag(seg, contour_only=False),
                               data["pb"], (30, 60), 0.4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(tp.pre_merge(seg, data["pb"], (30,)),
                                  jp.pre_merge(seg, data["pb"], (30,)))


def test_connected_components_matches(data):
    labels = (data["pb"] > 0.5).astype(np.int32)
    mask = (data["intensity"] > 0.2).astype(np.int32)
    for m in (None, mask):
        np.testing.assert_array_equal(
            tn.connected_components_native(labels, m),
            jn.connected_components_native(labels, m))


def _replay_inputs(data):
    """Edge arrays of the slice's RAG and a serial host merge order in
    dense ids, for the mean and the median policies."""
    from glia_tpu.graph.merge_device import edge_mean_arrays

    seg = jp.watershed(data["pb"], 0.05)
    rag = jp.build_rag(seg, contour_only=False)
    u, v, s, c = edge_mean_arrays(rag, data["pb"])
    R, max_key = rag.n_regions, int(rag.keys.max())

    def dense(order):
        return np.where(order <= max_key,
                        rag.key_index(np.minimum(order, max_key)),
                        R + order - max_key - 1)

    return rag, (u, v, s, c), dense


def test_replay_saliency_native_matches(data):
    rag, (u, v, s, c), dense = _replay_inputs(data)
    order, sal = jn.greedy_merge_native(rag, data["pb"], policy="mean")
    order = dense(order)
    hi = int(order.max()) + 1
    got = tn.replay_saliency_native(u, v, s, c, order, hi)
    want = jn.replay_saliency_native(u, v, s, c, order, hi)
    np.testing.assert_array_equal(got, want)
    # on its own order the replay is the serial engine's pop-time value
    np.testing.assert_allclose(got, -sal, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("policy,sized", [("median", False),
                                          ("median_minsize", True)])
def test_replay_saliency_median_native_matches(data, policy, sized):
    rag, (u, v, _, _), dense = _replay_inputs(data)
    order, sal = jn.greedy_merge_native(rag, data["pb"], policy=policy)
    order = dense(order)
    hi = int(order.max()) + 1
    vals = np.asarray(data["pb"], np.float64).ravel()[rag.edge_pixels]
    sizes = rag.sizes if sized else None
    got = tn.replay_saliency_median_native(u, v, rag.edge_ptr, vals, order,
                                           hi, region_sizes=sizes)
    want = jn.replay_saliency_median_native(u, v, rag.edge_ptr, vals, order,
                                            hi, region_sizes=sizes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, -sal)
