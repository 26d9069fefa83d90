"""The port's copy of the C++ host runtime vs glia_tpu.native.

Watershed, the serial pre-merge and connected components of the port's
own build of ``native/src/glia_native.cc`` against glia_tpu's build of the
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
