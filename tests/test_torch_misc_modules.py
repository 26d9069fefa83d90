"""Port learn/optim.py (adaptive_gd) and infer/confidence.py
(boundary_confidence) vs glia_tpu's, on the cases of
tests/test_misc_parity.py and tests/test_confidence.py.  Both are host
numpy on both sides: results must be equal, bit for bit.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

import glia_tpu.graph.tree as jt
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.graph.merge import greedy_merge_order
from glia_tpu.graph.rag import build_rag as j_build_rag
from glia_tpu.infer.confidence import boundary_confidence as j_confidence
from glia_tpu.learn.optim import adaptive_gd as j_adaptive_gd
from glia_tpu.native import watershed_native
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.graph.tree import build_tree, node_potentials
from glia_tpu_torch.infer.confidence import boundary_confidence
from glia_tpu_torch.learn.optim import adaptive_gd


@pytest.mark.parametrize("step0", [10.0, 0.01])
def test_adaptive_gd_matches(step0):
    def vg(w):
        return float(np.sum((w - 3.0) ** 2)), 2 * (w - 3.0)

    got = adaptive_gd(vg, np.zeros(4), max_iters=200, step0=step0)
    want = j_adaptive_gd(vg, np.zeros(4), max_iters=200, step0=step0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], 3.0, atol=1e-4)
    # rollback keeps the energies non-increasing
    assert all(b <= a for a, b in zip(got[2], got[2][1:]))


@pytest.fixture(scope="module")
def case():
    data = synthetic_em_slice((40, 40), n_cells=6, seed=8)
    seg = watershed_native(ndi.gaussian_filter(data["pb"], 1.0), 0.02)
    jrag = j_build_rag(seg, contour_only=False)
    order, sals = greedy_merge_order(jrag, data["pb"], policy="median")
    probs = 1.0 - np.clip(-np.asarray(sals), 0, 1)
    return seg, jrag, order, probs


@pytest.mark.parametrize("picks", ["all", "some"])
def test_boundary_confidence_matches(case, picks):
    seg, jrag, order, probs = case
    jtree = jt.build_tree(order)
    tree = build_tree(order)
    pot = node_potentials(tree, probs)
    np.testing.assert_array_equal(pot, jt.node_potentials(jtree, probs))
    np.testing.assert_array_equal(tree.depth_vector(),
                                  jtree.depth_vector())
    chosen = None if picks == "all" else list(range(0, tree.n_nodes, 3))
    got = boundary_confidence(build_rag(seg, contour_only=False), tree, pot,
                              picks=chosen)
    want = j_confidence(jrag, jtree, pot, picks=chosen)
    assert got.shape == seg.shape and (got > 0).any()
    np.testing.assert_array_equal(got, want)
