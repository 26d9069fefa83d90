"""The port's merge/split labels (features/labels.py) against glia_tpu's,
on seeded synthetic slices with glia_tpu's serial merge order.  Tolerance:
exact (labels, scores and truth counts equal).
"""

import numpy as np
import pytest

import glia_tpu.pipeline as jp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features import labels as jlabels
from glia_tpu.graph.rag import build_rag
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.features import labels


@pytest.fixture(scope="module", params=[((64, 64), 12, 3), ((96, 96), 20, 4)])
def case(request):
    shape, cells, seed = request.param
    s = synthetic_em_slice(shape, n_cells=cells, seed=seed)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    order, _ = greedy_merge_native(build_rag(seg, contour_only=False),
                                   s["pb"], policy="median")
    truth = s["truth"].copy()
    truth[:4, :] = 0     # some background, which the counts exclude
    return seg, truth, order


RULES = [dict(rule="vi"), dict(rule="ri"), dict(rule="f1"),
         dict(rule="f1", tweak=True),
         dict(rule="f1", tweak=True, max_prec_drop=0.05),
         dict(rule="f1", exclude_truth=())]


@pytest.mark.parametrize("kw", RULES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_bc_labels_match(case, kw):
    seg, truth, order = case
    got = labels.bc_labels(seg, truth, order, **kw)
    want = jlabels.bc_labels(seg, truth, order, **kw)
    assert len(got[0]) == len(order)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(got[0])) <= {labels.BC_LABEL_MERGE,
                                      labels.BC_LABEL_SPLIT}


def test_node_truth_counts_match(case):
    seg, truth, order = case
    got = labels.node_truth_counts(seg, truth, order)
    want = jlabels.node_truth_counts(seg, truth, order)
    np.testing.assert_array_equal(got[0].keys, want[0].keys)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_unknown_rule_raises(case):
    seg, truth, order = case
    with pytest.raises(ValueError):
        labels.bc_labels(seg, truth, order, rule="dice")
