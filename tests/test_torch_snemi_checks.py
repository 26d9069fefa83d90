"""glia_tpu_torch.examples.snemi_checks on the CPU at a small size
(4 x 128 x 128 voxels, 16 cells; gloo ranks): two runs of the config #5
chain give the same bits, the sharded merge's rows equal the fused
engine's in float64, the exact saliencies equal the C++ replay, and the
halo step of a package tree runs in its own process on the pickled block
with the loss of the step in this process."""

import os

import numpy as np
import pytest

from glia_tpu_torch.examples import run_snemi_sharded as shd
from glia_tpu_torch.examples import snemi, snemi_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vol():
    return snemi.make_volume(4, 128, 16)


@pytest.fixture(scope="module")
def runs(vol):
    return snemi_checks.two_runs(vol, "cpu")


def test_two_runs_give_the_same_bits(runs):
    ident = runs["identical"]
    assert ident["losses_all_steps"] and ident["weights"] and ident["probs"]
    assert ident["rows"] and ident["exact"] and all(ident["cuts"])
    assert all(ident["cut_rows"].values())
    assert len(runs["e2e_0"]["losses"]) == 40


def test_merge_checks_a_and_b(vol, runs):
    res = snemi_checks.merge_checks(vol, runs["arrays"], "cpu")
    assert res["a_rows_equal_fused_f64"]
    assert res["merges"] == res["fused_merges"] > 0
    assert res["b_exact_rel_gap_vs_replay"] <= 1e-12


def test_halo_step_of_a_tree_in_its_own_process(vol):
    (res,) = snemi_checks.halo_step_by_tree(vol, [REPO], "cpu")
    assert res["package"] == os.path.join(REPO, "glia_tpu_torch",
                                          "__init__.py")
    assert len(res["steps_s"]) == shd.STEADY_STEPS and res["step_s"] > 0
    assert res["batch_s"] is not None
    sh = shd.snemi_sharded(vol, shards=8, device="cpu", timeout_s=300)
    # world 1, random labels of seed 0 on both sides: the same first loss
    assert np.isclose(res["loss_first"], sh["loss_first"], rtol=0,
                      atol=0)
