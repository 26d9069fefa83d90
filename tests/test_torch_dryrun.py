"""The port's entry points of the sharded path: ``spawn_ranks`` (results
in rank order; a failing or hanging rank fails the call and no rank
outlives it), ``make_mesh``, ``dryrun.entry`` against
``__graft_entry__.entry`` and ``dryrun.dryrun_multichip`` on CPU ranks;
and that each needs a card by default."""

import multiprocessing

import numpy as np
import pytest
import torch

import jax

from glia_tpu_torch import dryrun
from glia_tpu_torch.parallel.launch import spawn_ranks
from glia_tpu_torch.parallel.mesh import make_mesh, rank_device

import torch_parallel_ranks as ranks


def test_spawn_ranks_returns_in_rank_order():
    out = spawn_ranks(ranks.rank_info, 3, "gloo", "cpu", timeout_s=120)
    assert [o["rank"] for o in out] == [0, 1, 2]
    assert all(o["world"] == 3 and o["psum"] == 3 and o["device"] == "cpu"
               and o["backend"] == "gloo" and o["threads"] == 1
               for o in out)
    assert not multiprocessing.active_children()


def test_spawn_ranks_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(ranks.rank_info, 2, "gloo", "cpu", args=(1,),
                    timeout_s=120)
    assert not multiprocessing.active_children()


def test_spawn_ranks_times_out_on_a_hang():
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.rank_info, 2, "gloo", "cpu", args=(None, 0),
                    timeout_s=8)
    assert not multiprocessing.active_children()


def test_mesh_needs_a_process_group_and_a_card_by_default():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    assert rank_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rank_device(None, 0)


def test_entry_matches_graft_entry():
    from __graft_entry__ import entry as jx_entry

    jfn, jargs = jx_entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = dryrun.entry(device="cpu")
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args).numpy()
    assert got.shape == want.shape and want.shape[0] > 5000
    assert np.isfinite(got).all()
    # float32 context sums added in another order, then log-compressed
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_dryrun_multichip_on_cpu_ranks(capsys):
    rep = dryrun.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "backend gloo" in out and "sharded BC tree features ok" in out
    assert rep["backend"] == "gloo" and rep["world"] == 2
    assert rep["n_regions"] == 4177 and rep["n_edges"] == 9941
    assert rep["losses"][-1] < rep["loss"]
    assert rep["grad_rel"] < 1e-5 and rep["cut_vi"] == 0.0
    assert rep["merges"] > 4000
    assert not multiprocessing.active_children()


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    assert dryrun.default_backend(4, torch.device("cpu")) == "gloo"
