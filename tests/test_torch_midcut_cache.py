"""glia_tpu_torch.examples.bench_bc_midcut's serial-order cache and its
two switches, as tools/bench_bc_midcut.py has them (:93-137), on the CPU.

- GLIA_MIDCUT_SERIAL_ONLY stops after the serial order: no rows;
- GLIA_MIDCUT_PY_SERIAL runs the Python serial engine, whose order and
  probabilities equal the C++ engine's (the section of
  tests/test_merge_bc.py's engine check, 192^2);
- the order is cached on disk only above CACHE_MIN_EDGES edges, under
  the port's own version token, and read back from there; the tests point
  the cache at a temporary directory.
"""

import os

import numpy as np
import pytest

from glia_tpu_torch.examples import bench_bc_midcut as mc
from glia_tpu_torch.examples.bench_bc_device import (bc_test_section,
                                                     training_forest)

SIDE, CELLS, TREES, SEED = 192, 50, 30, 5


@pytest.fixture(scope="module")
def case():
    model, _ = training_forest(128, 25, TREES)
    _, _, rag, cfg = bc_test_section(SIDE, CELLS, seed=SEED)
    return rag, cfg, model


def _serial(case):
    rag, cfg, model = case
    return mc.serial_order(rag, cfg, model, SIDE, CELLS, TREES, SEED)


def test_python_serial_engine_gives_the_native_order(case, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(mc, "CACHE_DIR", str(tmp_path))
    order_n, probs_n = _serial(case)
    monkeypatch.setenv("GLIA_MIDCUT_PY_SERIAL", "1")
    order_py, probs_py = _serial(case)
    assert len(order_n) == len(order_py) > 0
    np.testing.assert_array_equal(np.asarray(order_py), order_n)
    np.testing.assert_array_equal(np.asarray(probs_py), probs_n)
    assert os.listdir(tmp_path) == []


def test_cache_is_written_and_read_above_the_threshold(case, monkeypatch,
                                                      tmp_path):
    rag = case[0]
    assert rag.n_edges <= mc.CACHE_MIN_EDGES
    monkeypatch.setattr(mc, "CACHE_DIR", str(tmp_path))
    want = _serial(case)
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(mc, "CACHE_MIN_EDGES", rag.n_edges - 1)
    first = _serial(case)
    name = (f".cache_midcut_{mc.CACHE_VERSION}_{SIDE}_{CELLS}_{TREES}_"
            f"{SEED}.npz")
    assert os.listdir(tmp_path) == [name]
    assert mc.CACHE_VERSION != "v2"    # never glia_tpu's token

    def refuse(*a, **k):
        raise AssertionError("the serial engine ran again")

    monkeypatch.setattr("glia_tpu_torch.native.greedy_merge_bc_native",
                        refuse)
    again = _serial(case)
    for a, b, c in zip(want, first, again):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)


def test_serial_only_returns_no_rows(monkeypatch, tmp_path):
    monkeypatch.setattr(mc, "CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("GLIA_MIDCUT_SERIAL_ONLY", "1")

    def refuse(*a, **k):
        raise AssertionError("the device order ran")

    monkeypatch.setattr("glia_tpu_torch.graph.merge_bc_device."
                        "merge_order_bc_device", refuse)
    assert mc.bc_midcut_compare(128, 60, 40, device="cpu") == []
