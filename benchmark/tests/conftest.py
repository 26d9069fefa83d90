"""The benchmark's own tests (``python -m pytest benchmark/tests`` from the
root of the repository).  This file imports no JAX.  Tests that need the
CUDA card carry the ``card`` marker and skip without one: the ``card``
fixture decides, at run time, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
