"""The port and its chip smoke script import nothing of JAX or glia_tpu,
nor sklearn or optax, which the card machine does not have.

An AST scan of every module of glia_tpu_torch/ and of chip_smoke.py for
``import``/``from`` statements (at any depth, relative imports resolved)
naming jax, jaxlib, glia_tpu, sklearn or optax.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "glia_tpu", "sklearn", "optax"}
FILES = sorted((ROOT / "glia_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    package = path.relative_to(ROOT).parts[:-1]
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                yield (base[0] if base else ""), node.lineno
            else:
                yield node.module.split(".")[0], node.lineno


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "glia_tpu_torch/models/forest.py" in names
    assert "glia_tpu_torch/ops/cuda/__init__.py" in names
    for new in ("graph/merge_device.py", "ops/segment.py",
                "ops/segment_csr.py", "features/hierarchical.py",
                "native/__init__.py", "pipeline.py", "constants.py",
                "graph/tree.py", "learn/sshmt.py", "learn/dnf.py",
                "learn/predict.py", "learn/samplers.py", "models/mlp.py",
                "models/train_ensemble.py", "infer/ccm.py",
                "features/labels.py", "models/ensemble.py",
                "models/rf_legacy.py", "tools.py", "graph/merge_bc.py",
                "features/serialize.py", "metrics/device.py",
                "ops/tree_scan.py", "learn/optim.py",
                "infer/confidence.py"):
        assert f"glia_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_glia_tpu_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
