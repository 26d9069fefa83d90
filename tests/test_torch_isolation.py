"""The port and its chip smoke script import nothing of JAX or glia_tpu,
nor sklearn, optax or orbax, which the card machine does not have.

An AST scan of every module of glia_tpu_torch/ and of chip_smoke.py for
``import``/``from`` statements (at any depth, relative imports resolved)
naming jax, jaxlib, glia_tpu, sklearn, optax or orbax.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "glia_tpu", "sklearn", "optax", "orbax"}
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
                "infer/confidence.py", "features/adv_shape.py",
                "graph/merge.py", "link3d/link.py", "pipeline3d.py",
                "io/text.py", "io/image.py", "ops/image.py",
                "cli/main.py", "ops/pack.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/launch.py",
                "parallel/partition.py", "parallel/rag_shard.py",
                "parallel/halo.py", "parallel/train.py",
                "parallel/merge_shard.py", "parallel/bc_tree_shard.py",
                "dryrun.py", "utils/__init__.py", "utils/profiling.py",
                "utils/checkpoint.py", "utils/jobs.py",
                "examples/run_hmt_512.py", "utils/cache.py",
                "features/__init__.py", "graph/__init__.py",
                "infer/__init__.py", "metrics/__init__.py",
                "models/__init__.py", "learn/__init__.py",
                "ops/__init__.py", "__init__.py",
                "examples/merge_steady_state.py"):
        assert f"glia_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_glia_tpu_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_subpackage_builds_nothing():
    """A fresh interpreter imports the port's root and every subpackage
    (their exports included) without importing JAX or glia_tpu,
    initializing CUDA or loading a kernel library."""
    import subprocess
    import sys

    code = (
        "import sys, importlib, torch\n"
        "subs = ['', '.features', '.graph', '.infer', '.metrics', "
        "'.models', '.learn', '.ops', '.utils', '.io', '.link3d', "
        "'.parallel', '.data', '.cli', '.constants', '.ops.cuda']\n"
        "for s in subs:\n"
        "    importlib.import_module('glia_tpu_torch' + s)\n"
        "from glia_tpu_torch.ops import cuda\n"
        "assert not cuda._libs, cuda._libs\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'glia_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
