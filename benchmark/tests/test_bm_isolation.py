"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.

Top-level module names are compared whole: ``glia_tpu_torch`` (the port,
the system under test) is not ``glia_tpu``.  Two checks: an AST scan of
every module under benchmark/ for ``import`` statements, and a child
process that imports everything ``run.py`` and the reference import and
lists the loaded modules.
"""

import ast
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "glia_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def _roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    assert len(FILES) > 15
    bad = {(p.relative_to(ROOT).as_posix(), r) for p in FILES
           for r in _roots(p) if r in FORBIDDEN}
    assert not bad


def _strings(path):
    """String constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_file_names_a_file_of_the_jax_package_or_root_bench():
    for p in FILES:
        if p == pathlib.Path(__file__).resolve():
            continue
        for s in _strings(p):
            s = s.replace("glia_tpu_torch", "")
            assert "glia_tpu/" not in s and not s.endswith("bench.py"), (
                p, s)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = _loaded(
        "import sys, json; sys.path.insert(0, '.'); "
        "import benchmark.run as r; r.fixed_cache_dirs(); "
        "from benchmark.core.registry import Registry; reg = Registry(); "
        "[reg.module(k, n) for k in ('drivers', 'end_to_end', "
        "'layer_metrics') for n in reg.names(k, '.py')]; "
        "import glia_tpu_torch.graph.merge_device; "
        "import glia_tpu_torch.ops.cuda, benchmark.control; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "glia_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_and_inputs_load_nothing_of_the_program():
    names = _loaded(
        "import sys, json; sys.path.insert(0, '.'); "
        "import benchmark.reference.merge, benchmark.inputs.sections; "
        "import benchmark.inputs.synthetic, benchmark.control; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "benchmark" in names
    assert not names & (FORBIDDEN | {"glia_tpu_torch"})


def test_reference_sources_name_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")) + sorted(
            (BENCH / "inputs").rglob("*.py")):
        assert "glia_tpu_torch" not in set(_roots(p)), p
