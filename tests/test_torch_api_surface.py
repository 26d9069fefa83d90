"""glia_tpu's public surface in the port: every name a glia_tpu
subpackage exports (its ``__init__``'s imports, and the root's
``constants``) resolves in the port's counterpart to the port's own
object, apart from JAX-only names, listed with the port's counterpart
under its own name.  Then the host functions the port copied for that
surface against glia_tpu's on seeded inputs: the merge-tree helpers,
subset-inclusion tree resolution, image and region-set VI, the per-merge
label loop (also against the port's vectorised ``bc_labels``) and the
legacy forest writer (byte-equal files).  Tolerance: exact, but the
label loop's scores against the vectorised ones (rtol 1e-9, as
glia_tpu's own test holds its two).
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest

import glia_tpu.pipeline as jp
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features import labels as jlabels
from glia_tpu.graph import tree as jtree
from glia_tpu.graph.rag import build_rag
from glia_tpu.infer import greedy as jgreedy
from glia_tpu.metrics import vi as jvi
from glia_tpu.models import forest as jforest
from glia_tpu.models import rf_legacy as jlegacy
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.features import labels as tlabels
from glia_tpu_torch.graph import tree as ttree
from glia_tpu_torch.infer import greedy as tgreedy
from glia_tpu_torch.metrics import vi as tvi
from glia_tpu_torch.models import forest as tforest
from glia_tpu_torch.models import rf_legacy as tlegacy

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "features", "graph", "infer", "metrics", "models",
               "learn", "ops", "utils", "io", "link3d", "parallel", "cli"]
# names glia_tpu exports that only JAX gives meaning to, and the port's
# counterpart of each, under its own name
JAX_ONLY = {("models", "make_predict_votes_jax"): "forest_votes"}


def _exports(sub):
    """The names glia_tpu's ``sub/__init__.py`` imports (its exports)."""
    path = ROOT / "glia_tpu" / sub / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names]
    return names


EXPORTS = [(sub, name) for sub in SUBPACKAGES for name in _exports(sub)]


def test_the_surface_is_read_whole():
    assert len(EXPORTS) > 120
    assert ("utils", "enable_persistent_cache") in EXPORTS
    assert ("", "constants") in EXPORTS
    assert set(JAX_ONLY) <= set(EXPORTS)


@pytest.mark.parametrize("sub,name", EXPORTS,
                         ids=[f"{s or 'root'}.{n}" for s, n in EXPORTS])
def test_glia_tpu_export_resolves_in_the_port(sub, name):
    mod = importlib.import_module("glia_tpu_torch" + (f".{sub}" if sub
                                                      else ""))
    want = importlib.import_module("glia_tpu" + (f".{sub}" if sub else ""))
    assert hasattr(want, name)
    got = getattr(mod, JAX_ONLY.get((sub, name), name))
    owner = getattr(got, "__module__", None) or getattr(got, "__name__", "")
    if callable(got) or isinstance(got, type(np)):
        assert owner.startswith("glia_tpu_torch"), owner
    else:
        assert got == getattr(want, name)


# ---------------------------------------------------------------------------
# copied host functions against glia_tpu's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[((64, 64), 12, 3),
                                        ((96, 96), 20, 4)])
def section(request):
    shape, cells, seed = request.param
    s = synthetic_em_slice(shape, n_cells=cells, seed=seed)
    seg = jp.pre_merge(jp.watershed(s["pb"], 0.05), s["pb"], (30,))
    rag = build_rag(seg, contour_only=False)
    orders = {p: greedy_merge_native(rag, s["pb"], policy=p)[0]
              for p in ("mean", "median", "median_minsize")}
    truth = s["truth"].copy()
    truth[:4, :] = 0     # some background, which the counts exclude
    return seg, truth, orders


def test_tree_helpers_match(section):
    _, _, orders = section
    for order in orders.values():
        jt, tt = jtree.build_tree(order), ttree.build_tree(order)
        np.testing.assert_array_equal(ttree.gen_order(tt),
                                      jtree.gen_order(jt))
        np.testing.assert_array_equal(ttree.gen_order(tt), order)
        assert ttree.gen_node_paths(tt) == jtree.gen_node_paths(jt)
        # glia_tpu's encoding compares a leaf's (key,) with a pair of
        # encodings, which Python refuses: both raise alike on a tree
        # where a leaf and a merge are siblings
        for enc in (ttree.encode_tree, jtree.encode_tree):
            with pytest.raises(TypeError):
                enc(tt if enc is ttree.encode_tree else jt)
        assert ttree.get_base_keys(order) == jtree.get_base_keys(order)
        for sort in (True, False):
            got = ttree.collect_sub_keys(tt, sort=sort)
            want = jtree.collect_sub_keys(jt, sort=sort)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# glia_tpu's own encoding cases (tests/test_misc_parity.py): one topology
# built in two merge sequences, and another topology
ENCODED = [np.array([[1, 2, 5], [3, 4, 6], [5, 6, 7]]),
           np.array([[3, 4, 9], [1, 2, 8], [8, 9, 11]]),
           np.array([[1, 3, 5], [2, 4, 6], [5, 6, 7]])]


def test_encode_tree_matches():
    got = [ttree.encode_tree(ttree.build_tree(o)) for o in ENCODED]
    assert got == [jtree.encode_tree(jtree.build_tree(o)) for o in ENCODED]
    assert got[0] == got[1] != got[2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_trees_greedy_subset_matches(section, seed):
    """Three trees over the same leaves (the three policies' orders), with
    seeded potentials that tie now and then."""
    _, _, orders = section
    rng = np.random.default_rng(seed)
    jts = [jtree.build_tree(o) for o in orders.values()]
    tts = [ttree.build_tree(o) for o in orders.values()]
    pots = [np.round(rng.random(t.n_nodes), 1) for t in jts]
    got = tgreedy.resolve_trees_greedy_subset(tts, pots)
    want = jgreedy.resolve_trees_greedy_subset(jts, pots)
    assert got == want and sum(map(len, got)) > 0


@pytest.mark.parametrize("itk_quirk", [True, False])
def test_vi_image_matches(section, itk_quirk):
    seg, truth, _ = section
    rng = np.random.default_rng(7)
    mask = (rng.random(seg.shape) < 0.9).astype(np.int32)
    for kw in (dict(), dict(mask=mask), dict(excluded0=(0,)),
               dict(excluded1=(0,), mask=mask)):
        got = tvi.vi_image(seg, truth, itk_quirk=itk_quirk, **kw)
        want = jvi.vi_image(seg, truth, itk_quirk=itk_quirk, **kw)
        assert got == want and np.isfinite(got)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vi_region_sets_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    counts = [{int(t): int(rng.integers(0, 50))
               for t in rng.choice(8, size=int(rng.integers(0, 5)),
                                   replace=False)} for _ in range(n)]
    sizes = [sum(d.values()) + int(rng.integers(0, 10)) for d in counts]
    for n_points in (None, sum(sizes) + 3):
        got = tvi.vi_region_sets(sizes, counts, n_points=n_points)
        assert got == jvi.vi_region_sets(sizes, counts, n_points=n_points)
    assert tvi.vi_region_sets([0], [{}]) == 0.0


RULES = [dict(rule="vi"), dict(rule="ri"), dict(rule="f1"),
         dict(rule="f1", tweak=True),
         dict(rule="f1", tweak=True, max_prec_drop=0.05),
         dict(rule="f1", exclude_truth=())]


@pytest.mark.parametrize("kw", RULES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_bc_labels_loop_matches(section, kw):
    seg, truth, orders = section
    order = orders["median"]
    got = tlabels.bc_labels_loop(seg, truth, order, **kw)
    want = jlabels.bc_labels_loop(seg, truth, order, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lv, mv, sv = tlabels.bc_labels(seg, truth, order, **kw)
    np.testing.assert_array_equal(got[0], lv)
    np.testing.assert_allclose(got[1], mv, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[2], sv, rtol=1e-9, atol=1e-12)


def test_bc_labels_loop_helpers_match():
    rows = [np.array([3, 0, 5]), np.array([1, 4, 0]), np.array([0, 0, 2])]
    for k in range(1, 4):
        assert tlabels._pair_stats_rows(rows[:k]) == \
            jlabels._pair_stats_rows(rows[:k])
        assert tlabels._vi_rows(rows[:k], 20) == jlabels._vi_rows(rows[:k],
                                                                  20)
    for stats in ((3, 4, 0, 0), (0, 5, 0, 0), (2, 1, 1, 3), (0, 0, 0, 0)):
        assert tlabels._prf(*stats) == jlabels._prf(*stats)
        assert tlabels._ri(*stats) == jlabels._ri(*stats)
    with pytest.raises(ValueError):
        tlabels.bc_labels_loop(np.zeros((2, 2), int), np.zeros((2, 2), int),
                               np.array([[0, 0, 1]]), rule="dice")


@pytest.mark.parametrize("mtry", [0, 5])
def test_save_legacy_forest_writes_glia_tpus_bytes(tmp_path, mtry):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(300, 12))
    y = np.where(X[:, 0] + 0.5 * X[:, 3] > 0, 1, -1)
    ref = jforest.train_forest(X, y, n_trees=8, seed=0)
    port = tforest.ForestModel.from_arrays(
        ref.feature, ref.threshold, ref.left, ref.right, ref.leaf_class,
        ref.n_classes, ref.max_depth, ref.classes)
    tlegacy.save_legacy_forest(tmp_path / "port.bin", port, mtry=mtry)
    jlegacy.save_legacy_forest(tmp_path / "ref.bin", ref, mtry=mtry)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    back = tlegacy.load_legacy_forest(tmp_path / "port.bin")
    np.testing.assert_array_equal(
        tforest.predict_votes_np(back, X), tforest.predict_votes_np(port, X))
