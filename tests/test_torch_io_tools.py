"""The port's host modules of the file bus against glia_tpu's: io/text.py,
io/image.py (and the port's own ``.npy`` images), tools.py, ops/image.py,
the extensions of infer/segment.py (relabel_image, several trees),
metrics/rand.py (traditional Rand, pair F1, eval_ri(adapted=False)),
graph/merge.py (the Python heap engine) and pipeline.watershed(relabel=)
/ pre_merge(engine=).

Inputs: glia_tpu's 64x64 CLI section (seed 6, 10 cells) and numpy seeds.
Required: every array, file and number equal (the functions are the same
numpy code on both sides).
"""

import numpy as np
import pytest

import glia_tpu.io.image as jimg
import glia_tpu.io.text as jtext
import glia_tpu.ops.image as jops
import glia_tpu.pipeline as jp
import glia_tpu.tools as jtools
import glia_tpu_torch.io.image as timg
import glia_tpu_torch.io.text as ttext
import glia_tpu_torch.ops.image as tops
import glia_tpu_torch.pipeline as tp
import glia_tpu_torch.tools as ttools
from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.graph.merge import apply_merge_order as j_apply
from glia_tpu.graph.merge import greedy_merge_order as j_greedy
from glia_tpu.graph.rag import build_rag
from glia_tpu.graph.tree import build_tree
from glia_tpu.infer.segment import final_segmentation as j_final
from glia_tpu.infer.segment import relabel_image as j_relabel
from glia_tpu.metrics import rand as jrand
from glia_tpu.native import greedy_merge_native
from glia_tpu_torch.graph.merge import apply_merge_order, greedy_merge_order
from glia_tpu_torch.graph.rag import build_rag as t_build_rag
from glia_tpu_torch.graph.tree import build_tree as t_build_tree
from glia_tpu_torch.infer.segment import final_segmentation, relabel_image
from glia_tpu_torch.metrics import rand as trand


@pytest.fixture(scope="module")
def section():
    s = synthetic_em_slice((64, 64), n_cells=10, seed=6)
    ws = jp.watershed(s["pb"], 0.05)
    return {**s, "ws": ws, "seg": jp.pre_merge(ws, s["pb"], (20,))}


def same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------- io

TEXT = {
    "merge_order": ("write_merge_order", "read_merge_order",
                    np.array([[3, 5, 9], [9, 1, 10]])),
    "vector": ("write_vector", "read_vector",
               np.random.default_rng(1).random(7)),
    "matrix": ("write_matrix", "read_matrix",
               np.random.default_rng(2).normal(size=(4, 3))),
}


@pytest.mark.parametrize("name", sorted(TEXT))
def test_text_files_match(name, tmp_path):
    write, read, arr = TEXT[name]
    getattr(jtext, write)(tmp_path / "j.txt", arr)
    getattr(ttext, write)(tmp_path / "t.txt", arr)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    same(getattr(ttext, read)(tmp_path / "t.txt"),
         getattr(jtext, read)(tmp_path / "j.txt"))


def test_empty_merge_order_reads_as_no_rows(tmp_path):
    (tmp_path / "e.txt").write_text("")
    same(ttext.read_merge_order(tmp_path / "e.txt"),
         jtext.read_merge_order(tmp_path / "e.txt"))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_images_match(dtype, tmp_path, section):
    arr = (section["seg"] % 200).astype(dtype)
    jimg.write_image(tmp_path / "j.png", arr)
    timg.write_image(tmp_path / "t.png", arr)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    for fn in ("read_image", "read_label_image"):
        same(getattr(timg, fn)(tmp_path / "t.png"),
             getattr(jimg, fn)(tmp_path / "j.png"))
    same(timg.read_real_image(tmp_path / "t.png", normalize=True),
         jimg.read_real_image(tmp_path / "j.png", normalize=True))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint16])
def test_npy_images_keep_the_array(dtype, tmp_path):
    """``.npy`` paths go through numpy: the array comes back with its
    dtype and values, and the readers convert as they do for PNG."""
    arr = (np.random.default_rng(3).random((5, 6, 7)) * 300).astype(dtype)
    timg.write_image(tmp_path / "a.npy", arr)
    same(timg.read_image(tmp_path / "a.npy"), arr)
    same(timg.read_label_image(tmp_path / "a.npy"), arr.astype(np.int32))
    real = arr.astype(np.float32)
    same(timg.read_real_image(tmp_path / "a.npy", normalize=True),
         real / 255.0 if real.max() > 1.0 else real)


# ---------------------------------------------------------------- tools

def _tools_cases(s):
    seg, truth, pb = s["seg"], s["truth"], s["pb"]
    mask = np.ones(seg.shape, np.int32)
    mask[:8] = 0
    rng = np.random.default_rng(7)
    feats = rng.integers(0, 4, size=(40, 3)).astype(np.float64)
    labels = np.where(rng.random(40) < 0.5, 1, -1)
    preds = rng.random(40)
    links = [((0, int(k)), (1, int(k))) for k in np.unique(seg)[:3]]
    return {
        "eval_init_seg": (seg, truth),
        "eval_init_seg_masked": (seg, truth, mask),
        "eval_ri_threshold": (pb, truth),
        "eval_ri_threshold_rand": ([pb, pb], [truth, truth], None, 0.1, 0.9,
                                   4, False),
        "eval_ri_threshold_watershed": (pb, truth, None, 0.0, 0.2, 3, True,
                                        True),
        "match_seg_to_truth": (seg, truth),
        "match_truth_to_seg": (seg, truth, mask),
        "seg_stats": (seg, mask, True),
        "normalize_samples": ([feats, feats[:5] * 2],),
        "unique_samples": (feats, labels),
        "distribute_samples": (feats, labels, 0, 1, 2.0),
        "select_hard_samples": (feats, labels, preds, 1, -1, 0.4, 0.6),
        "remove_single_profile_regions": ([seg, seg], [0, 1], links),
        "label_image_stats": (seg, mask),
        "distribute_label_images_keep": ([seg, truth, s["ws"]], 3, 10),
        "distribute_label_images_drop": ([seg, truth, s["ws"], seg], 3, 10,
                                         False, 4),
        "distribute_label_images_duplicate": ([seg, truth], 4, 6, True),
    }


TOOLS = sorted(_tools_cases({k: np.zeros((2, 2), np.int32) for k in
                             ("seg", "truth", "pb", "ws")}))


@pytest.mark.parametrize("case", TOOLS)
def test_tools_match(case, section):
    args = _tools_cases(section)[case]
    fn = case
    for suffix in ("_masked", "_rand", "_watershed", "_keep", "_drop",
                   "_duplicate"):
        fn = fn.removesuffix(suffix)
    same(getattr(ttools, fn)(*args), getattr(jtools, fn)(*args))


# ---------------------------------------------------------------- ops

def _ops_cases(s):
    seg, pb = s["seg"], s["pb"]
    vol = np.stack([pb, pb[::-1], pb.T])
    holes = seg.copy()
    holes[10:20, 10:30] = 0
    mask = np.ones(seg.shape, np.int32)
    mask[:, :5] = 0
    return {
        "threshold_image": (pb, 0.2, 0.6, 3, 1),
        "blur_image": (pb, 1.5),
        "blur_image_slicewise": (vol, 1.0, True),
        "crop_image": (vol, (1, 2, 3), (2, 10, 20)),
        "resample_image": (pb, 0.5),
        "resample_image_labels": (seg, 1.5, 0),
        "max_pool_image": (vol[:, :63, :61],),
        "max_pool_image_skip": (vol, (0,)),
        "accumulate_images": ([pb, pb * 2, pb ** 2], True),
        "dilate_background": (holes,),
        "dilate_background_masked": (holes, mask),
        "boundary_image_2d": (seg,),
        "stack_images": ([pb, pb],),
        "extract_slice": (vol, 1, 2),
        "image_patches": (pb, (5, 7), (9, 11)),
        "slicewise_connected_components": (np.stack([seg, seg]) % 3,),
        "scalar_connected_components": ((pb * 10).astype(np.int32), 2),
        "identity_connected_components": (holes, mask),
        "sample_image": (vol, (1, 3, 2)),
        "tile_images": ([pb, pb[::-1], pb.T], 2),
        "overlay_image": (pb, seg, 0.3, 4),
        "skeletonize_image": (seg % 2,),
    }


OPS = sorted(_ops_cases({k: np.zeros((4, 4)) for k in ("seg", "pb")}))


@pytest.mark.parametrize("case", OPS)
def test_image_ops_match(case, section):
    args = _ops_cases(section)[case]
    fn = case
    for suffix in ("_slicewise", "_labels", "_skip", "_masked"):
        fn = fn.removesuffix(suffix)
    same(getattr(tops, fn)(*args), getattr(jops, fn)(*args))


# ------------------------------------ segment, rand, merge, pipeline

@pytest.mark.parametrize("start", [0, 1])
def test_relabel_image_matches(start, section):
    same(relabel_image(section["seg"], start),
         j_relabel(section["seg"], start))


def test_final_segmentation_over_several_trees_matches(section):
    seg, pb = section["seg"], section["pb"]
    rag = build_rag(seg, contour_only=False)
    order, _ = greedy_merge_native(rag, pb, policy="median")
    half = len(order) // 2
    trees = [build_tree(order[:half]), build_tree(order[half:half + 3])]
    t_trees = [t_build_tree(order[:half]), t_build_tree(order[half:half + 3])]
    # the first tree's root and two leaves of the second
    picks = [(0, len(trees[0].keys) - 1), (1, 0), (1, 1)]
    same(final_segmentation(seg, t_trees, picks),
         j_final(seg, trees, picks))


@pytest.mark.parametrize("fn", ["rand_index_from_pairs",
                                "adapted_rand_from_pairs",
                                "pair_f1_from_pairs"])
@pytest.mark.parametrize("counts", [(10, 30, 4, 6), (0, 5, 0, 0)])
def test_rand_family_matches(fn, counts):
    same(getattr(trand, fn)(*counts), getattr(jrand, fn)(*counts))


@pytest.mark.parametrize("adapted", [True, False])
def test_eval_ri_matches(adapted, section):
    segs = [section["seg"], section["ws"]]
    truths = [section["truth"], section["truth"]]
    same(trand.eval_ri(segs, truths, adapted=adapted),
         jrand.eval_ri(segs, truths, adapted=adapted))


@pytest.mark.parametrize("policy", ["mean", "median", "median_minsize"])
def test_greedy_merge_order_matches(policy, section):
    seg, pb = section["seg"], section["pb"]
    got = greedy_merge_order(t_build_rag(seg, contour_only=False), pb,
                             policy=policy)
    want = j_greedy(build_rag(seg, contour_only=False), pb, policy=policy)
    same(got, want)
    assert len(got[0]) > 5


@pytest.mark.parametrize("kw", [dict(threshold_index=4),
                                dict(saliency_threshold=-0.3)])
def test_apply_merge_order_options_match(kw, section):
    seg, pb = section["seg"], section["pb"]
    order, sals = greedy_merge_native(build_rag(seg, contour_only=False),
                                      pb, policy="median")
    same(apply_merge_order(seg, order, saliencies=sals, **kw),
         j_apply(seg, order, saliencies=sals, **kw))


@pytest.mark.parametrize("relabel", [False, True])
def test_watershed_relabel_matches(relabel, section):
    same(tp.watershed(section["pb"], 0.05, relabel=relabel),
         jp.watershed(section["pb"], 0.05, relabel=relabel))


@pytest.mark.parametrize("engine", ["native", "py"])
@pytest.mark.parametrize("sizes", [(20,), (15, 40)])
def test_pre_merge_engines_match(engine, sizes, section):
    want = jp.pre_merge(section["ws"], section["pb"], sizes, engine=engine)
    same(tp.pre_merge(section["ws"], section["pb"], sizes, engine=engine),
         want)
    same(want, jp.pre_merge(section["ws"], section["pb"], sizes))


def test_pre_merge_refuses_an_unknown_engine(section):
    with pytest.raises(ValueError, match="native|py"):
        tp.pre_merge(section["ws"], section["pb"], engine="cuda")
