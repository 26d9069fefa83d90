"""The port's sharded BC tree features
(glia_tpu_torch.parallel.bc_tree_shard) against glia_tpu's on glia_tpu's
two cases (tests/test_bc_tree_shard.py:38,78), and against the host
TreeFeatures.

glia_tpu runs on its 4-device CPU mesh, the port on 4 gloo ranks (one
world for every case of this file).  Records and feature rows float64
within 1e-12; forest scores (vote fractions) equal to glia_tpu's and to
the port's plain walk of the rows.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from glia_tpu.data.synthetic import synthetic_em_slice as jx_slice
from glia_tpu.features import FeatureConfig as JxConfig
from glia_tpu.features import TreeFeatures as JxTreeFeatures
from glia_tpu.features.config import HistImage as JxHistImage
from glia_tpu.graph import build_rag as jx_build_rag
from glia_tpu.graph.merge import greedy_merge_order as jx_greedy
from glia_tpu.models.forest import make_label_scorer as jx_scorer
from glia_tpu.models.forest import train_forest as jx_train_forest
from glia_tpu.native import watershed_native as jx_watershed
from glia_tpu.parallel.bc_tree_shard import TreeShardPlan as JxPlan
from glia_tpu.parallel.bc_tree_shard import sharded_level_features as jx_slf
from glia_tpu.parallel.mesh import make_mesh as jx_mesh
from glia_tpu.parallel.partition import partition_rag as jx_partition

from glia_tpu_torch.data.synthetic import synthetic_em_slice
from glia_tpu_torch.features.config import FeatureConfig, HistImage
from glia_tpu_torch.graph.merge import greedy_merge_order
from glia_tpu_torch.graph.rag import build_rag
from glia_tpu_torch.models.forest import (ForestModel, ForestTables,
                                          forest_votes_torch)
from glia_tpu_torch.native import watershed_native
from glia_tpu_torch.parallel.launch import spawn_ranks

import torch_parallel_ranks as ranks

WORLD = 4
RTOL = 1e-12


def _section(slice_fn, watershed_fn, rag_fn, greedy_fn):
    data = slice_fn((96, 96), n_cells=18, seed=7)
    seg = watershed_fn(ndi.gaussian_filter(data["pb"], 1.0), 0.01)
    rag = rag_fn(seg, contour_only=False)
    order, _ = greedy_fn(rag, data["pb"], policy="mean")
    return data, rag, order


def _median_config(config, hist_image, pb, inten):
    """glia_tpu's widest host-accepted configuration (exact medians,
    per-image bins and ranges)."""
    q = lambda a, k: np.round(a * k) / k  # noqa: E731
    return config(
        pb_image=pb,
        r_images=[hist_image(q(pb, 32), 6, (0.0, 1.0), "pb"),
                  hist_image(q(inten, 24), 10, (0.0, 1.0), "in")],
        rl_images=[],
        b_images=[hist_image(q(inten, 24), 9, (0.0, 1.0), "in")],
        boundary_thresholds=[0.3, 0.6],
        normalizing_area=4.0, normalizing_length=2.0,
        histogram_as_feats=True, median_as_feats=True)


@pytest.fixture(scope="module")
def glia():
    data, rag, order = _section(jx_slice, jx_watershed, jx_build_rag,
                                jx_greedy)
    std = JxConfig.standard(data["pb"], data["intensity"], n_bins=8)
    med = _median_config(JxConfig, JxHistImage, data["pb"],
                         data["intensity"])
    want = {name: JxTreeFeatures(rag, order, cfg,
                                 saliencies=None).bc_features()
            for name, cfg in (("standard", std), ("median", med))}
    y = (want["standard"][:, 0] > np.median(want["standard"][:, 0])
         ).astype(int) * 2 - 1
    model = jx_train_forest(want["standard"], y, n_trees=16, seed=0)
    part = jx_partition(rag, WORLD)
    plans = {name: JxPlan(rag, order, cfg, part)
             for name, cfg in (("standard", std), ("median", med))}
    levels = sorted(set(plans["standard"].merge_level.tolist()))
    chosen = {"standard": [levels[0], levels[len(levels) // 2], levels[-1]],
              "median": [levels[0], levels[-1]]}
    scorer, consts = jx_scorer(model, label=-1, backend="xla", embed=True)
    mesh = jx_mesh(WORLD)
    out = {}
    for name in ("standard", "median"):
        kw = ({"scorer": scorer, "scorer_consts": consts}
              if name == "standard" else {})
        out[name] = {l: jx_slf(mesh, plans[name], l, **kw)
                     for l in chosen[name]}
    return {"data": data, "order": order, "want": want, "model": model,
            "levels": chosen, "out": out, "plans": plans}


@pytest.fixture(scope="module")
def port(glia):
    data, rag, order = _section(synthetic_em_slice, watershed_native,
                                build_rag, greedy_merge_order)
    np.testing.assert_array_equal(np.asarray(order),
                                  np.asarray(glia["order"]))
    m = glia["model"]
    forest = ForestModel.from_arrays(m.feature, m.threshold, m.left,
                                     m.right, m.leaf_class, m.n_classes,
                                     m.max_depth, m.classes)
    std = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=8)
    med = _median_config(FeatureConfig, HistImage, data["pb"],
                         data["intensity"])
    case = {"rag": rag, "order": order,
            "configs": [("standard", std, glia["levels"]["standard"], forest),
                        ("median", med, glia["levels"]["median"], None)]}
    res = spawn_ranks(ranks.bc_rank, WORLD, "gloo", "cpu", args=(case,),
                      timeout_s=300)
    return {"ranks": res, "forest": forest}


@pytest.mark.parametrize("name", ["standard", "median"])
def test_sharded_level_features_match_glia_tpu(glia, port, name):
    for l in glia["levels"][name]:
        j_rec, j_feats, j_scores, j_idx = glia["out"][name][l]
        for r, res in enumerate(port["ranks"]):
            rec, feats, scores, idx = res[name][l]
            np.testing.assert_array_equal(idx, j_idx)
            assert len(idx) == int((glia["plans"][name].merge_level
                                    == l).sum())
            np.testing.assert_allclose(feats, j_feats, rtol=RTOL, atol=0)
            np.testing.assert_allclose(feats, glia["want"][name][idx],
                                       rtol=1e-9, atol=1e-9)
            assert set(rec) == set(j_rec)
            for k in rec:
                np.testing.assert_allclose(rec[k], j_rec[k], rtol=RTOL,
                                           atol=0, err_msg=f"{name} {l} {k}")
            if name == "standard":
                np.testing.assert_array_equal(scores, j_scores)
            else:
                assert scores is None and j_scores is None


def test_sharded_scores_are_the_plain_walk(glia, port):
    tables = ForestTables.from_model(port["forest"], torch.device("cpu"))
    li = int(np.nonzero(port["forest"].classes == -1)[0][0])
    for l in glia["levels"]["standard"]:
        _, feats, scores, _ = port["ranks"][0]["standard"][l]
        X = torch.from_numpy(feats).to(torch.float32)
        np.testing.assert_array_equal(
            scores, forest_votes_torch(X, tables)[:, li].numpy())
