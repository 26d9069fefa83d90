"""The port's LINK3D functions (glia_tpu_torch.link3d.link) and 2D
advanced shape features (features/adv_shape.py) against glia_tpu's, on
glia_tpu's test stack (4, 48, 48), seed 5 (tests/test_link3d.py), its
truth sections and their watershed over-segmentations.

Required: pairs, overlaps, labels, F1 scores, links and grouped volumes
equal; float64 features (centroids, adv shape, section-pair rows) within
rtol 1e-12.
"""

import numpy as np
import pytest

import glia_tpu.link3d.link as jl
import glia_tpu_torch.link3d.link as tl
from glia_tpu.data.synthetic import synthetic_em_stack
from glia_tpu.features.adv_shape import adv_shape_2d as j_adv_shape
from glia_tpu.features.adv_shape import eccentricity as j_ecc
from glia_tpu.features.adv_shape import hu_moments as j_hu
from glia_tpu.features.adv_shape import region_centroids as j_centroids
from glia_tpu.features.config import FeatureConfig
from glia_tpu.native import watershed_native
from glia_tpu_torch.features.adv_shape import (adv_shape_2d, eccentricity,
                                               hu_moments, region_centroids)
from glia_tpu_torch.features.config import FeatureConfig as TFeatureConfig
from glia_tpu_torch.graph.rag import build_rag

FEAT_RTOL = 1e-12


@pytest.fixture(scope="module")
def stack():
    return synthetic_em_stack(shape=(4, 48, 48), n_cells=8, seed=5)


def sections(stack, kind):
    """Sections 0 and 1 as the truth or as watershed regions."""
    if kind == "truth":
        return [stack["slices"][z]["truth"] for z in (0, 1)]
    return [watershed_native(stack["slices"][z]["pb"], 0.05)
            for z in (0, 1)]


KINDS = ["truth", "watershed"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nl", [1.0, 3.0])
def test_centroids_and_adv_shape_match(stack, kind, nl):
    seg = sections(stack, kind)[0]
    rag = build_rag(seg, contour_only=False)
    args = (rag.keys, rag.region_ptr, rag.region_pixels)
    c = region_centroids(seg, *args, rag.shape, nl)
    np.testing.assert_allclose(c, j_centroids(seg, *args, rag.shape, nl),
                               rtol=FEAT_RTOL, atol=0)
    got = adv_shape_2d(rag.shape, *args, c, nl)
    assert got.shape == (rag.n_regions, 15)
    np.testing.assert_allclose(got, j_adv_shape(rag.shape, *args, c, nl),
                               rtol=FEAT_RTOL, atol=0)


def test_hu_moments_and_eccentricity_match():
    x = np.random.default_rng(2).normal(size=(50, 7))
    np.testing.assert_array_equal(hu_moments(x), j_hu(x))
    np.testing.assert_array_equal(eccentricity(x[:, 0], x[:, 1], x[:, 2]),
                                  j_ecc(x[:, 0], x[:, 1], x[:, 2]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cd", [-1.0, 10.0])
def test_gen_region_pairs_matches(stack, kind, cd):
    s0, s1 = sections(stack, kind)
    pairs, overlaps = tl.gen_region_pairs(s0, s1, 3, 4, max_centroid_dist=cd)
    want_pairs, want_overlaps = jl.gen_region_pairs(s0, s1, 3, 4,
                                                    max_centroid_dist=cd)
    assert pairs == want_pairs and len(pairs) > 5
    assert overlaps == want_overlaps


def test_gen_region_pairs_with_masks_matches(stack):
    s0, s1 = sections(stack, "truth")
    m0 = np.ones(s0.shape, np.int32)
    m0[:10] = 0
    m1 = np.ones(s1.shape, np.int32)
    m1[:, -12:] = 0
    assert tl.gen_region_pairs(s0, s1, mask0=m0, mask1=m1) == \
        jl.gen_region_pairs(s0, s1, mask0=m0, mask1=m1)


def test_region_feats_with_location_match(stack):
    s0 = sections(stack, "watershed")[0]
    pb, intensity = (stack["slices"][0][k] for k in ("pb", "intensity"))
    got = tl.region_feats_with_location(
        s0, TFeatureConfig.standard(pb, intensity, n_bins=8))
    want = jl.region_feats_with_location(
        s0, FeatureConfig.standard(pb, intensity, n_bins=8))
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=FEAT_RTOL, atol=0)
    assert got[4] == want[4]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("log_shape", [False, True])
def test_sc_features_match(stack, kind, log_shape):
    """Section-pair rows, with the reference's quirk of the label-image
    block (it diffs the region image's statistics)."""
    s0, s1 = sections(stack, kind)
    pb, intensity = (stack["slices"][0][k] for k in ("pb", "intensity"))
    pairs, _ = jl.gen_region_pairs(s0, s1, 0, 1)
    want = jl.sc_features(s0, s1, FeatureConfig.standard(pb, intensity,
                                                         n_bins=8),
                          pairs, use_log_shape=log_shape)
    got = tl.sc_features(s0, s1, TFeatureConfig.standard(pb, intensity,
                                                         n_bins=8),
                         pairs, use_log_shape=log_shape)
    assert got.shape == want.shape and got.shape[0] == len(pairs)
    np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_sc_labels_match(stack, kind):
    s0, s1 = sections(stack, kind)
    t0, t1 = sections(stack, "truth")
    pairs, _ = jl.gen_region_pairs(s0, s1, 0, 1)
    got = tl.sc_labels(s0, t0, s1, t1, pairs)
    want = jl.sc_labels(s0, t0, s1, t1, pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(got[0])) <= {tl.SC_LABEL_TRUE, tl.SC_LABEL_FALSE}


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("min_score", [0.3, 0.8])
def test_link_by_threshold_matches(stack, force, min_score):
    pairs = []
    for z in range(3):
        s0 = stack["slices"][z]["truth"]
        s1 = stack["slices"][z + 1]["truth"]
        pairs += jl.gen_region_pairs(s0, s1, z, z + 1)[0]
    scores = np.random.default_rng(4).random(len(pairs))
    assert tl.link_by_threshold(pairs, scores, min_score, force) == \
        jl.link_by_threshold(pairs, scores, min_score, force)


@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_group_region_profiles_matches(stack, relabel, masked):
    segs = [s["truth"] for s in stack["slices"]]
    pairs = []
    for z in range(3):
        pairs += jl.gen_region_pairs(segs[z], segs[z + 1], z, z + 1)[0]
    links = jl.link_by_threshold(
        pairs, np.random.default_rng(5).random(len(pairs)), 0.6)
    masks = None
    if masked:
        masks = [np.ones(segs[0].shape, np.int32) for _ in segs]
        masks[1][5:20, 5:20] = 0
    got = tl.group_region_profiles(segs, [0, 1, 2, 3], links, masks=masks,
                                   relabel=relabel)
    want = jl.group_region_profiles(segs, [0, 1, 2, 3], links, masks=masks,
                                    relabel=relabel)
    assert got.shape == (4, 48, 48)
    np.testing.assert_array_equal(got, want)
