"""Feature-extraction configuration.

Mirrors the inputs of the reference's bc_feat stage
(code/hmt/main_bc_feat.cxx:115-186, code/hmt/hmt_util.hxx:17-57):

  - ``rb`` images feed BOTH region stats and boundary stats (hmt_util.hxx:31-36)
  - ``r``  images feed region stats only
  - ``b``  images feed boundary stats only
  - ``rl`` label images feed region histogram/entropy stats only
  - the pb image drives threshold ("validPerim") shape features

Compile-time reference toggles GLIA_USE_HISTOGRAM_AS_FEATS /
GLIA_USE_MEDIAN_AS_FEATS (code/CMakeLists.txt:54-64, default OFF) become the
runtime booleans ``histogram_as_feats`` / ``median_as_feats``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class HistImage:
    """An image with histogram parameters (bc_feat.hxx:30-42 ImageHistPair)."""

    image: np.ndarray
    hist_bins: int = 16
    hist_range: Tuple[float, float] = (0.0, 1.0)
    name: str = ""


@dataclass
class FeatureConfig:
    pb_image: np.ndarray                   # for threshold shape features
    r_images: List[HistImage] = field(default_factory=list)
    rl_images: List[HistImage] = field(default_factory=list)
    b_images: List[HistImage] = field(default_factory=list)
    boundary_thresholds: List[float] = field(default_factory=list)
    normalizing_area: float = 1.0
    normalizing_length: float = 1.0
    init_saliency: float = 1.0
    saliency_bias: float = 1.0
    use_log_shape: bool = False
    histogram_as_feats: bool = False
    median_as_feats: bool = False

    @classmethod
    def standard(cls, pb_image, intensity_image=None, n_bins=16,
                 boundary_thresholds=(0.2, 0.5, 0.8), normalize_shape=False):
        """Typical setup: pb as an rb image (region+boundary), optional raw
        intensity as a second rb image."""
        rb = [HistImage(np.asarray(pb_image), n_bins, (0.0, 1.0), "pb")]
        if intensity_image is not None:
            rb.append(
                HistImage(np.asarray(intensity_image), n_bins, (0.0, 1.0),
                          "intensity"))
        shape = np.asarray(pb_image).shape
        na = float(np.prod(shape)) if normalize_shape else 1.0
        nl = float(np.sqrt(np.sum(np.asarray(shape, np.float64) ** 2))) \
            if normalize_shape else 1.0
        return cls(
            pb_image=np.asarray(pb_image),
            r_images=list(rb),
            b_images=list(rb),
            rl_images=[],
            boundary_thresholds=list(boundary_thresholds),
            normalizing_area=na,
            normalizing_length=nl,
        )

    def label_feats_dim(self, img: HistImage) -> int:
        """ImageLabelFeats length (feat.hxx:601-612): entropy, plus the raw
        histogram when histogram_as_feats."""
        return (img.hist_bins + 1) if self.histogram_as_feats else 1

    def image_feats_dim(self, img: HistImage) -> int:
        """ImageFeats = ImageLabelFeats + ImageRealFeats (feat.hxx:815-846)."""
        return self.label_feats_dim(img) + (5 if self.median_as_feats else 4)

    def region_feat_dim(self, ndim=2, with_saliency=True) -> int:
        """RegionFeats serialized length (bc_feat.hxx:57-66)."""
        nt = len(self.boundary_thresholds)
        d = (ndim + 4) + 2 * nt
        d += sum(self.image_feats_dim(i) for i in self.r_images)
        d += sum(self.label_feats_dim(i) for i in self.rl_images)
        d += sum(self.image_feats_dim(i) for i in self.b_images)
        if with_saliency:
            d += 1
        return d

    def boundary_feat_dim(self, with_saliency=True) -> int:
        """BoundaryFeats serialized length (bc_feat.hxx:137-160)."""
        nt = len(self.boundary_thresholds)
        d = 11 + 4 * nt
        # ImageDiffFeats = [histL1, histX2, entropyDiff] + [meanDiff,
        # stdDiff, minDiff, maxDiff] (+ medianDiff when enabled)
        per_r = 3 + 4 + (1 if self.median_as_feats else 0)
        d += per_r * len(self.r_images)
        d += 3 * len(self.rl_images)
        d += sum(self.image_feats_dim(i) for i in self.b_images)
        if with_saliency:
            d += 2
        return d
