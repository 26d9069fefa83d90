"""Advanced 2D shape features: central/Hu moments + eccentricity (a copy
of glia_tpu.features.adv_shape).

Reference: code/alg/geometry.hxx:45-110 and RegionAdvShapeFeats2D
(code/type/feat.hxx:191-242).  Moment order is {m02, m03, m11, m12, m20,
m21, m30} with dx along ITK dim 0 (image x = last numpy axis) and dy along
dim 1.  Central moments are optionally divided by normalizingLength powers
{2,3,2,3,2,2,3} (feat.hxx:227-237); Hu moments come from the
scale-invariant moments (m / m00^2 or m00^2.5); eccentricity =
(a+b)/(a-b) with a = m20+m02, b = sqrt((m20-m02)^2 + 4 m11^2), computed on
the (normalized) central moments.

QUIRK kept: the centroid passed in is the *normalized* centroid
(sum/(n*normalizingLength), sc_feat.hxx:55-58) while pixel coordinates stay
raw; with the default normalizingLength=1 they coincide.
"""

from __future__ import annotations

import numpy as np

from ..constants import sdivide


def region_centroids(labels, keys, region_ptr, region_pixels, shape,
                     normalizing_length=1.0):
    """Per-region centroid sum(p)/(n*normLength) in ITK coord order
    (RegionLocationFeats::generate, feat.hxx:315-323)."""
    ndim = len(shape)
    coords = np.unravel_index(region_pixels, shape)
    coords = np.stack([coords[ndim - 1 - d] for d in range(ndim)],
                      axis=1).astype(np.float64)
    R = len(keys)
    rid = np.repeat(np.arange(R), np.diff(region_ptr))
    out = np.zeros((R, ndim))
    for d in range(ndim):
        np.add.at(out[:, d], rid, coords[:, d])
    n = np.maximum(np.diff(region_ptr), 1).astype(np.float64)
    return out / (n[:, None] * normalizing_length)


def adv_shape_2d(labels_shape, keys, region_ptr, region_pixels,
                 centroids, normalizing_length=1.0):
    """[R, 15] = 7 central moments + 7 Hu + eccentricity."""
    coords = np.unravel_index(region_pixels, labels_shape)
    x = coords[1].astype(np.float64)  # ITK dim 0
    y = coords[0].astype(np.float64)  # ITK dim 1
    R = len(keys)
    rid = np.repeat(np.arange(R), np.diff(region_ptr))
    dx = x - centroids[rid, 0]
    dy = y - centroids[rid, 1]
    terms = [dy * dy, dy ** 3, dx * dy, dx * dy * dy,
             dx * dx, dx * dx * dy, dx ** 3]
    ms = np.zeros((R, 7))
    for i, t in enumerate(terms):
        np.add.at(ms[:, i], rid, t)
    m00 = np.diff(region_ptr).astype(np.float64)
    m002 = m00 * m00
    m003 = np.power(m00, 2.5)
    den = np.stack([m002, m003, m002, m003, m002, m002, m003], axis=1)
    sims = sdivide(ms, den, 0.0)
    if normalizing_length > 0.0:
        nl2 = normalizing_length ** 2
        nl3 = normalizing_length ** 3
        norm = np.array([nl2, nl3, nl2, nl3, nl2, nl2, nl3])
        cm = ms / norm
    else:
        cm = ms
    hu = hu_moments(sims)
    ecc = eccentricity(cm[:, 0], cm[:, 2], cm[:, 4])
    return np.concatenate([cm, hu, ecc[:, None]], axis=1)


def hu_moments(sims):
    """getHuMoments (geometry.hxx:85-101); sims columns = scale-invariant
    {m02, m03, m11, m12, m20, m21, m30}."""
    m02, m03, m11, m12, m20, m21, m30 = [sims[:, i] for i in range(7)]
    hm = np.zeros((sims.shape[0], 7))
    hm[:, 0] = m20 + m02
    hm[:, 1] = (m20 - m02) ** 2 + 4.0 * m11 * m11
    hm[:, 2] = (m30 - 3 * m12) ** 2 + (3 * m21 - m03) ** 2
    hm[:, 3] = (m30 + m12) ** 2 + (m21 + m03) ** 2
    hm[:, 4] = ((m30 - 3 * m12) * (m30 + m12)
                * ((m30 + m12) ** 2 - 3 * (m21 + m03) ** 2)
                + (3 * m21 - m03) * (m21 + m03)
                * (3 * (m30 + m12) ** 2 - (m21 + m03) ** 2))
    hm[:, 5] = ((m20 - m02) * ((m30 + m12) ** 2 - (m21 + m03) ** 2)
                + 4.0 * m11 * (m30 + m12) * (m03 + m21))
    hm[:, 6] = ((3 * m21 - m03) * (m12 + m30)
                * ((m30 + m12) ** 2 - 3 * (m21 + m03) ** 2)
                - (m30 - 3 * m12) * (m12 + m03)
                * (3 * (m30 + m12) ** 2 - (m21 + m03) ** 2))
    return hm


def eccentricity(m02, m11, m20):
    """getEccentricity (geometry.hxx:104-110)."""
    a = m20 + m02
    b = np.sqrt(np.maximum((m20 - m02) ** 2 + 4.0 * m11 * m11, 0.0))
    return sdivide(a + b, a - b, 0.0)
