"""Port BC feature assembly vs glia_tpu.features.device.bc_features_dev.

The same seeded stat records (numpy) go through JAX's bc_features_dev
(x64, CPU) and the port's (float64, CPU), on the feature configs of the
48x48 case of tests/test_merge_bc_device.py: the standard config, the
median_as_feats + histogram_as_feats + per-image bins config, and a
log-shape config with a label image.  Records include empty stats
(count 0 with +-inf min/max fills) and zero areas.  Tolerance: rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from glia_tpu.data.synthetic import synthetic_em_slice
from glia_tpu.features.config import FeatureConfig, HistImage
from glia_tpu.features.device import DeviceFeatureSpec as JaxSpec
from glia_tpu.features.device import bc_features_dev as jax_bc_features_dev
from glia_tpu_torch.features.device import DeviceFeatureSpec
from glia_tpu_torch.features.device import bc_features_dev


def _configs():
    data = synthetic_em_slice(shape=(48, 48), n_cells=8, seed=77)
    std = FeatureConfig.standard(data["pb"], data["intensity"], n_bins=8,
                                 boundary_thresholds=(0.3, 0.6))

    def q(a, k):
        return np.round(np.asarray(a) * k) / k

    pb_q, in_q = q(data["pb"], 32), q(data["intensity"], 24)
    median = FeatureConfig(
        pb_image=data["pb"],
        r_images=[HistImage(pb_q, 6, (0.0, 1.0), "pb"),
                  HistImage(in_q, 10, (0.0, 1.0), "in")],
        rl_images=[],
        b_images=[HistImage(in_q, 9, (0.0, 1.0), "in"),
                  HistImage(pb_q, 5, (0.0, 1.0), "pb")],
        boundary_thresholds=[0.3, 0.6],
        normalizing_area=4.0, normalizing_length=2.0,
        histogram_as_feats=True, median_as_feats=True)
    labels = ndi.label(data["pb"] < 0.5)[0] % 5
    logshape = FeatureConfig(
        pb_image=data["pb"],
        r_images=[HistImage(data["pb"], 8, (0.0, 1.0), "pb")],
        rl_images=[HistImage(labels.astype(np.float64), 5, (0.0, 5.0),
                             "lab")],
        b_images=[HistImage(data["intensity"], 7, (0.0, 1.0), "in")],
        boundary_thresholds=[0.2, 0.5, 0.8],
        use_log_shape=True, histogram_as_feats=True)
    return {"standard": std, "median": median, "logshape": logshape}


_CONFIGS = _configs()


def _stats(rng, n, k, bins):
    cnt = rng.integers(0, 6, (n, k)).astype(np.float64)
    cnt[0] = 0.0
    s = rng.random((n, k)) * cnt
    ss = s * s / np.maximum(cnt, 1.0) + rng.random((n, k)) * 0.1
    mn = np.where(cnt > 0, rng.random((n, k)), np.inf)
    mx = np.where(cnt > 0, mn + rng.random((n, k)), -np.inf)
    h = rng.integers(0, 4, (n, k, bins)).astype(np.float64)
    return cnt, s, ss, mn, mx, h


def _records(spec, rng, n=64):
    nd = spec.ndim
    recs = []
    for _ in range(3):
        r = {"area": rng.integers(0, 50, n).astype(np.float64),
             "border": rng.integers(0, 5, n).astype(np.float64),
             "bd": rng.integers(0, 30, n).astype(np.float64)}
        r["area"][1] = 0.0
        lo = rng.integers(0, 40, (n, nd)).astype(np.float64)
        r["bbox_lo"] = lo
        r["bbox_hi"] = lo + rng.integers(0, 9, (n, nd))
        r["vp"] = rng.integers(0, 10, (n, spec.n_thresh)).astype(np.float64)
        (r["r_cnt"], r["r_sum"], r["r_sumsq"], r["r_min"], r["r_max"],
         r["r_hist"]) = _stats(rng, n, spec.n_r, max(spec.r_bins_max, 1))
        r["rl_hist"] = rng.integers(
            0, 4, (n, spec.n_rl, max(spec.rl_bins_max, 1))).astype(float)
        (r["b_cnt"], r["b_sum"], r["b_sumsq"], r["b_min"], r["b_max"],
         r["b_hist"]) = _stats(rng, n, spec.n_b, max(spec.b_bins_max, 1))
        if spec.median_as_feats:
            r["r_medh"] = rng.integers(
                0, 3, (n, spec.n_r, spec.r_med_v)).astype(np.float64)
            r["b_medh"] = rng.integers(
                0, 3, (n, spec.n_b, spec.b_med_v)).astype(np.float64)
        recs.append(r)
    pair = {"cnt": rng.integers(0, 20, n).astype(np.float64),
            "vp": rng.integers(0, 10, (n, spec.n_thresh)).astype(float)}
    (pair["b_cnt"], pair["b_sum"], pair["b_sumsq"], pair["b_min"],
     pair["b_max"], pair["b_hist"]) = _stats(rng, n, spec.n_b,
                                             max(spec.b_bins_max, 1))
    if spec.median_as_feats:
        pair["b_medh"] = recs[0]["b_medh"] + recs[1]["b_medh"]
    return recs, pair


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_bc_features_dev_matches_jax(name):
    cfg = _CONFIGS[name]
    jspec = JaxSpec.from_config(cfg, 2)
    spec = DeviceFeatureSpec.from_config(cfg, 2)
    assert spec.r_med_vals == jspec.r_med_vals
    recs, pair = _records(spec, np.random.default_rng(3))

    def jx(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def pt(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    want = np.asarray(jax.jit(jax_bc_features_dev, static_argnums=4)(
        *map(jx, recs), jx(pair), jspec))
    got = bc_features_dev(*map(pt, recs), pt(pair), spec)
    assert got.dtype == torch.float64
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
