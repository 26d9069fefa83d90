"""On-device full-width BC feature assembly (PyTorch).

Counterpart of glia_tpu.features.device: given *stacked* per-candidate
stat records (tensors instead of python dicts), produce the serialized
RegionFeats / BoundaryFeats / BoundaryClassificationFeats matrices in the
reference's order (code/hmt/bc_feat.hxx:71-243, code/type/feat.hxx:
594-811), vectorized over every frontier candidate of a merge superstep.

Record layout (a dict of tensors, N = number of rows):
  area [N], border [N], bd [N]                  scalars
  bbox_lo [N, D], bbox_hi [N, D]                ITK coords
  vp [N, nT]                                    pb>=thresh boundary counts
  r_cnt/r_sum/r_sumsq/r_min/r_max [N, nR]       per r_image region stats
  r_hist [N, nR, Bmax]                          per-image bins; image i
                                                uses columns [:r_bins[i]]
  rl_hist [N, nRL, BLmax]                       per rl_image label hists
  b_cnt/b_sum/b_sumsq/b_min/b_max [N, nB]       per b_image boundary stats
  b_hist [N, nB, Bmax]
  r_medh [N, nR, Vr] (median_as_feats only)     counting histogram over
                                                the image's value table
  b_medh [N, nB, Vb] (median_as_feats only)

Pair-boundary record: cnt [N], vp [N, nT], b_* (+ b_medh) as above.

median_as_feats: the reference's median is stats::amedian's *upper
median* (code/util/stats.hxx:83-91), recovered exactly from an additive
counting histogram over the image's distinct values; past
``median_value_cap`` distinct values the table is a uniform grid of cap
levels and medians are off by at most one grid step.

Empty stats follow the reference's conventions: count<=0 serializes to
zeros (feat.hxx:703), safe division via sdivide (glia_base.hxx:77-79).
Masking uses ``torch.where``, never multiplication by a mask: empty
min/max fields hold +-inf and ``0 * inf`` is NaN.

The spec and the counting-histogram helpers stay numpy (host side).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..constants import FEPS
from .config import FeatureConfig


@dataclass(frozen=True)
class DeviceFeatureSpec:
    """Static shape/flag info for the device feature assembler."""

    ndim: int
    n_thresh: int
    n_r: int
    n_rl: int
    n_b: int
    r_bins: Tuple[int, ...]      # per-image histogram bin counts
    rl_bins: Tuple[int, ...]
    b_bins: Tuple[int, ...]
    normalizing_area: float
    normalizing_length: float
    use_log_shape: bool
    histogram_as_feats: bool
    median_as_feats: bool = False
    # per-image ascending value tables for device medians
    r_med_vals: Tuple[Tuple[float, ...], ...] = ()
    b_med_vals: Tuple[Tuple[float, ...], ...] = ()

    # ---- padded group widths (record storage) ----
    @property
    def r_bins_max(self) -> int:
        return max(self.r_bins, default=0)

    @property
    def rl_bins_max(self) -> int:
        return max(self.rl_bins, default=0)

    @property
    def b_bins_max(self) -> int:
        return max(self.b_bins, default=0)

    @property
    def r_med_v(self) -> int:
        return max((len(v) for v in self.r_med_vals), default=0)

    @property
    def b_med_v(self) -> int:
        return max((len(v) for v in self.b_med_vals), default=0)

    @classmethod
    def from_config(cls, cfg: FeatureConfig, ndim: int,
                    median_value_cap: int = 1024) -> "DeviceFeatureSpec":
        r_med, b_med = (), ()
        if cfg.median_as_feats:
            r_med = _med_tables(cfg.r_images, median_value_cap)
            b_med = _med_tables(cfg.b_images, median_value_cap)
        return cls(
            ndim=ndim,
            n_thresh=len(cfg.boundary_thresholds),
            n_r=len(cfg.r_images),
            n_rl=len(cfg.rl_images),
            n_b=len(cfg.b_images),
            r_bins=tuple(img.hist_bins for img in cfg.r_images),
            rl_bins=tuple(img.hist_bins for img in cfg.rl_images),
            b_bins=tuple(img.hist_bins for img in cfg.b_images),
            normalizing_area=float(cfg.normalizing_area),
            normalizing_length=float(cfg.normalizing_length),
            use_log_shape=bool(cfg.use_log_shape),
            histogram_as_feats=bool(cfg.histogram_as_feats),
            median_as_feats=bool(cfg.median_as_feats),
            r_med_vals=r_med,
            b_med_vals=b_med,
        )


def _med_tables(images, cap):
    tabs = []
    for img in images:
        vals = np.unique(np.asarray(img.image, np.float64))
        if len(vals) > cap:
            # sketch: uniform grid over the value range (see module doc)
            step = (float(vals[-1]) - float(vals[0])) / max(cap - 1, 1)
            warnings.warn(
                f"device median falls back to a {cap}-level uniform-grid "
                f"sketch ({len(vals)} distinct values > cap); medians are "
                f"exact over the quantized alphabet, off by at most one "
                f"grid step ({step:.3g}) from the host's exact median",
                RuntimeWarning, stacklevel=3)
            vals = np.linspace(float(vals[0]), float(vals[-1]), cap)
        tabs.append(tuple(float(v) for v in vals))
    return tuple(tabs)


def med_index(vals, values) -> np.ndarray:
    """Host helper: map pixel values to the NEAREST entry of an ascending
    value table (exact index for exact tables; nearest grid level for
    sketch grids)."""
    vals = np.asarray(vals, np.float64)
    values = np.asarray(values, np.float64)
    idx = np.clip(np.searchsorted(vals, values), 0, len(vals) - 1)
    lo = np.maximum(idx - 1, 0)
    use_lo = np.abs(values - vals[lo]) < np.abs(vals[idx] - values)
    return np.where(use_lo, lo, idx).astype(np.int64)


def counting_hist(values, group, n_groups, vals_table, width):
    """Host helper: [n_groups, width] counting histogram of ``values``
    over ``vals_table`` (padded to ``width``), grouped by ``group``."""
    h = np.zeros((n_groups, width))
    if len(values):
        vi = med_index(vals_table, values)
        np.add.at(h, (np.asarray(group), vi), 1.0)
    return h


# -- torch analogues of constants.sdivide / slog / entropy -------------------

def _sdivide(lhs, rhs, dummy=0.0):
    safe = rhs.abs() >= FEPS
    return torch.where(safe, lhs / torch.where(safe, rhs, 1.0), dummy)


def _slog(x, dummy=0.0):
    safe = x >= FEPS
    return torch.where(safe, torch.log(torch.where(safe, x, 1.0)), dummy)


def _entropy(hist, cnt):
    """stats::entropy rows (stats.hxx:144-151): hist [..., B], cnt [...]."""
    ok = cnt > 0
    p = hist / torch.where(ok, cnt, 1.0)[..., None]
    mask = p > FEPS
    lg = torch.where(mask, torch.log2(torch.where(mask, p, 1.0)), 0.0)
    return torch.where(ok, -(p * lg).sum(dim=-1), 0.0)


def _median_from_counts(hist, vals):
    """stats::amedian upper median (stats.hxx:83-91) from a counting
    histogram: hist [..., V] counts over ascending value table vals [V].
    The upper median is the first value whose cumulative count exceeds
    floor(n/2).  Empty sets -> 0."""
    vals = torch.as_tensor(np.asarray(vals), dtype=hist.dtype,
                           device=hist.device)
    cnt = hist.sum(dim=-1)
    k = torch.floor(cnt / 2.0)
    cum = torch.cumsum(hist, dim=-1)
    hit = cum > k[..., None]
    first = hit & ~torch.cat(
        [torch.zeros_like(hit[..., :1]), hit[..., :-1]], dim=-1)
    med = torch.where(first, vals, 0.0).sum(dim=-1)
    return torch.where(cnt > 0, med, 0.0)


def _img_feats_one(cnt, s, ss, mn, mx, hist, spec, med=None):
    """ImageFeats serialize for ONE image (feat.hxx:846-855):
    [hist/cnt?] entropy, [median?], mean, std, min, max.
    cnt..mx [...]; hist [..., B_i]; med [...] or None -> [..., w_i]."""
    ok = cnt > 0
    denom = torch.where(ok, cnt, 1.0)
    mean = torch.where(ok, s / denom, 0.0)
    var = torch.where(ok, ss / denom - mean * mean, 0.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    mn = torch.where(ok, mn, 0.0)
    mx = torch.where(ok, mx, 0.0)
    ent = _entropy(hist, cnt)
    cols = []
    if spec.histogram_as_feats:
        cols.append(torch.where(ok[..., None], hist / denom[..., None], 0.0))
    tail = [ent]
    if spec.median_as_feats:
        tail.append(torch.where(ok, med, 0.0))
    tail += [mean, std, mn, mx]
    cols.append(torch.stack(tail, dim=-1))
    return torch.cat(cols, dim=-1)


def _label_feats_one(hist, cnt, spec):
    """ImageLabelFeats for ONE image (feat.hxx:601-612): [hist?] entropy."""
    ok = cnt > 0
    ent = _entropy(hist, cnt)
    if spec.histogram_as_feats:
        h = hist / torch.where(ok, cnt, 1.0)[..., None]
        h = torch.where(ok[..., None], h, 0.0)
        return torch.cat([h, ent[..., None]], dim=-1)
    return ent[..., None]


def _r_median(rec, spec, i):
    if not spec.median_as_feats:
        return None
    V = len(spec.r_med_vals[i])
    return _median_from_counts(rec["r_medh"][..., i, :V], spec.r_med_vals[i])


def _b_median(rec, spec, i, key="b_medh"):
    if not spec.median_as_feats:
        return None
    V = len(spec.b_med_vals[i])
    return _median_from_counts(rec[key][..., i, :V], spec.b_med_vals[i])


def region_features_dev(rec, spec: DeviceFeatureSpec):
    """RegionFeats matrix [N, Dr] (bc_feat.hxx:71-80 serialize order)."""
    nA, nL = spec.normalizing_area, spec.normalizing_length
    D = spec.ndim
    area_raw = rec["area"]
    perim_raw = rec["bd"] + rec["border"]
    compact = _sdivide(perim_raw ** (D / (D - 1.0)), area_raw, 0.0)
    area = area_raw / nA
    perim = perim_raw / nL
    bsz = torch.clamp(rec["bbox_hi"] - rec["bbox_lo"], min=0.0)
    bbox_area = torch.prod(bsz, dim=-1) / nA
    vp = rec["vp"]
    bsz_n = bsz / nL
    vps = vp / nL
    rvps = _sdivide(vp, rec["bd"][..., None], 0.0)
    head = torch.stack([area, perim, compact, bbox_area], dim=-1)
    if spec.use_log_shape:
        head = torch.stack(
            [_slog(area, 0.0), _slog(perim, 0.0), compact,
             _slog(bbox_area, 0.0)], dim=-1)
        bsz_n = _slog(bsz_n, 0.0)
        vps = _slog(vps, 0.0)
    cols = [head, bsz_n, vps, rvps]
    for i in range(spec.n_r):
        B = spec.r_bins[i]
        cols.append(_img_feats_one(
            rec["r_cnt"][..., i], rec["r_sum"][..., i],
            rec["r_sumsq"][..., i], rec["r_min"][..., i],
            rec["r_max"][..., i], rec["r_hist"][..., i, :B], spec,
            med=_r_median(rec, spec, i)))
    for i in range(spec.n_rl):
        B = spec.rl_bins[i]
        cols.append(_label_feats_one(
            rec["rl_hist"][..., i, :B], rec["area"], spec))
    for i in range(spec.n_b):
        B = spec.b_bins[i]
        cols.append(_img_feats_one(
            rec["b_cnt"][..., i], rec["b_sum"][..., i],
            rec["b_sumsq"][..., i], rec["b_min"][..., i],
            rec["b_max"][..., i], rec["b_hist"][..., i, :B], spec,
            med=_b_median(rec, spec, i)))
    return torch.cat(cols, dim=-1)


def boundary_features_dev(rec0, rec1, rec2, pair, spec: DeviceFeatureSpec):
    """BoundaryFeats matrix [N, Db] (bc_feat.hxx:183-215); rec0 must
    already be the smaller-area region (area ordering applied upstream)."""
    nA, nL = spec.normalizing_area, spec.normalizing_length
    area0 = rec0["area"] / nA
    area1 = rec1["area"] / nA
    perim0 = (rec0["bd"] + rec0["border"]) / nL
    perim1 = (rec1["bd"] + rec1["border"]) / nL
    area_diff = (area0 - area1).abs()
    perim_diff = (perim0 - perim1).abs()
    blen = torch.ceil(pair["cnt"] / 2.0) / nL
    c0 = area_diff
    c3 = perim_diff
    c6 = blen
    if spec.use_log_shape:
        c0 = _slog(area_diff, 0.0)
        c3 = _slog(perim_diff, 0.0)
        c6 = _slog(blen, 0.0)
    head = torch.stack([
        c0, _sdivide(area_diff, area0, 0.0), _sdivide(area_diff, area1, 0.0),
        c3, _sdivide(perim_diff, perim0, 0.0),
        _sdivide(perim_diff, perim1, 0.0),
        c6, _sdivide(blen, area0, 0.0), _sdivide(blen, area1, 0.0),
        _sdivide(blen, perim0, 0.0), _sdivide(blen, perim1, 0.0),
    ], dim=-1)
    vbl = torch.ceil(pair["vp"] / 2.0) / nL
    vbl_ser = _slog(vbl, 0.0) if spec.use_log_shape else vbl
    cols = [head, vbl_ser,
            _sdivide(vbl, blen[..., None], 0.0),
            _sdivide(vbl, perim0[..., None], 0.0),
            _sdivide(vbl, perim1[..., None], 0.0)]
    for i in range(spec.n_r):
        B = spec.r_bins[i]
        args0 = (rec0["r_cnt"][..., i], rec0["r_sum"][..., i],
                 rec0["r_sumsq"][..., i], rec0["r_min"][..., i],
                 rec0["r_max"][..., i], rec0["r_hist"][..., i, :B])
        args1 = (rec1["r_cnt"][..., i], rec1["r_sum"][..., i],
                 rec1["r_sumsq"][..., i], rec1["r_min"][..., i],
                 rec1["r_max"][..., i], rec1["r_hist"][..., i, :B])
        f0 = _img_feats_one(*args0, spec, med=_r_median(rec0, spec, i))
        f1 = _img_feats_one(*args1, spec, med=_r_median(rec1, spec, i))
        h0 = args0[5] / torch.clamp(args0[0], min=1.0)[..., None]
        h1 = args1[5] / torch.clamp(args1[0], min=1.0)[..., None]
        l1 = (h0 - h1).abs().sum(dim=-1)                     # [N]
        x2 = (torch.square(h0 - h1) / (h0 + h1 + FEPS)).sum(dim=-1)
        off = B if spec.histogram_as_feats else 0
        # entropyDiff, [medianDiff?] meanDiff, stdDiff, minDiff, maxDiff
        d = (f0[..., off:] - f1[..., off:]).abs()            # [N, 5 or 6]
        cols.append(torch.cat([torch.stack([l1, x2], dim=-1), d], dim=-1))
    for i in range(spec.n_rl):
        B = spec.rl_bins[i]
        c0a = torch.clamp(rec0["area"], min=1.0)[..., None]
        c1a = torch.clamp(rec1["area"], min=1.0)[..., None]
        h0 = rec0["rl_hist"][..., i, :B] / c0a
        h1 = rec1["rl_hist"][..., i, :B] / c1a
        l1 = (h0 - h1).abs().sum(dim=-1)
        x2 = (torch.square(h0 - h1) / (h0 + h1 + FEPS)).sum(dim=-1)
        e0 = _entropy(rec0["rl_hist"][..., i, :B], rec0["area"])
        e1 = _entropy(rec1["rl_hist"][..., i, :B], rec1["area"])
        cols.append(torch.stack([l1, x2, (e0 - e1).abs()], dim=-1))
    for i in range(spec.n_b):
        B = spec.b_bins[i]
        cols.append(_img_feats_one(
            pair["b_cnt"][..., i], pair["b_sum"][..., i],
            pair["b_sumsq"][..., i], pair["b_min"][..., i],
            pair["b_max"][..., i], pair["b_hist"][..., i, :B], spec,
            med=_b_median(pair, spec, i)))
    return torch.cat(cols, dim=-1)


def swap_records(rec0, rec1, swap):
    """Elementwise-swap two stacked records where ``swap`` [N] is True."""
    out0, out1 = {}, {}
    for k in rec0:
        a, b = rec0[k], rec1[k]
        m = swap.reshape(swap.shape + (1,) * (a.ndim - swap.ndim))
        out0[k] = torch.where(m, b, a)
        out1[k] = torch.where(m, a, b)
    return out0, out1


def bc_features_dev(rec0, rec1, rec2, pair, spec: DeviceFeatureSpec):
    """BoundaryClassificationFeats [N, Db + 3*Dr] with area ordering
    (bc_feat.hxx:219-243 + main_bc_feat.cxx:86-89)."""
    nA = spec.normalizing_area
    swap = rec0["area"] / nA > rec1["area"] / nA
    rec0, rec1 = swap_records(rec0, rec1, swap)
    bf = boundary_features_dev(rec0, rec1, rec2, pair, spec)
    return torch.cat(
        [bf, region_features_dev(rec0, spec), region_features_dev(rec1, spec),
         region_features_dev(rec2, spec)], dim=-1)
