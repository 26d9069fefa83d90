"""VI / Rand metrics on the device (PyTorch).

Counterpart of glia_tpu.metrics.device: labels are densified to [0, S) /
[0, T) ids on the host once, then the contingency counts and scores are
computed on the device.  Counts are float64 tensors and every segment sum
goes through ``segment_sum_auto`` (the hand-written CUDA kernel on the
card, ``index_add_`` on the CPU); float64 holds integer counts exactly
up to 2**53, so the pair counts equal the host's big-integer ones.

The dense forms (``contingency_device``, ``vi_device``,
``adapted_rand_device``) build an [S, T] matrix: at a 4096^2 section
(S, T ~ 10^5) that is far beyond the card's memory, and only the sparse
forms (``*_from_pairs_device``, over the K non-empty cells of a
contingency table) are usable.  The canonical exact metrics stay the host
ones (metrics/vi.py, metrics/rand.py); these use correct float math and
``vi_from_pairs_device(itk_quirk=True)`` reproduces the reference's
unsigned-integer division.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.segment_csr import segment_sum_auto


def densify_labels(arr, exclude=()):
    """Host: labels -> dense ids [0, n); excluded labels -> -1.

    Returns (ids int32, n)."""
    arr = np.asarray(arr)
    uniq = np.unique(arr)
    uniq = uniq[~np.isin(uniq, list(exclude))] if exclude else uniq
    lut = np.full(int(arr.max()) + 2, -1, dtype=np.int32)
    lut[uniq] = np.arange(len(uniq), dtype=np.int32)
    return lut[arr], len(uniq)


def _ids(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev).long().reshape(-1)


def _counts(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev).to(torch.float64)


def _c2(x):
    return x * (x - 1.0) / 2.0


def contingency_device(seg_ids, truth_ids, S, T,
                       device: DeviceLike = None) -> torch.Tensor:
    """[S, T] float64 counts; pixels with either id < 0 are dropped."""
    dev = resolve_device(device)
    seg = _ids(seg_ids, dev)
    truth = _ids(truth_ids, dev)
    keep = (seg >= 0) & (truth >= 0)
    # dropped pixels take the id S * T, past the last segment
    code = torch.where(keep, seg * T + truth, S * T)
    flat = segment_sum_auto(keep.to(torch.float64), code, S * T)
    return flat.reshape(S, T)


def vi_device(seg_ids, truth_ids, S, T, device: DeviceLike = None):
    """(false_split, false_merge, total) = H(seg|truth), H(truth|seg),
    as float64 scalar tensors."""
    c = contingency_device(seg_ids, truth_ids, S, T, device=device)
    n = c.sum()
    ps = c.sum(dim=1)
    pt = c.sum(dim=0)

    def _h(joint, marg):
        # sum c * log2(marg/c) / n over nonzero cells
        safe_c = torch.clamp(joint, min=1e-30)
        ratio = torch.where(joint > 0, marg / safe_c, 1.0)
        return (joint * torch.log2(ratio)).sum() / torch.clamp(n, min=1.0)

    fs = _h(c, pt[None, :])   # H(seg | truth)
    fm = _h(c, ps[:, None])   # H(truth | seg)
    return fs, fm, fs + fm


def _pair_marginals(seg_ids, truth_ids, counts, S, T, device):
    dev = resolve_device(device)
    c = _counts(counts, dev)
    seg = _ids(seg_ids, dev)
    truth = _ids(truth_ids, dev)
    row = segment_sum_auto(c, seg, S)
    col = segment_sum_auto(c, truth, T)
    return c, seg, truth, row, col


def cell_counts_device(seg_ids, truth_ids, counts, S, T,
                       device: DeviceLike = None) -> torch.Tensor:
    """The dense contingency table [S * T] (float64, cell ``s * T + t``)
    of rows (seg id, truth id, count): rows of one cell add up.  One
    segment sum (kernel B2's atomic entry on the card) of integer counts,
    exact below 2**53 in any order, so it equals a host ``np.bincount``
    of the same rows."""
    dev = resolve_device(device)
    code = _ids(seg_ids, dev) * T + _ids(truth_ids, dev)
    return segment_sum_auto(_counts(counts, dev), code, S * T)


def vi_from_pairs_device(seg_ids, truth_ids, counts, S, T, itk_quirk=True,
                         device: DeviceLike = None):
    """eval_vi's printed numbers from a SPARSE exact contingency table on
    the device (segment sums; no dense [S, T] matrix, so usable at SNEMI
    scale where S is millions).

    (seg_ids, truth_ids, counts): the K non-empty cells (exclusions --
    truth BG, masks -- applied by the caller, as in metrics.vi.eval_vi).
    itk_quirk reproduces the reference's unsigned-integer division
    (image_stats.hxx:152) exactly: counts are integers and float64 holds
    them exactly to 2^53.  Returns (false_split, false_merge, total) as
    float64 scalar tensors."""
    c, seg, truth, row, col = _pair_marginals(seg_ids, truth_ids, counts,
                                              S, T, device)
    n = c.sum()

    def _centropy(c0):
        # H(image1 | image0) where c0 = per-cell image0-marginal counts
        if itk_quirk:
            ratio = torch.floor(c0 / torch.clamp(c, min=1.0))
        else:
            ratio = c0 / torch.clamp(c, min=1.0)
        return (c * torch.log2(torch.clamp(ratio, min=1e-300))).sum() \
            / torch.clamp(n, min=1.0)

    fs = _centropy(col[truth])   # centropy(truth, seg)
    fm = _centropy(row[seg])     # centropy(seg, truth)
    return fs, fm, fs + fm


def pair_counts_from_pairs_device(seg_ids, truth_ids, counts, S, T,
                                  device: DeviceLike = None):
    """(TP, TP + FP, TP + FN) pixel-pair counts from a SPARSE contingency
    table: pairs in one cell, pairs in one segment, pairs in one truth
    region; float64 scalar tensors, exact below 2^53 (a 105M-voxel volume
    has ~5.5e15 pairs, inside the bound)."""
    c, _, _, row, col = _pair_marginals(seg_ids, truth_ids, counts, S, T,
                                        device)
    return _c2(c).sum(), _c2(row).sum(), _c2(col).sum()


def _adapted_rand(tp, pairs_seg, pairs_truth):
    prec = tp / torch.clamp(pairs_seg, min=1.0)
    rec = tp / torch.clamp(pairs_truth, min=1.0)
    f = 2.0 * prec * rec / torch.clamp(prec + rec, min=1e-30)
    return prec, rec, 1.0 - f


def adapted_rand_from_pairs_device(seg_ids, truth_ids, counts, S, T,
                                   device: DeviceLike = None):
    """(precision, recall, error) from a SPARSE contingency table on the
    device, from ``pair_counts_from_pairs_device``."""
    return _adapted_rand(*pair_counts_from_pairs_device(
        seg_ids, truth_ids, counts, S, T, device=device))


def adapted_rand_device(seg_ids, truth_ids, S, T, device: DeviceLike = None):
    """(precision, recall, error) from the dense float64 pair counts."""
    c = contingency_device(seg_ids, truth_ids, S, T, device=device)
    return _adapted_rand(_c2(c).sum(), _c2(c.sum(dim=1)).sum(),
                         _c2(c.sum(dim=0)).sum())
