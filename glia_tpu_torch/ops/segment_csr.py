"""Batched segment sum (the RAG "SpMM"): out[s] = sum of values[i] over
seg_ids[i] == s.

Counterpart of glia_tpu.ops.pallas.segment_csr.  The TPU kernel is a
one-hot matmul on the MXU; on a CUDA card the reduction is the hand-written
kernel ``ops/cuda/segment_sum.cu`` (exact in the values' own type), and on
the CPU the plain version below.  Rows whose id is negative or
>= n_segments are dropped (the padding convention).
"""

from __future__ import annotations

import torch


def segment_sum_torch(values: torch.Tensor, seg_ids: torch.Tensor,
                      n_segments: int, sorted: bool = False) -> torch.Tensor:
    """Plain PyTorch segment sum: values [B, F] or [B], seg_ids [B] ->
    [S, F] or [S].  The CPU path, and the yardstick the CUDA kernel is
    held against.  ``sorted=True`` states that the ids are non-decreasing;
    it is checked on a CPU tensor, and the result is the same either way
    (``index_add_`` on the CPU adds in index order)."""
    if seg_ids.ndim != 1 or seg_ids.shape[0] != values.shape[0]:
        raise ValueError(f"seg_ids must be [{values.shape[0]}], got "
                         f"{tuple(seg_ids.shape)}")
    ids = seg_ids.long()
    if sorted and ids.device.type == "cpu" and ids.numel() > 1:
        if bool((ids[1:] < ids[:-1]).any()):
            raise ValueError("sorted=True but seg_ids decrease")
    S = int(n_segments)
    keep = (ids >= 0) & (ids < S)
    # dropped rows go to an extra slot, which is cut off
    ids = torch.where(keep, ids, S)
    out = values.new_zeros((S + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids, values)[:S]


def segment_sum_auto(values: torch.Tensor, seg_ids: torch.Tensor,
                     n_segments: int, sorted: bool = False) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor: chosen by the tensor's device and by nothing else."""
    if values.device.type == "cuda":
        from .cuda import segment_sum_cuda

        return segment_sum_cuda(values.contiguous(),
                                seg_ids.long().contiguous(), n_segments,
                                sorted=sorted)
    if values.device.type == "cpu":
        return segment_sum_torch(values, seg_ids, n_segments, sorted=sorted)
    raise ValueError(f"no segment sum for device {values.device}")
