"""Device and dtype policy.

Entry points run on the CUDA card unless the caller names another device:
a missing card is an error, never a silent move to the CPU.  The working
float type follows the device: float32 on CUDA (what the TPU engine ran,
with x64 off) and float64 on the CPU (what glia_tpu's CPU tests run).
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and raises
    when CUDA is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "glia_tpu_torch runs on a CUDA device and none is available;"
                " pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def default_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The working float type: ``dtype`` if given, else float32 on CUDA
    and float64 elsewhere."""
    if dtype is not None:
        return dtype
    return torch.float32 if device.type == "cuda" else torch.float64


def synchronize(device: torch.device):
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read next measures the work and not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line): a limit below 700 W slows the card under load, so
    every measurement carries it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
