"""Which implementation of a kernel op runs, and where.

One rule, decided by the tensors alone: tensors on a CUDA device go to
the hand-written Hopper kernel, tensors on the CPU go to the op's plain
PyTorch version. There is no environment variable or flag that sends a
CUDA tensor to the plain version, and a kernel that fails to build or
launch raises instead of falling back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every
    tensor is on the CPU; anything else (mixed devices, meta tensors)
    raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel ops take tensors all on CUDA or all on the "
                     f"CPU, got devices {sorted(kinds)}")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA without a visible CUDA device raises; no
    entry point quietly runs on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required (no CUDA device is visible); pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
