"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version: ``decode_attention`` (CUDA C++, ``csrc/decode_attention.cu``)
and ``rmsnorm`` (Triton). ``launch_counts`` reads the launch counter each
kernel wrapper keeps."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_triton

_WRAPPERS = {"decode_attention": decode_attention_cuda,
             "rmsnorm": fused_rmsnorm_triton}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
