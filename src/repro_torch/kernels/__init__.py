"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version: ``decode_attention`` and ``paged_decode_attention`` (CUDA C++,
``csrc/decode_attention.cu``), ``quant_matmul_int8`` and
``quant_matmul_int4`` (CUDA C++, ``csrc/quant_matmul.cu``), ``ssd`` and
``ssd_extend`` (CUDA C++, ``csrc/ssd_scan.cu``), ``flash_attention``
(CUDA C++, ``csrc/flash_attention.cu``) and ``rmsnorm`` (CUDA C++,
``csrc/rmsnorm.cu``: the add + norm, the norm alone and Mamba-2's gated
norm, one counter). ``launch_counts`` reads the launch counter each
kernel wrapper keeps. A replayed CUDA graph runs its kernels with no
Python, so no wrapper counts them: the program that captured them takes
back what its capture counted (``recorded_launches``) and adds it at
every replay (``add_launches``), and the counters keep their meaning,
launches that ran."""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, paged_decode_attention_cuda)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.quant_matmul.kernel import (
    quant_matmul_int4_cuda, quant_matmul_int8_cuda)
from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_cuda
from repro_torch.kernels.ssd_scan.kernel import ssd_cuda, ssd_extend_cuda

_WRAPPERS = {"decode_attention": decode_attention_cuda,
             "paged_decode_attention": paged_decode_attention_cuda,
             "quant_matmul_int8": quant_matmul_int8_cuda,
             "quant_matmul_int4": quant_matmul_int4_cuda,
             "rmsnorm": fused_rmsnorm_cuda,
             "ssd": ssd_cuda,
             "ssd_extend": ssd_extend_cuda,
             "flash_attention": flash_attention_cuda}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (wrapper name -> launches) to the counters."""
    for name, n in delta.items():
        _WRAPPERS[name].launches += n


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit,
    the launches the wrappers counted inside the block, by name, and
    sets the counters back, since a capture records kernels and runs
    none of them (also when the block raises)."""
    before = launch_counts()
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for name, n in launch_counts().items():
            if n != before[name]:
                delta[name] = n - before[name]
        add_launches({name: -n for name, n in delta.items()})
