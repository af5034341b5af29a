"""ctypes bindings of the CUDA dequantize-matmul kernels
(``csrc/quant_matmul.cu``): ``quant_matmul_int8_cuda`` (it replaces the
JAX package's ``quant_matmul_int8_pallas``) and ``quant_matmul_int4_cuda``
(``quant_matmul_int4_pallas``). One entry point in one library, built with
``nvcc`` on first use (``kernels/_build.py``).

The wrapper picks the split of K (``plan``), allocates the output and,
when K is split, the f32 workspace of partial sums; the library launches
the main kernel and, for a split, the kernel that adds the splits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BM, BN = 8, 128          # the kernel's tile of x rows and y columns
TARGET_BLOCKS = 528      # two waves of 2 blocks on each of 132 SMs
MAX_SPLITS = 16
SPLIT_ALIGN = 64         # a split covers a multiple of this many rows
_FN = []


def _launcher():
    if not _FN:
        fn = _build.load("quant_matmul").quant_matmul_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, p, p, p, p] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def plan(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """(blocks, splits, rows per split) for an (M, K) x (K, N) product:
    split K until about ``TARGET_BLOCKS`` blocks run, at most
    ``MAX_SPLITS`` splits of a multiple of ``SPLIT_ALIGN`` rows."""
    base = -(-N // BN) * -(-M // BM)
    want = min(MAX_SPLITS, max(1, -(-TARGET_BLOCKS // base)))
    kper = -(-K // want)
    kper = -(-kper // SPLIT_ALIGN) * SPLIT_ALIGN
    splits = -(-K // kper)
    return base * splits, splits, kper


def _launch(name, x, q, scale, *, int4):
    if not all(t.is_cuda and t.device == x.device for t in (x, q, scale)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {list(_DTYPES)}, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"want int8 weights and f32 scales; got {q.dtype}, "
                        f"{scale.dtype}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"want 2-D x and weights; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    if int4:
        ng = scale.shape[0] if scale.dim() == 2 else 0
        if K % 2 or q.shape[0] != K // 2 or scale.dim() != 2 \
                or scale.shape[1] != N or ng < 1 or K % ng:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q4 "
                             f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
        gs = K // ng
    else:
        if q.shape[0] != K or scale.shape != (N,):
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
        gs = 0
    if M < 1 or N < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, weights "
                         f"{tuple(q.shape)}")
    if x.stride(1) != 1 or not q.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError("x's last dimension, the weights and the scales "
                         "must be contiguous")
    if x.dtype == torch.bfloat16 and (K % 2 or x.data_ptr() % 4
                                      or (M > 1 and x.stride(0) % 2)):
        raise ValueError("bfloat16 x needs an even K and its rows on "
                         "4-byte boundaries")
    _, splits, kper = plan(M, N, K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(
        x.data_ptr(), x.stride(0), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K, gs,
        kper, splits, int(int4), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def quant_matmul_int8_cuda(x, q, scale):
    """x: (M, K) f32 or bf16, last dimension contiguous; q: (K, N) int8;
    scale: (N,) f32 -> a new (M, N) tensor in x's dtype. Raises on any
    input the kernel does not take, and when the launch is refused."""
    out = _launch("quant_matmul_int8_cuda", x, q, scale, int4=False)
    quant_matmul_int8_cuda.launches += 1
    return out


def quant_matmul_int4_cuda(x, q4, scale):
    """x: (M, K) f32 or bf16, last dimension contiguous; q4: (K//2, N)
    packed int8; scale: (K//gs, N) f32 -> a new (M, N) tensor in x's
    dtype. Raises on any input the kernel does not take, and when the
    launch is refused."""
    out = _launch("quant_matmul_int4_cuda", x, q4, scale, int4=True)
    quant_matmul_int4_cuda.launches += 1
    return out


quant_matmul_int8_cuda.launches = 0
quant_matmul_int4_cuda.launches = 0
