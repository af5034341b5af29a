"""Triton kernel for the fused residual add + RMSNorm.

Replaces: src/repro/kernels/rmsnorm/kernel.py, ``fused_rmsnorm_pallas``
(body ``_rmsnorm_kernel``).

One program per row (d = 2048 on llama3.2-1b fits one block): load x and
the residual, add in f32, store the sum as the new residual stream,
reduce the sum of squares in registers, scale and store y. Without a
residual the same kernel skips the add and the second store.

What bounds it: bytes, 4*N*d*elt + d*elt (read x and the residual, write
y and t; read the scale); its few operations per byte are far below the
card's ridge. ``triton`` is imported, and the kernel compiled, on the
first launch only, so the module imports where Triton is absent.
"""
from __future__ import annotations

import torch

tl = None        # triton.language, bound on the first launch
_JIT = None
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_D = 16384


def _rmsnorm_fwd(x_ptr, r_ptr, s_ptr, y_ptr, t_ptr, d, eps,
                 HAS_RES: "tl.constexpr", BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < d
    x = tl.load(x_ptr + row * d + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_RES:
        r = tl.load(r_ptr + row * d + offs, mask=mask,
                    other=0.0).to(tl.float32)
        t = x + r
        tl.store(t_ptr + row * d + offs, t.to(t_ptr.dtype.element_ty),
                 mask=mask)
    else:
        t = x
    var = tl.sum(t * t, axis=0) / d
    rstd = 1.0 / tl.sqrt(var + eps)
    s = tl.load(s_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = t * rstd * s
    tl.store(y_ptr + row * d + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language as language
        tl = language
        _JIT = triton.jit(_rmsnorm_fwd)
    return _JIT


def fused_rmsnorm_triton(x, residual, scale, eps=1e-5):
    """x, residual: (N, d) contiguous CUDA tensors of one dtype (residual
    may be None); scale: (d,). Returns (y, t) in x's dtype, t = x when
    there is no residual. Raises on any input the kernel does not take."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, d) tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    N, d = x.shape
    ts = (x, scale) if residual is None else (x, residual, scale)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("fused_rmsnorm_triton takes CUDA tensors on one "
                         "device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtypes {x.dtype}, {scale.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or not residual.is_contiguous()):
        raise ValueError("residual must match x in shape and dtype and be "
                         "contiguous")
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous ({d},) tensor")
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the one-block limit {MAX_D}")
    y = torch.empty_like(x)
    t = x if residual is None else torch.empty_like(x)
    block = 1 << (d - 1).bit_length()
    if N:
        _compiled()[(N,)](x, x if residual is None else residual, scale, y,
                          t, d, float(eps), HAS_RES=residual is not None,
                          BLOCK=block, num_warps=min(max(block // 256, 1),
                                                     16))
        fused_rmsnorm_triton.launches += 1
    return y, t


fused_rmsnorm_triton.launches = 0
