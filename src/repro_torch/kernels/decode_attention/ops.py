"""Decode attention against the model's cache layout: the op the model's
cached attention calls for every decode step and every extend."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref


def cached_decode_attention(q, k_cache, v_cache, pos, q_pos, *, window=0):
    """q (B, T, Hq, hd); k/v cache (B, S, Hkv, hd); pos (B, S) int32;
    q_pos (B,) base position (query t sits at ``q_pos + t``) or (B, T)
    per-query positions. Returns (B, T, Hq, hd) in q's dtype: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    T = q.shape[1]
    if q_pos.dim() == 1:
        q_pos = q_pos[:, None] + torch.arange(T, dtype=q_pos.dtype,
                                              device=q_pos.device)[None]
    if dispatch.use_kernel(q, k_cache, v_cache, pos, q_pos):
        return _kernel.decode_attention_cuda(q, k_cache, v_cache, pos,
                                             q_pos.contiguous(),
                                             window=window)
    return _ref.decode_attention_reference(q, k_cache, v_cache, pos, q_pos,
                                           window=window)
