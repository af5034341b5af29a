"""Decode attention against the model's cache layouts: the ops the
model's cached attention calls for every decode step and every extend,
over a contiguous ring (``cached_decode_attention``) or a paged pool
(``paged_decode_attention``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref


def _per_query(q_pos, T):
    """(B,) base position -> (B, T) positions ``base + t``."""
    if q_pos.dim() == 1:
        q_pos = q_pos[:, None] + torch.arange(T, dtype=q_pos.dtype,
                                              device=q_pos.device)[None]
    return q_pos


def cached_decode_attention(q, k_cache, v_cache, pos, q_pos, *, window=0):
    """q (B, T, Hq, hd); k/v cache (B, S, Hkv, hd); pos (B, S) int32;
    q_pos (B,) base position (query t sits at ``q_pos + t``) or (B, T)
    per-query positions. Returns (B, T, Hq, hd) in q's dtype: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    q_pos = _per_query(q_pos, q.shape[1])
    if dispatch.use_kernel(q, k_cache, v_cache, pos, q_pos):
        return _kernel.decode_attention_cuda(q, k_cache, v_cache, pos,
                                             q_pos.contiguous(),
                                             window=window)
    return _ref.decode_attention_reference(q, k_cache, v_cache, pos, q_pos,
                                           window=window)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, q_pos, *,
                           window=0):
    """Paged layout (``layers.make_paged_kv_cache``): q (B, T, Hq, hd);
    k/v pool (P + 1, ps, Hkv, hd) with the trash page last; block_table
    (B, NB) int32; pos (B, S = NB * ps) int32; q_pos (B,) base or (B, T)
    per-query positions. Returns (B, T, Hq, hd) in q's dtype: the CUDA
    kernel for CUDA tensors (it reads pages through the table, no
    gathered copy), the plain version for CPU tensors."""
    q_pos = _per_query(q_pos, q.shape[1])
    if dispatch.use_kernel(q, k_pool, v_pool, block_table, pos, q_pos):
        return _kernel.paged_decode_attention_cuda(
            q, k_pool, v_pool, block_table, pos, q_pos.contiguous(),
            window=window)
    return _ref.paged_decode_attention_reference(q, k_pool, v_pool,
                                                 block_table, pos, q_pos,
                                                 window=window)
