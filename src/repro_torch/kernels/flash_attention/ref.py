"""Plain PyTorch version of flash attention (per-head layout).

q, k, v: (B, H, L, hd) with the same head count (the ops expand GQA
heads before calling it). Causal and/or a sliding window, positions from
0 for queries and keys alike. The same function as the JAX package's
``flash_attention/ref.py``: f32 scores and softmax, masked scores at the
finite NEG_INF, and f32 probabilities into the PV product (the model's
``gqa_attention`` rounds them to v's dtype first; this does not).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal=True, window=0):
    Lq, Lk, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
