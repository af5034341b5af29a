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


def _mask(Lq, Lk, causal, window, device):
    qpos = torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _probs(q, k, causal, window):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[3])
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.softmax(torch.where(mask[None, None], s, NEG_INF), dim=-1)


def attention_reference(q, k, v, *, causal=True, window=0):
    p = _probs(q, k, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_backward_reference(q, k, v, do, *, causal=True, window=0):
    """(dq, dk, dv) of the attention of q, do (B, Hq, Lq, hd) over k, v
    (B, Hkv, Lk, hd), Hq a multiple of Hkv (each KV head's gradients
    summed over its G query heads), in the inputs' dtypes."""
    G = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(G, dim=1) if G != 1 else k
    vx = v.repeat_interleave(G, dim=1) if G != 1 else v
    p = _probs(q, kx, causal, window)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    scale = 1.0 / math.sqrt(q.shape[3])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    if G != 1:
        B, H, Lk, hd = dk.shape
        dk = dk.reshape(B, H // G, G, Lk, hd).sum(2)
        dv = dv.reshape(B, H // G, G, Lk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
