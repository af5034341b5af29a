"""Plain PyTorch version of decode attention, in the model's cache layout.

q: (B, T, Hq, hd) -- T new query tokens per sequence (T = 1 for a plain
decode step, T > 1 for a chunked-prefill extend); k, v: (B, S, Hkv, hd),
the KV ring as the model stores it; pos: (B, S) the absolute position in
each slot (-1 = empty); q_pos: (B, T) the absolute position of each
query. The same function as the JAX package's
``decode_attention_reference`` (which takes K/V as (B, Hkv, S, hd)): f32
scores and softmax, masked scores at the finite NEG_INF, so a row with
every slot masked returns the mean of V.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_reference(q, k, v, pos, q_pos, *, window=0):
    B, T, Hq, hd = q.shape
    G = Hq // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)          # (B, S, Hq, hd)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bths", q.float(), kf) / math.sqrt(hd)
    kp = pos[:, None, :]                                # (B, 1, S)
    qp = q_pos[:, :, None]                              # (B, T, 1)
    valid = (kp >= 0) & (kp <= qp)
    if window:
        valid &= kp > qp - window
    s = torch.where(valid[:, :, None, :], s, NEG_INF)   # (B, T, Hq, S)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bths,bshd->bthd", p, vf).to(q.dtype)
