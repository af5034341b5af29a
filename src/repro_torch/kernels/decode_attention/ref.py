"""Plain PyTorch version of decode attention, in the model's cache layout.

q: (B, T, Hq, hd) -- T new query tokens per sequence (T = 1 for a plain
decode step, T > 1 for a chunked-prefill extend); k, v: (B, S, Hkv, hd),
the KV ring as the model stores it; pos: (B, S) the absolute position in
each slot (-1 = empty); q_pos: (B, T) the absolute position of each
query. The same function as the JAX package's
``decode_attention_reference`` (which takes K/V as (B, Hkv, S, hd)): f32
scores and softmax, masked scores at the finite NEG_INF, so a row with
every slot masked returns the mean of V.

``paged_decode_attention_reference`` is the paged-cache version: K/V
live in a page pool and each sequence maps logical blocks to pages
through its block-table row.

``decode_attention_split_reference`` models the CUDA kernel's split of
S over blocks and the combine pass in plain f32 PyTorch, for the tests
(nothing on the model's path calls it).
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


def decode_attention_split_reference(q, k, v, pos, q_pos, *, window=0,
                                     per):
    """The function of ``decode_attention_reference`` computed as the
    kernel's split route does: split i of S covers slots
    ``[i * per, (i + 1) * per)`` (the last one ragged) and yields its
    rows' unnormalized partials, m (the split's row max over its masked
    scores, NEG_INF when all of them are masked), l = sum exp(s - m) and
    acc = sum exp(s - m) v; the combine takes M = max m_i and returns
    sum exp(m_i - M) acc_i / sum exp(m_i - M) l_i (l == 0 -> 1), splits
    in order. A fully masked row has m_i = NEG_INF in every split, so it
    returns the mean of V over all S slots, as the one-pass function
    does. f32 throughout, natural-log domain (the kernel works in
    log2)."""
    B, T, Hq, hd = q.shape
    S = k.shape[1]
    G = Hq // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bths", q.float(), kf) / math.sqrt(hd)
    kp = pos[:, None, :]
    qp = q_pos[:, :, None]
    valid = (kp >= 0) & (kp <= qp)
    if window:
        valid &= kp > qp - window
    s = torch.where(valid[:, :, None, :], s, NEG_INF)   # (B, T, Hq, S)
    ms, ls, accs = [], [], []
    for lo in range(0, S, per):
        sc = s[..., lo:lo + per]
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bths,bshd->bthd", p, vf[:, lo:lo + per]))
    M = torch.stack(ms).amax(0)
    f = [torch.exp(m - M) for m in ms]
    L = sum(fi * li for fi, li in zip(f, ls))
    acc = sum(fi * ai for fi, ai in zip(f, accs))
    return (acc / torch.where(L == 0, torch.ones_like(L), L)).to(q.dtype)


def paged_kv_gather(k_pool, v_pool, block_table):
    """The contiguous logical view ``(B, S = NB * ps, Hkv, hd)`` of a
    page pool ``(P + 1, ps, Hkv, hd)`` through ``block_table (B, NB)``.
    Positions backed by the trash page (the last) hold its junk."""
    B, NB = block_table.shape
    ps = k_pool.shape[1]
    bt = block_table.long()
    k = k_pool[bt].reshape(B, NB * ps, *k_pool.shape[2:])
    v = v_pool[bt].reshape(B, NB * ps, *v_pool.shape[2:])
    return k, v


def paged_decode_attention_reference(q, k_pool, v_pool, block_table, pos,
                                     q_pos, *, window=0):
    """k_pool, v_pool: (P + 1, ps, Hkv, hd) with the trash page last;
    block_table: (B, NB) int; pos: (B, S = NB * ps); q, q_pos as in
    ``decode_attention_reference``. Gathers the logical view and defers
    to it, as the JAX oracle does; trash-page junk is masked by
    ``pos == -1``."""
    k, v = paged_kv_gather(k_pool, v_pool, block_table)
    return decode_attention_reference(q, k, v, pos, q_pos, window=window)
