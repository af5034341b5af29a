"""Core layers of the dense decoder: projections, norms, RoPE, GQA
attention, the KV-cached attention paths and the gated MLP.

Plain functions on tensors and parameter dicts whose keys are the JAX
package's (``{"w"}``, ``{"scale"}``, ``{"table"}``), so a parameter tree
converts leaf for leaf (``repro_torch.bridge``).

Two things differ from the JAX layers on purpose:

* **Caches are updated in place.** JAX donates the cache and returns a
  new one; here every write goes into the caller's tensors (the
  per-layer views ``cache["k"][i]`` of the stacked cache, or a slot's
  view ``[:, slot:slot+1]``), and the functions return the same dict.
* **Masked writes never leave the cache.** Where JAX sends a row past
  its length to slot S and relies on a dropping scatter (an
  out-of-bounds index is a device assert in torch), each entry of a
  contiguous ring keeps its own slot ``(step + t) % S`` (distinct for
  T <= S): the old value is gathered there and ``where(valid, new,
  old)`` is written back. On a paged cache a masked entry's K/V goes to
  the trash page instead (as JAX's ``_paged_attend`` sends it), and its
  ``pos`` write keeps the old value: rewriting old K/V through the
  block table would write into pages a later prefix alias may share.
  Nothing is out of bounds and nothing needs a host sync.

Cached attention (decode and extend) always goes through a decode-
attention op: ``cached_decode_attention`` on a contiguous ring,
``paged_decode_attention`` on a paged pool; the CUDA kernel on the card,
its plain version on the CPU (the JAX model's ``use_decode_kernel=True``
route). The cache-free forward keeps plain ``gqa_attention``, which JAX
also runs outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    cached_decode_attention, paged_decode_attention)
from repro_torch.kernels.decode_attention.ref import paged_kv_gather
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

NEG_INF = -1e30


# --------------------------------------------------------------------- #
# projections, norms, embeddings
# --------------------------------------------------------------------- #
def linear(p, x):
    """Dense projection ``x @ w (+ b)``; quantized weights arrive with
    the quantization slice (ROADMAP section 1, item 8)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rms_norm(p, x, eps=1e-5, residual=None):
    """RMSNorm of ``x + residual`` through the fused op: returns (normed,
    x + residual), the sum being ``x`` itself when ``residual`` is None."""
    return fused_rmsnorm(x, residual, p["scale"], eps=eps)


def embed(p, ids):
    return F.embedding(ids, p["table"])


def unembed(p, x):
    return x @ p["table"].T


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_cos_sin(positions, head_dim, theta):
    """positions: int tensor (...,) -> f32 cos/sin of shape
    (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, theta):
    """Half-split rotation (not interleaved pairs): x (B, L, H, hd),
    positions (L,) or (B, L)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]   # head axis
    while cos.dim() < x.dim():                        # leading batch axis
        cos, sin = cos[None], sin[None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention core (cache-free forward)
# --------------------------------------------------------------------- #
def gqa_attention(q, k, v, *, q_positions=None, k_positions=None,
                  causal=True, window=0, k_valid=None):
    """Grouped-query attention. q: (B, Lq, Hq, hd); k, v: (B, Lk, Hkv,
    hd). Scores are accumulated in f32 from the model-dtype operands
    (bf16 products are exact in f32), probabilities are cast to v's
    dtype before the PV product, as in the JAX layer."""
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Lq, Hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = None
    if causal or window:
        dev = q.device
        if q_positions is None:
            q_positions = torch.arange(Lq, device=dev)
        if k_positions is None:
            k_positions = torch.arange(Lk, device=dev)
        qp = q_positions if q_positions.dim() == 2 else q_positions[None]
        kp = k_positions if k_positions.dim() == 2 else k_positions[None]
        m = kp[:, None, :] <= qp[:, :, None] if causal else \
            torch.ones((1, Lq, Lk), dtype=torch.bool, device=dev)
        if window:
            m = m & (kp[:, None, :] > qp[:, :, None] - window)
        mask = m
    if k_valid is not None:
        kv = k_valid if k_valid.dim() == 2 else k_valid[None]
        valid = kv[:, None, :]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                    # f32
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Lq, Hq, hd).to(q.dtype)


def chunked_causal_attention(q, k, v, *, block, positions=None, window=0):
    """Block-tiled causal attention: query block i attends only to the KV
    prefix it can see. q: (B, L, Hq, hd); k, v: (B, L, Hkv, hd)."""
    B, L, Hq, hd = q.shape
    block = min(block, L)
    if L % block:
        raise ValueError(f"length {L} is not a multiple of block {block}")
    if positions is None:
        positions = torch.arange(L, device=q.device)
    outs = []
    for i in range(L // block):
        start = 0
        if window:
            start = max(0, (i * block - window + 1) // block) * block
        end = (i + 1) * block
        outs.append(gqa_attention(
            q[:, i * block:end], k[:, start:end], v[:, start:end],
            q_positions=positions[i * block:end],
            k_positions=positions[start:end], causal=True, window=window))
    return torch.cat(outs, dim=1)


def _self_attention(q, k, v, cfg, positions, window):
    if cfg.attn_block and q.shape[1] > cfg.attn_block:
        return chunked_causal_attention(q, k, v, block=cfg.attn_block,
                                        positions=positions, window=window)
    return gqa_attention(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True, window=window)


# --------------------------------------------------------------------- #
# attention with KV cache
# --------------------------------------------------------------------- #
def make_kv_cache(batch, length, n_kv_heads, hd, dtype, device,
                  quant=False):
    """Cache dict: ``k``/``v`` (B, S, Hkv, hd), ``pos`` (B, S) int32 (the
    absolute position in each slot, -1 = empty) and ``step`` (B,) int32
    (each row's token count)."""
    if quant:
        raise NotImplementedError(
            "int8 KV caches are not ported yet: ROADMAP section 1, item 8")
    return {
        "k": torch.zeros((batch, length, n_kv_heads, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, n_kv_heads, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _int8_kv_not_ported():
    return NotImplementedError(
        "int8 KV caches are not ported yet: ROADMAP section 1, item 8")


def make_paged_kv_cache(batch, length, n_kv_heads, hd, dtype, device, *,
                        page_size, num_pages, quant=False):
    """Paged cache dict (see ``serving/paged_kv.py``): K/V live in pools
    ``kp``/``vp`` (num_pages + 1, page_size, Hkv, hd) shared by all
    slots; each slot maps logical blocks to pool pages through its row of
    ``bt`` (B, NB) int32. Pool index ``num_pages`` is the trash page:
    unallocated entries point at it, so reads stay in bounds (junk
    masked by ``pos == -1``) and masked-off writes land there. ``pos``
    (B, S = NB * page_size) and ``step`` (B,) keep the contiguous
    layout's dense per-slot shape."""
    if quant:
        raise _int8_kv_not_ported()
    nb = -(-int(length) // int(page_size))
    pool = (num_pages + 1, page_size, n_kv_heads, hd)
    return {
        "kp": torch.zeros(pool, dtype=dtype, device=device),
        "vp": torch.zeros(pool, dtype=dtype, device=device),
        "bt": torch.full((batch, nb), num_pages, dtype=torch.int32,
                         device=device),
        "pos": torch.full((batch, nb * int(page_size)), -1,
                          dtype=torch.int32, device=device),
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def paged_kv_view(cache):
    """The contiguous logical view ``(B, S, Hkv, hd)`` of a paged cache's
    pools through its block table (a gathered copy). Positions backed by
    the trash page hold junk; callers mask with ``pos == -1``."""
    if "kp_scale" in cache:
        raise _int8_kv_not_ported()
    return paged_kv_gather(cache["kp"], cache["vp"], cache["bt"])


def _paged_attend(q, k, v, cache, pos, slots, valid, window):
    """Write the new K/V through the block table, then attend against the
    updated cache through the paged decode-attention op. ``pos``/
    ``slots`` (B, T): absolute positions and their ring slots; ``valid``
    (B, T) bool or None (all valid). A masked entry's K/V goes to the
    trash page (duplicate trash indices are harmless: junk that
    ``pos == -1`` masks) and its ``pos`` keeps the old value. The engine
    guarantees every targeted page is allocated and unshared before the
    step is dispatched. Writes land in ``cache`` in place."""
    if "kp_scale" in cache:
        raise _int8_kv_not_ported()
    B = q.shape[0]
    ps = cache["kp"].shape[1]
    trash = cache["kp"].shape[0] - 1
    page = torch.take_along_dim(cache["bt"], slots // ps, dim=1).long()
    off = slots % ps
    new_pos = pos
    if valid is not None:
        page = torch.where(valid, page, trash)
        bidx = torch.arange(B, device=q.device)[:, None]
        new_pos = torch.where(valid, pos, cache["pos"][bidx, slots])
    cache["kp"][page, off] = k
    cache["vp"][page, off] = v
    cache["pos"].scatter_(1, slots, new_pos.to(torch.int32))
    return paged_decode_attention(q, cache["kp"], cache["vp"], cache["bt"],
                                  cache["pos"], pos, window=window)


def _qkv(p, x, hd):
    B, L, _ = x.shape
    return (linear(p["wq"], x).reshape(B, L, -1, hd),
            linear(p["wk"], x).reshape(B, L, -1, hd),
            linear(p["wv"], x).reshape(B, L, -1, hd))


def attention_block(p, x, cfg: ModelConfig, *, cache=None, positions=None,
                    window=None):
    """Self-attention. x: (B, L, d).

    * cache=None: full-sequence causal attention (train).
    * cache given, L == 1: one decode step; writes slot ``step % S`` of
      every row in place (through the block table on a paged cache) and
      attends through the decode-attention op.
    Returns (y, cache)."""
    B, L, _ = x.shape
    hd = cfg.hd
    window = cfg.sliding_window if window is None else window
    q, k, v = _qkv(p, x, hd)
    if cache is None:
        if positions is None:
            positions = torch.arange(L, device=x.device)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        y = _self_attention(q, k, v, cfg, positions, window)
        return linear(p["wo"], y.reshape(B, L, -1)), None

    S = cache["pos"].shape[1]
    step = cache["step"]                                   # (B,) int32
    pos = step[:, None]                                    # (B, 1)
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    slot = (step % S).long()
    if "bt" in cache:                                      # paged layout
        y = _paged_attend(q, k, v, cache, pos, slot[:, None], None, window)
        cache["step"] += 1
        return linear(p["wo"], y.reshape(B, L, -1)), cache
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = step
    y = cached_decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                step, window=window)
    cache["step"] += 1
    return linear(p["wo"], y.reshape(B, L, -1)), cache


def extend_into_cache(p, x, cfg: ModelConfig, cache, *, lengths=None,
                      window=None):
    """Masked multi-token cached forward at per-row offsets: the path
    behind chunked prefill and the engine's fused mixed step. x: (B, T,
    d); row b advances by ``lengths[b] <= T`` tokens (None = all by T).
    K/V and positions of the first ``lengths[b]`` tokens are written at
    ring slots ``(step + t) % S``; the other entries of those slots are
    rewritten with their old values (on a paged cache their K/V goes to
    the trash page), so the masked tail of every row is left as it was.
    Attention runs with query positions ``step + t``
    against the updated cache; outputs past a row's length are garbage
    that callers discard (``transformer.last_valid``). Returns (y, cache)
    with ``step`` advanced by ``lengths``."""
    B, T, _ = x.shape
    hd = cfg.hd
    window = cfg.sliding_window if window is None else window
    step = cache["step"]                                   # (B,) int32
    pos = step[:, None] + torch.arange(T, dtype=step.dtype,
                                       device=x.device)[None]   # (B, T)
    q, k, v = _qkv(p, x, hd)
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    S = cache["pos"].shape[1]
    if T > S:
        raise ValueError(f"extend window T={T} exceeds cache length S={S}")
    slots = (pos % S).long()                               # (B, T) distinct
    valid = None if lengths is None else \
        torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    inc = T if lengths is None else lengths.to(step.dtype)
    if "bt" in cache:                                      # paged layout
        y = _paged_attend(q, k, v, cache, pos, slots, valid, window)
        cache["step"] += inc
        return linear(p["wo"], y.reshape(B, T, -1)), cache
    bidx = torch.arange(B, device=x.device)[:, None]
    if valid is None:
        new_pos = pos
    else:
        vm = valid[:, :, None, None]
        k = torch.where(vm, k, cache["k"][bidx, slots])
        v = torch.where(vm, v, cache["v"][bidx, slots])
        new_pos = torch.where(valid, pos, cache["pos"][bidx, slots])
    cache["k"][bidx, slots] = k
    cache["v"][bidx, slots] = v
    cache["pos"][bidx, slots] = new_pos
    y = cached_decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                pos, window=window)
    cache["step"] += inc
    return linear(p["wo"], y.reshape(B, T, -1)), cache


def prefill_into_cache(p, x, cfg: ModelConfig, cache, *, window=None,
                       length=None):
    """Prefill L tokens from position 0 and populate the cache in place.
    ``length``: optional (B,) int32 count of valid tokens per row when
    ``x`` is right-padded; the whole ``pos`` row is then rewritten so a
    recycled slot keeps no stale keys. Returns (y, cache)."""
    B, L, _ = x.shape
    hd = cfg.hd
    window = cfg.sliding_window if window is None else window
    positions = torch.arange(L, device=x.device)
    q, k, v = _qkv(p, x, hd)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    y = _self_attention(q, k, v, cfg, positions, window)
    S = cache["k"].shape[1]
    if length is not None and S < L:
        raise NotImplementedError(
            "length-masked prefill requires cache length >= padded length "
            f"(got S={S} < L={L})")
    if S >= L:
        cache["k"][:, :L] = k
        cache["v"][:, :L] = v
        if length is not None:
            slot_ids = torch.arange(S, dtype=torch.int32,
                                    device=x.device)[None]
            cache["pos"].copy_(torch.where(
                slot_ids < length[:, None], slot_ids,
                torch.full_like(slot_ids, -1)).expand(B, S))
        else:
            cache["pos"][:, :L] = positions.to(torch.int32)[None]
    else:  # keep the last S tokens, aligned to their ring slots
        tail = positions[L - S:]
        slots = tail % S
        cache["k"][:, slots] = k[:, L - S:]
        cache["v"][:, slots] = v[:, L - S:]
        cache["pos"][:, slots] = tail.to(torch.int32)[None]
    cache["step"].copy_(length if length is not None else
                        torch.full((B,), L, dtype=torch.int32,
                                   device=x.device))
    return linear(p["wo"], y.reshape(B, L, -1)), cache


# --------------------------------------------------------------------- #
# gated MLP (SwiGLU)
# --------------------------------------------------------------------- #
def mlp(p, x):
    return linear(p["wo"], F.silu(linear(p["wg"], x)) * linear(p["wi"], x))
