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

Cached attention (decode and extend) on a model-dtype cache goes
through a decode-attention op: ``cached_decode_attention`` on a
contiguous ring, ``paged_decode_attention`` on a paged pool; the CUDA
kernel on the card, its plain version on the CPU (the JAX model's
``use_decode_kernel=True`` route). An int8 KV cache (``quant=True``:
int8 K/V with one f32 scale per slot and head) is dequantized and read
by plain ``gqa_attention``, as the JAX model always does for it: the
JAX package has no kernel there. The cache-free self-attention
(``forward_train``, ``prefill_into_cache``) goes through the
flash-attention op on the card (``ops.gqa_flash``, the CUDA kernel that
replaces the JAX package's flash Pallas kernels) and keeps plain
``gqa_attention`` / ``chunked_causal_attention`` on the CPU, where it is
held against the JAX model's route bit for bit.

Quantized projections are structural, as in JAX: a QTensor dict
(``{"q"|"q4", "scale"}``, ``repro_torch.quant``) where ``p["w"]`` was a
tensor routes ``linear`` through the dequantize-matmul op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    cached_decode_attention, paged_decode_attention)
from repro_torch.kernels.decode_attention.ref import paged_kv_gather
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

NEG_INF = -1e30


# --------------------------------------------------------------------- #
# projections, norms, embeddings
# --------------------------------------------------------------------- #
def linear(p, x):
    """Dense or quantized projection ``x @ w (+ b)``: a QTensor dict
    ``w`` goes through the fused dequantize-matmul op (the CUDA kernel
    on the card, its plain version on the CPU)."""
    w = p["w"]
    y = quant_matmul(x, w) if isinstance(w, dict) else x @ w
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
    """Causal self-attention of a whole sequence at ``positions`` (None:
    ``arange(L)``, the positions every caller in the port builds). On
    CUDA tensors: the flash-attention kernel, which places queries and
    keys at ``arange(L)``, so positions a caller hands in must be exactly
    that (checked on the device, without a host sync; None needs no
    check). On CPU tensors: plain ``gqa_attention``, block-tiled above
    ``cfg.attn_block``, the JAX model's own route (its probabilities
    rounded to v's dtype before the PV product). On the card the kernel
    rounds p the same way for bf16 inputs, where p is the bf16 A operand
    of the tensor-core PV product, and keeps p in f32 for fp32 inputs
    (the Pallas kernel's arithmetic); scores, sums and the normalisation
    stay f32 on both."""
    if use_kernel(q, k, v):
        if positions is not None:
            _assert_from_zero(positions, q.shape[1])
        return gqa_flash(q, k, v, causal=True, window=window)
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device)
    if cfg.attn_block and q.shape[1] > cfg.attn_block:
        return chunked_causal_attention(q, k, v, block=cfg.attn_block,
                                        positions=positions, window=window)
    return gqa_attention(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True, window=window)


def _assert_from_zero(positions, L):
    """``positions`` is ``arange(L)``: its shape on the host, its values
    by an asynchronous device-side assert (a CPU tensor raises at once)."""
    if positions.shape != (L,):
        raise ValueError(f"the flash route takes positions arange({L}), "
                         f"got shape {tuple(positions.shape)}")
    torch._assert_async(
        (positions == torch.arange(L, device=positions.device)).all(),
        "the flash route takes positions arange(L)")


# --------------------------------------------------------------------- #
# attention with KV cache
# --------------------------------------------------------------------- #
def make_kv_cache(batch, length, n_kv_heads, hd, dtype, device,
                  quant=False):
    """Cache dict: ``k``/``v`` (B, S, Hkv, hd), ``pos`` (B, S) int32 (the
    absolute position in each slot, -1 = empty) and ``step`` (B,) int32
    (each row's token count). ``quant=True`` stores K/V as int8 with
    f32 scales ``k_scale``/``v_scale`` (B, S, Hkv), one per slot and
    head."""
    kv_dtype = torch.int8 if quant else dtype
    c = {
        "k": torch.zeros((batch, length, n_kv_heads, hd), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((batch, length, n_kv_heads, hd), dtype=kv_dtype,
                         device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quant:
        for key in ("k_scale", "v_scale"):
            c[key] = torch.zeros((batch, length, n_kv_heads),
                                 dtype=torch.float32, device=device)
    return c


def make_paged_kv_cache(batch, length, n_kv_heads, hd, dtype, device, *,
                        page_size, num_pages, quant=False):
    """Paged cache dict (see ``serving/paged_kv.py``): K/V live in pools
    ``kp``/``vp`` (num_pages + 1, page_size, Hkv, hd) shared by all
    slots; each slot maps logical blocks to pool pages through its row of
    ``bt`` (B, NB) int32. Pool index ``num_pages`` is the trash page:
    unallocated entries point at it, so reads stay in bounds (junk
    masked by ``pos == -1``) and masked-off writes land there. ``pos``
    (B, S = NB * page_size) and ``step`` (B,) keep the contiguous
    layout's dense per-slot shape. ``quant=True`` stores the pools as
    int8 with f32 scale pools ``kp_scale``/``vp_scale`` (num_pages + 1,
    page_size, Hkv)."""
    nb = -(-int(length) // int(page_size))
    pool = (num_pages + 1, page_size, n_kv_heads, hd)
    kv_dtype = torch.int8 if quant else dtype
    c = {
        "kp": torch.zeros(pool, dtype=kv_dtype, device=device),
        "vp": torch.zeros(pool, dtype=kv_dtype, device=device),
        "bt": torch.full((batch, nb), num_pages, dtype=torch.int32,
                         device=device),
        "pos": torch.full((batch, nb * int(page_size)), -1,
                          dtype=torch.int32, device=device),
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quant:
        for key in ("kp_scale", "vp_scale"):
            c[key] = torch.zeros(pool[:3], dtype=torch.float32,
                                 device=device)
    return c


def _quantize_kv(x):
    """x: (..., hd) -> (int8 values, f32 scale per vector), in f32 from
    the model-dtype K/V, as the JAX layer does. The scale is ``max|x| *
    (1/127)``: the compiled JAX program (XLA turns the division by the
    constant into that product) computes it so, and the caches are
    bit-equal to its caches."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _write_kv(cache, idx, k, v, valid=None):
    """Store K and V (model dtype, ``(..., Hkv, hd)``) at index ``idx`` of
    the cache's K/V leaves: ``k``/``v`` on a ring, ``kp``/``vp`` on a
    pool. An int8 cache stores them quantized, with their scales at the
    same index of ``<leaf>_scale``. ``valid`` (bool, ``k``'s shape
    without its last two dims) or None: where False, the old values and
    scales at ``idx`` stay."""
    names = ("kp", "vp") if "bt" in cache else ("k", "v")
    for name, x in zip(names, (k, v)):
        scale_key = name + "_scale"
        if scale_key in cache:
            x, sc = _quantize_kv(x)
            if valid is not None:
                sc = torch.where(valid[..., None], sc, cache[scale_key][idx])
            cache[scale_key][idx] = sc
        if valid is not None:
            x = torch.where(valid[..., None, None], x, cache[name][idx])
        cache[name][idx] = x


def paged_kv_view(cache, dtype=None):
    """The contiguous logical view ``(B, S, Hkv, hd)`` of a paged cache's
    pools through its block table (a gathered copy), dequantized to
    ``dtype`` when the pools are int8: gather-then-dequantize is
    elementwise the contiguous layout's dequantize, so the view is
    bit-equal to what a contiguous cache holds at the same positions.
    Positions backed by the trash page hold junk; callers mask with
    ``pos == -1``."""
    k, v = paged_kv_gather(cache["kp"], cache["vp"], cache["bt"])
    if "kp_scale" in cache:
        ks, vs = paged_kv_gather(cache["kp_scale"], cache["vp_scale"],
                                 cache["bt"])
        k, v = _dequantize_kv(k, ks, dtype), _dequantize_kv(v, vs, dtype)
    return k, v


def _is_int8(cache):
    return "k_scale" in cache or "kp_scale" in cache


def _int8_attend(q, cache, q_pos, window):
    """Attention over an int8 cache (ring or pool) dequantized to
    ``q.dtype``: plain ``gqa_attention`` with slot validity ``pos >= 0``,
    the JAX layer's route for int8 KV (its decode kernel never takes a
    quantized cache)."""
    if "bt" in cache:
        k_read, v_read = paged_kv_view(cache, q.dtype)
    else:
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], q.dtype)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], q.dtype)
    pos = cache["pos"]
    return gqa_attention(q, k_read, v_read, q_positions=q_pos,
                         k_positions=pos, causal=True, window=window,
                         k_valid=pos >= 0)


def _paged_attend(q, k, v, cache, pos, slots, valid, window):
    """Write the new K/V through the block table, then attend against the
    updated cache through the paged decode-attention op (int8 pools: the
    dequantized view through ``gqa_attention``). ``pos``/``slots`` (B,
    T): absolute positions and their ring slots; ``valid`` (B, T) bool or
    None (all valid). A masked entry's K/V (and its scales) goes to the
    trash page (duplicate trash indices are harmless: junk that ``pos ==
    -1`` masks) and its ``pos`` keeps the old value. The engine
    guarantees every targeted page is allocated and unshared before the
    step is dispatched. Writes land in ``cache`` in place."""
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
    _write_kv(cache, (page, off), k, v)
    cache["pos"].scatter_(1, slots, new_pos.to(torch.int32))
    if _is_int8(cache):
        return _int8_attend(q, cache, pos, window)
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
      attends through the decode-attention op (an int8 cache: plain
      attention on its dequantized copy).
    Returns (y, cache)."""
    B, L, _ = x.shape
    hd = cfg.hd
    window = cfg.sliding_window if window is None else window
    q, k, v = _qkv(p, x, hd)
    if cache is None:
        if cfg.rope:
            at = torch.arange(L, device=x.device) if positions is None \
                else positions
            q = apply_rope(q, at, cfg.rope_theta)
            k = apply_rope(k, at, cfg.rope_theta)
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
    _write_kv(cache, (bidx, slot), k[:, 0], v[:, 0])
    cache["pos"][bidx, slot] = step
    if _is_int8(cache):
        y = _int8_attend(q, cache, pos, window)
    else:
        y = cached_decode_attention(q, cache["k"], cache["v"],
                                    cache["pos"], step, window=window)
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
    new_pos = pos if valid is None else \
        torch.where(valid, pos, cache["pos"][bidx, slots])
    _write_kv(cache, (bidx, slots), k, v, valid)
    cache["pos"][bidx, slots] = new_pos
    if _is_int8(cache):
        y = _int8_attend(q, cache, pos, window)
    else:
        y = cached_decode_attention(q, cache["k"], cache["v"],
                                    cache["pos"], pos, window=window)
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
    y = _self_attention(q, k, v, cfg, None, window)
    S = cache["k"].shape[1]
    if length is not None and S < L:
        raise NotImplementedError(
            "length-masked prefill requires cache length >= padded length "
            f"(got S={S} < L={L})")
    if S >= L:
        _write_kv(cache, (slice(None), slice(None, L)), k, v)
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
        _write_kv(cache, (slice(None), slots), k[:, L - S:], v[:, L - S:])
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
