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

Attention without a causal mask (the encoder-decoder's encoder and its
cross-attention) has two routes: ``full_attention`` (cache-free: the
flash kernel non-causal on the card) and ``memory_attention`` (T rows
against a frozen memory: the decode-attention kernel on the card); the
CPU runs plain ``gqa_attention(causal=False)`` for both, as JAX does.

Quantized projections are structural, as in JAX: a QTensor dict
(``{"q"|"q4", "scale"}``, ``repro_torch.quant``) where ``p["w"]`` was a
tensor routes ``linear`` through the dequantize-matmul op.

On a serving mesh (``distribution.sharding.use_mesh``; one process a
rank) the layers run rank-local, the port's counterpart of JAX's GSPMD
partitioning under ``param_shardings``: ``wq``/``wk``/``wv``, an MLP's
``wi``/``wg`` and the LM head are column-parallel (the rank's output
columns), ``wo`` of attention and of the MLP row-parallel (the rank's
input rows, then one ``all_reduce`` over the model group), and a
vocab-sharded embedding table is looked up with out-of-range ids masked
and ``all_reduce``d, its unembedding ``all_gather``ed. Attention runs
on the rank's whole heads when the KV heads divide the model axis;
otherwise the projections are ``all_gather``ed to whole heads and
attention and the cache are replicated (the layout ``cache_shardings``
gives). Which collectives a layer issues is a function of the config
and the mesh's sizes alone (the sharding rules), so a model axis of 1
issues the same ones as N. The params are the rank's blocks, as
``sharding.shard_tree`` cuts them by ``param_shardings`` (the engine
and a mesh endpoint place them so). The CUDA kernels run on the local
shards.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.sharding import current_mesh
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


def project(p, x):
    """``linear`` of an input whose dtype may differ from the weight's
    (frontend frames in f32 against bf16 weights): both go to the
    promoted dtype first, as JAX promotes ``x @ w``. A quantized weight
    takes x as it is."""
    w = p["w"]
    if isinstance(w, dict) or x.dtype == w.dtype:
        return linear(p, x)
    dt = torch.promote_types(x.dtype, w.dtype)
    return linear({k: v.to(dt) for k, v in p.items()}, x.to(dt))


def rms_norm(p, x, eps=1e-5, residual=None):
    """RMSNorm of ``x + residual`` through the fused op: returns (normed,
    x + residual), the sum being ``x`` itself when ``residual`` is None."""
    return fused_rmsnorm(x, residual, p["scale"], eps=eps)


def top_k(x, k):
    """The k largest entries of x along its last dim and their indices,
    ties broken by lowest index, as ``lax.top_k`` does (a descending
    stable sort cut at k): the one top-k rule of the port, for the MoE
    router and the sampler."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def embed(p, ids, vocab=None):
    """Token embeddings. On a mesh (``vocab`` given, dividing the model
    axis) the rank's vocab block is looked up with out-of-range ids
    masked to zero, and the blocks are summed by an ``all_reduce``."""
    tp = _tp(vocab)
    if tp is None:
        return F.embedding(ids, p["table"])
    mesh, r, vl = tp
    local = ids - r * vl
    inside = (local >= 0) & (local < vl)
    e = F.embedding(local.clamp(0, vl - 1), p["table"])
    return mesh.all_reduce(torch.where(inside[..., None], e,
                                       torch.zeros_like(e)))


def unembed(p, x, vocab=None):
    """Logits against the (tied) embedding table; on a mesh the rank's
    vocab block, ``all_gather``ed."""
    tp = _tp(vocab)
    if tp is None:
        return x @ p["table"].T
    mesh, _, _ = tp
    return mesh.all_gather(x @ p["table"].T, "model", dim=-1)


# --------------------------------------------------------------------- #
# rank-local projections (a serving mesh)
# --------------------------------------------------------------------- #
def _tp(n_full):
    """(mesh, this rank's model index, n_full's block size) when a mesh
    is current and ``n_full`` divides its model axis (the rule shards
    that dim); None otherwise (no mesh, no size known, or a dim the rule
    replicates)."""
    mesh = current_mesh()
    if mesh is None or not n_full:
        return None
    mp = mesh.axis_size("model")
    if n_full % mp:
        return None
    return mesh, mesh.axis_index("model"), n_full // mp


def _row_block(w, r, k_local, k_full):
    """A row-parallel weight as ``linear`` takes it on rank ``r``. A
    tensor, and an int8 QTensor's ``q`` with its per-channel scale, are
    the rank's block already. An int4 QTensor's ``q4`` is too, but its
    group scale is replicated (``_qtensor_spec``): the rank keeps the
    group rows its K range covers, or, where a group straddles two
    ranks, per-row scales (group size 1)."""
    if not isinstance(w, dict) or "q4" not in w or k_local == k_full:
        return w
    q4, scale = w["q4"], w["scale"]
    if 2 * q4.shape[-2] != k_local:
        raise ValueError(f"an int4 block of {k_local} rows splits a "
                         f"packed byte")
    gs = k_full // scale.shape[-2]
    if k_local % gs:
        scale = scale.repeat_interleave(gs, dim=-2).narrow(
            -2, r * k_local, k_local)
    else:
        scale = scale.narrow(-2, r * k_local // gs, k_local // gs)
    return {"q4": q4, "scale": scale}


def col_linear(p, x, n_full, gather=False):
    """Column-parallel projection onto ``n_full`` outputs: on a mesh
    ``p`` holds the rank's block of them (``all_gather``ed to all
    ``n_full`` with ``gather``); ``linear`` off a mesh or where the rule
    replicates."""
    y = linear(p, x)
    tp = _tp(n_full)
    if tp is None or not gather:
        return y
    return tp[0].all_gather(y, "model", dim=-1)


def row_partial(p, x, k_full, x_whole=False):
    """Row-parallel projection from ``k_full`` inputs without its
    reduction: (the rank's partial sum, True) on a mesh (``x`` holds the
    rank's inputs, or all ``k_full`` of them with ``x_whole``, cut here;
    the bias is left out), (``linear``, False) off a mesh or where the
    rule replicates."""
    tp = _tp(k_full)
    if tp is None:
        return linear(p, x), False
    _, r, kl = tp
    if x_whole:
        x = x.narrow(-1, r * kl, kl)
    return linear({"w": _row_block(p["w"], r, kl, k_full)}, x), True


def row_linear(p, x, k_full, x_whole=False):
    """Row-parallel projection: the partial sums ``all_reduce``d over the
    model group, then the bias."""
    y, partial = row_partial(p, x, k_full, x_whole)
    if not partial:
        return y
    y = current_mesh().all_reduce(y)
    return y + p["b"] if "b" in p else y


def last_valid(x, length):
    """x: (B, L, ...); length: (B,) valid counts -> (B, 1, ...) at each
    row's last valid position (the last position if None)."""
    if length is None:
        return x[:, -1:]
    idx = torch.clamp(length.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


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


def full_attention(q, k, v):
    """Bidirectional attention, every query over every key: the
    encoder's self-attention and the cache-free cross-attention (Lq may
    differ from Lk). On CUDA tensors the flash kernel, non-causal; on CPU
    tensors plain ``gqa_attention(causal=False)``, the JAX model's
    route."""
    if use_kernel(q, k, v):
        return gqa_flash(q, k, v, causal=False)
    return gqa_attention(q, k, v, causal=False)


#: (device, S) -> the all-valid position row ``arange(S)`` that the
#: cached cross-attention hands the decode-attention kernel: one
#: persistent tensor, so a captured graph reads a fixed address
_MEMORY_POS = {}


def memory_positions(S, device):
    key = (torch.device(device), int(S))
    row = _MEMORY_POS.get(key)
    if row is None:
        row = _MEMORY_POS[key] = torch.arange(S, dtype=torch.int32,
                                              device=device)
    return row


def memory_attention(q, xk, xv):
    """Cached cross-attention: q (B, T, Hq, hd) against the frozen memory
    xk, xv (B, S, Hkv, hd), every slot valid, no mask. On CUDA tensors
    the decode-attention kernel over the persistent position row
    (``memory_positions``, broadcast over the batch) with every query at
    position S - 1, so every slot passes its causal test: the kernel's
    ``mma_keys`` route at decode, ``mma_rows`` for a chunk. On CPU
    tensors plain ``gqa_attention(causal=False)``, the JAX model's
    route."""
    if use_kernel(q, xk, xv):
        B, T = q.shape[:2]
        S = xk.shape[1]
        pos = memory_positions(S, q.device)[None].expand(B, S)
        q_pos = torch.full((B, T), S - 1, dtype=torch.int32,
                           device=q.device)
        return cached_decode_attention(q, xk, xv, pos, q_pos)
    return gqa_attention(q, xk, xv, causal=False)


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


def _qkv(p, x, hd, cfg=None):
    """q, k, v (B, L, H, hd). On a mesh (``cfg`` given) the rank's heads
    when the KV heads divide the model axis, else all heads, gathered
    from the column blocks."""
    B, L, _ = x.shape
    if cfg is None or current_mesh() is None:
        return (linear(p["wq"], x).reshape(B, L, -1, hd),
                linear(p["wk"], x).reshape(B, L, -1, hd),
                linear(p["wv"], x).reshape(B, L, -1, hd))
    gather = _heads_gathered(cfg)
    return tuple(col_linear(p[k], x, n * hd, gather).reshape(B, L, -1, hd)
                 for k, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                              ("wv", cfg.n_kv_heads)))


def _heads_gathered(cfg: ModelConfig) -> bool:
    """On a mesh whose model axis the KV heads do not divide, attention
    runs on all heads, gathered from the column blocks."""
    mesh = current_mesh()
    return mesh is not None and \
        cfg.n_kv_heads % mesh.axis_size("model") != 0


def _out(p, y, cfg):
    """The output projection of attention rows y (B, L, H * hd):
    row-parallel on a mesh."""
    return row_linear(p["wo"], y, cfg.n_heads * cfg.hd,
                      x_whole=_heads_gathered(cfg))


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
    q, k, v = _qkv(p, x, hd, cfg)
    if cache is None:
        if cfg.rope:
            at = torch.arange(L, device=x.device) if positions is None \
                else positions
            q = apply_rope(q, at, cfg.rope_theta)
            k = apply_rope(k, at, cfg.rope_theta)
        y = _self_attention(q, k, v, cfg, positions, window)
        return _out(p, y.reshape(B, L, -1), cfg), None

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
        return _out(p, y.reshape(B, L, -1), cfg), cache
    bidx = torch.arange(B, device=x.device)
    _write_kv(cache, (bidx, slot), k[:, 0], v[:, 0])
    cache["pos"][bidx, slot] = step
    if _is_int8(cache):
        y = _int8_attend(q, cache, pos, window)
    else:
        y = cached_decode_attention(q, cache["k"], cache["v"],
                                    cache["pos"], step, window=window)
    cache["step"] += 1
    return _out(p, y.reshape(B, L, -1), cfg), cache


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
    that callers discard (``last_valid``). Returns (y, cache)
    with ``step`` advanced by ``lengths``."""
    B, T, _ = x.shape
    hd = cfg.hd
    window = cfg.sliding_window if window is None else window
    step = cache["step"]                                   # (B,) int32
    pos = step[:, None] + torch.arange(T, dtype=step.dtype,
                                       device=x.device)[None]   # (B, T)
    q, k, v = _qkv(p, x, hd, cfg)
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
        return _out(p, y.reshape(B, T, -1), cfg), cache
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
    return _out(p, y.reshape(B, T, -1), cfg), cache


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
    q, k, v = _qkv(p, x, hd, cfg)
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
    return _out(p, y.reshape(B, L, -1), cfg), cache


# --------------------------------------------------------------------- #
# gated MLP (SwiGLU)
# --------------------------------------------------------------------- #
def mlp_partial(p, x, d_ff=None):
    """The gated MLP without its reduction: (y, partial) as
    ``row_partial`` gives them; on a mesh (``d_ff`` given) ``wi``/``wg``
    are column-parallel and ``wo`` row-parallel."""
    h = F.silu(col_linear(p["wg"], x, d_ff)) * col_linear(p["wi"], x, d_ff)
    return row_partial(p["wo"], h, d_ff)


def mlp(p, x, d_ff=None):
    """The gated MLP (SwiGLU); on a mesh (``d_ff`` given) tensor-parallel
    with one ``all_reduce``."""
    y, partial = mlp_partial(p, x, d_ff)
    if not partial:
        return y
    y = current_mesh().all_reduce(y)
    return y + p["wo"]["b"] if "b" in p["wo"] else y
