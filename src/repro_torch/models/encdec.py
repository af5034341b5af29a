"""The encoder-decoder backbone (seamless-m4t class): the port's copy of
the JAX package's ``models/encdec.py``. A bidirectional encoder over the
frontend's frame embeddings, and an autoregressive text decoder whose
layers add cross-attention over the encoded memory.

The audio frontend (mel + conv feature extractor) is a stub, as in JAX:
callers hand in precomputed frame embeddings (B, T_src, d_embed).

Trees keep the JAX package's layout: ``enc_layers`` and ``dec_layers``
stack their leaves on a leading layer axis, and the cache is ``{"self":
the decoder's KV ring, "xk", "xv": the cross-attention memory}``, every
leaf ``[n_layers, batch, ...]``. The memory is written once, when a
request is admitted (``cross_kv_all``, or ``prefill``), and read
untouched by every later extend and decode. As in the decoder stacks
(``transformer``), cache writes land in place, and every norm goes
through the fused add + RMSNorm op with the residual add folded in:
``ln1``, ``ln_x`` and ``ln2`` a decoder layer, ``ln1`` and ``ln2`` an
encoder layer, then ``enc_ln`` and ``ln_f``.

Attention routes (``layers``): the encoder's self-attention and the
cache-free cross-attention (``forward_train``, ``prefill``) are
bidirectional (``layers.full_attention``: the flash kernel non-causal on
the card); the cached cross-attention (decode and extend: T rows
against the frozen S-slot memory) is ``layers.memory_attention``, the
decode-attention kernel over an all-valid position row on the card.
The CPU runs plain ``gqa_attention(causal=False)`` for all three, the
JAX model's route.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as shapes: the keys and shapes of the JAX
    package's ``init_encdec``. Encoder projections are ``n_heads *
    cfg.hd`` wide, as JAX's ``init_attention`` makes them."""
    d, hd, e = cfg.d_model, cfg.hd, cfg.encoder
    ne, nd = e.n_layers, cfg.n_layers

    def lin(n, d_in, d_out, bias=False):
        p = {"w": (n, d_in, d_out)}
        if bias:
            p["b"] = (n, d_out)
        return p

    def attn(n, hq, hkv):
        b = cfg.qkv_bias
        return {"wq": lin(n, d, hq * hd, b), "wk": lin(n, d, hkv * hd, b),
                "wv": lin(n, d, hkv * hd, b), "wo": lin(n, hq * hd, d)}

    def mlp(n, d_ff):
        return {"wi": lin(n, d, d_ff), "wg": lin(n, d, d_ff),
                "wo": lin(n, d_ff, d)}

    return {
        "frontend_proj": {"w": (cfg.frontend.d_embed, d)},
        "enc_layers": {"ln1": {"scale": (ne, d)},
                       "attn": attn(ne, e.n_heads, e.n_kv_heads),
                       "ln2": {"scale": (ne, d)},
                       "mlp": mlp(ne, e.d_ff)},
        "enc_ln": {"scale": (d,)},
        "embed": {"table": (cfg.vocab, d)},
        "dec_layers": {"ln1": {"scale": (nd, d)},
                       "self_attn": attn(nd, cfg.n_heads, cfg.n_kv_heads),
                       "ln_x": {"scale": (nd, d)},
                       "cross_attn": attn(nd, cfg.n_heads, cfg.n_kv_heads),
                       "ln2": {"scale": (nd, d)},
                       "mlp": mlp(nd, cfg.d_ff)},
        "ln_f": {"scale": (d,)},
        "lm_head": {"w": (d, cfg.vocab)},
    }


def _at(tree, i):
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def _n(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# --------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------- #
def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T_src, d_embed) -> memory (B, T_src, d). Frames of
    another dtype than the weights are projected in the promoted dtype,
    as JAX promotes (``layers.project``)."""
    x = L.project(params["frontend_proj"], frames).to(cfg.act_dtype)
    e, eps = cfg.encoder, cfg.norm_eps
    hd = cfg.d_model // e.n_heads
    res = None
    for i in range(_n(params["enc_layers"])):
        lp = _at(params["enc_layers"], i)
        h, x = L.rms_norm(lp["ln1"], x, eps, residual=res)
        B, T, _ = h.shape
        q, k, v = L._qkv(lp["attn"], h, hd)
        if cfg.rope:
            at = torch.arange(T, device=h.device)
            q = L.apply_rope(q, at, cfg.rope_theta)
            k = L.apply_rope(k, at, cfg.rope_theta)
        y = L.full_attention(q, k, v)                   # bidirectional
        y = L.linear(lp["attn"]["wo"], y.reshape(B, T, -1))
        h, x = L.rms_norm(lp["ln2"], y, eps, residual=x)
        res = L.mlp(lp["mlp"], h)
    h, _ = L.rms_norm(params["enc_ln"], x, eps, residual=res)
    return h


# --------------------------------------------------------------------- #
# decoder
# --------------------------------------------------------------------- #
def _cross_kv(lp, memory, cfg: ModelConfig):
    B, S, _ = memory.shape
    k = L.linear(lp["cross_attn"]["wk"], memory).reshape(B, S, -1, cfg.hd)
    v = L.linear(lp["cross_attn"]["wv"], memory).reshape(B, S, -1, cfg.hd)
    return k, v


def _dec_block(lp, x, res, cfg: ModelConfig, *, mode, cache=None,
               memory=None, length=None):
    """One decoder layer; the stream arrives as ``x + res`` and leaves so
    (the MLP's output pending). mode: 'train' | 'prefill' | 'extend' |
    'decode'. ``cache``: the layer's ``{"self", "xk", "xv"}`` views;
    prefill writes the memory's K/V into ``xk``/``xv``, extend and decode
    read them. ``length``: valid counts (prefill) or per-row advances
    (extend)."""
    eps = cfg.norm_eps
    h, x = L.rms_norm(lp["ln1"], x, eps, residual=res)
    if mode == "train":
        y, _ = L.attention_block(lp["self_attn"], h, cfg)
    elif mode == "prefill":
        y, _ = L.prefill_into_cache(lp["self_attn"], h, cfg, cache["self"],
                                    length=length)
    elif mode == "extend":
        y, _ = L.extend_into_cache(lp["self_attn"], h, cfg, cache["self"],
                                   lengths=length)
    elif mode == "decode":
        y, _ = L.attention_block(lp["self_attn"], h, cfg,
                                 cache=cache["self"])
    else:
        raise ValueError(f"unknown mode {mode!r}")

    h, x = L.rms_norm(lp["ln_x"], y, eps, residual=x)
    B, Lq = h.shape[:2]
    q = L.linear(lp["cross_attn"]["wq"], h).reshape(B, Lq, -1, cfg.hd)
    if mode in ("decode", "extend"):
        y = L.memory_attention(q, cache["xk"], cache["xv"])
    else:
        xk, xv = _cross_kv(lp, memory, cfg)
        if mode == "prefill":
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
        y = L.full_attention(q, xk, xv)
    y = L.linear(lp["cross_attn"]["wo"], y.reshape(B, Lq, -1))

    h, x = L.rms_norm(lp["ln2"], y, eps, residual=x)
    return x, L.mlp(lp["mlp"], h)


def make_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      src_len: int, dtype=None, device="cpu"):
    """``{"self": KV ring, "xk", "xv": (batch, src_len, Hkv, hd)}``
    stacked ``[n_layers, ...]``. ``cfg.kv_quant`` stores the growing
    self-attention ring as int8; the cross-attention memory (written once
    at admission, bounded by src_len) stays in the model dtype."""
    dtype = dtype or cfg.act_dtype
    nl = cfg.n_layers
    ring = L.make_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.hd, dtype,
                           device, quant=cfg.kv_quant)
    mem = (nl, batch, src_len, cfg.n_kv_heads, cfg.hd)
    return {"self": {k: v[None].repeat((nl,) + (1,) * v.dim())
                     for k, v in ring.items()},
            "xk": torch.zeros(mem, dtype=dtype, device=device),
            "xv": torch.zeros(mem, dtype=dtype, device=device)}


def _run_dec(params, x, cfg, *, mode, cache=None, memory=None, length=None):
    res = None
    for i in range(_n(params["dec_layers"])):
        c = None if cache is None else _at(cache, i)
        x, res = _dec_block(_at(params["dec_layers"], i), x, res, cfg,
                            mode=mode, cache=c, memory=memory, length=length)
    return x, res


def _logits(params, cfg: ModelConfig, x, res):
    h, _ = L.rms_norm(params["ln_f"], x, cfg.norm_eps, residual=res)
    return L.linear(params["lm_head"], h).float()


def _embed(params, cfg, tokens):
    return L.embed(params["embed"], tokens).to(cfg.act_dtype)


def forward_train(params, cfg: ModelConfig, tokens, embeddings):
    """embeddings: (B, T_src, d_embed) frames; tokens: (B, L). Returns
    (logits (B, L, V) f32, aux loss 0)."""
    memory = encode(params, cfg, embeddings)
    x, res = _run_dec(params, _embed(params, cfg, tokens), cfg,
                      mode="train", memory=memory)
    return _logits(params, cfg, x, res), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params, cfg: ModelConfig, tokens, cache, embeddings,
            length=None):
    """Encode, write the memory and the decoder ring in place; returns
    (last-valid logits, cache)."""
    memory = encode(params, cfg, embeddings)
    x, res = _run_dec(params, _embed(params, cfg, tokens), cfg,
                      mode="prefill", cache=cache, memory=memory,
                      length=length)
    return _logits(params, cfg, L.last_valid(x, length),
                   L.last_valid(res, length)), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    x, res = _run_dec(params, _embed(params, cfg, token), cfg,
                      mode="decode", cache=cache)
    return _logits(params, cfg, x, res), cache


def extend_step(params, cfg: ModelConfig, tokens, cache, lengths=None,
                last_only=False):
    """Masked multi-token cached decoder forward at per-row offsets, the
    decoder's twin of ``transformer.extend_step``: the cache must already
    hold the memory (``cross_kv_all`` written at admission); only the
    self-attention ring advances."""
    x, res = _run_dec(params, _embed(params, cfg, tokens), cfg,
                      mode="extend", cache=cache, length=lengths)
    if last_only:
        x, res = L.last_valid(x, lengths), L.last_valid(res, lengths)
    return _logits(params, cfg, x, res), cache


def cross_kv_all(params, cfg: ModelConfig, memory):
    """Every decoder layer's cross-attention K/V over an encoded memory
    (B, S, d): ``(xk, xv)``, each (n_layers, B, S, Hkv, hd), exactly the
    cache's ``xk``/``xv`` leaves, so the engine encodes once at
    admission and writes the rows into a slot."""
    ks, vs = [], []
    for i in range(_n(params["dec_layers"])):
        k, v = _cross_kv(_at(params["dec_layers"], i), memory, cfg)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)
