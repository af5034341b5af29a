"""The dense decoder stack: parameters, the stacked cache and the layer
loop behind every forward mode.

Parameters and caches keep the JAX package's tree layout: block leaves
carry the stacked block axis first (``[n_blocks, ...]``), cache leaves
``[n_blocks, batch, ...]`` with a per-row ``step``, so slots at
different depths share one batched cache. The layer loop takes the
per-block views ``leaf[i]``; cache writes land in the stacked tensors.

Every norm of the stack goes through the fused add + RMSNorm op, with
the add of the residual stream folded in: a block receives the stream
as ``x + res`` (``res`` is the previous sublayer's output, still to be
added; None before the first block), ``ln1`` adds and normalises in one
call, the attention output is added in the same call that computes
``ln2``, and the MLP output is left pending for the next block's ``ln1``
or for ``ln_f``. That is 2 * n_layers + 1 norm calls per forward. In
fp32 this is the JAX stack's arithmetic; in bf16 each norm reads the f32
sum where the JAX stack rounds ``x + y`` to bf16 first (see
``kernels/rmsnorm/ref.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


# --------------------------------------------------------------------- #
# block structure
# --------------------------------------------------------------------- #
def block_spec(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """[(mixer, ffn)] per sublayer of the scan unit."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", "mlp")]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: ROADMAP section 1, "
        f"item 10")


def n_blocks(cfg: ModelConfig) -> int:
    k = len(block_spec(cfg))
    if cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} not a multiple of the "
                         f"block size {k}")
    return cfg.n_layers // k


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as shapes: the same keys and shapes as the JAX
    package's ``init_transformer``."""
    nb, d, hd = n_blocks(cfg), cfg.d_model, cfg.hd

    def lin(d_in, d_out, bias=False):
        p = {"w": (nb, d_in, d_out)}
        if bias:
            p["b"] = (nb, d_out)
        return p

    sub = {
        "ln1": {"scale": (nb, d)},
        "attn": {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
                 "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                 "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                 "wo": lin(cfg.n_heads * hd, d)},
        "ln2": {"scale": (nb, d)},
        "mlp": {"wi": lin(d, cfg.d_ff), "wg": lin(d, cfg.d_ff),
                "wo": lin(cfg.d_ff, d)},
    }
    p = {"embed": {"table": (cfg.vocab, d)},
         "blocks": {f"sub{i}": sub for i in range(len(block_spec(cfg)))},
         "ln_f": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": (d, cfg.vocab)}
    return p


def init_transformer(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    """Weights from a seed, made on ``device`` with a ``torch.Generator``:
    N(0, 0.02) projections and embeddings, unit norm scales, zero biases
    (the JAX package's scheme; the numbers are not JAX's)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(path, shape):
        leaf = path[-1]
        if leaf == "scale":
            return torch.ones(shape, dtype=cfg.p_dtype, device=device)
        if leaf == "b":
            return torch.zeros(shape, dtype=cfg.p_dtype, device=device)
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * 0.02).to(cfg.p_dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return make(path, node)

    return walk(param_shapes(cfg), ())


# --------------------------------------------------------------------- #
# cache
# --------------------------------------------------------------------- #
def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cpu"):
    """Stacked decode cache: every leaf ``[n_blocks, batch, ...]``; the
    ring is ``min(cache_len, sliding_window)`` long under a window."""
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV caches are not ported yet: ROADMAP section 1, item 8")
    dtype = dtype or cfg.act_dtype
    S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    nb = n_blocks(cfg)
    c = {}
    for i in range(len(block_spec(cfg))):
        one = L.make_kv_cache(batch, S, cfg.n_kv_heads, cfg.hd, dtype,
                              device)
        c[f"sub{i}"] = {k: v[None].repeat((nb,) + (1,) * v.dim())
                        for k, v in one.items()}
    return c


def cache_steps(cache):
    """Per-slot sequence depth (B,) of the first attention sub-cache."""
    for sub in cache.values():
        if isinstance(sub, dict) and "step" in sub:
            return sub["step"][0]
    return None


def set_cache_steps(cache, steps):
    """Rewind every attention sub-cache to depth ``steps`` (B,) in place.
    ``pos`` entries beyond the new depth stay: causal masking hides them
    until the decode step that overwrites their slot."""
    steps = steps.to(torch.int32)
    for sub in cache.values():
        sub["step"].copy_(steps[None].expand_as(sub["step"]))
    return cache


def _at(tree, i):
    """The block-``i`` view of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- #
# block apply
# --------------------------------------------------------------------- #
def apply_block(bp, x, res, cfg: ModelConfig, *, mode: str, cache=None,
                length=None):
    """One block. The residual stream arrives as ``x + res`` (``res`` None
    before the first block) and leaves the same way: returns (x, res)
    with the MLP output as the pending ``res``. mode: 'train' | 'prefill'
    | 'decode' | 'extend'; ``length`` is the valid count (prefill) or the
    per-row advance (extend). Cache writes go into ``cache`` in place."""
    eps = cfg.norm_eps
    for i in range(len(block_spec(cfg))):
        sp = bp[f"sub{i}"]
        h, x = L.rms_norm(sp["ln1"], x, eps, residual=res)
        c = None if cache is None else cache[f"sub{i}"]
        if mode == "train":
            y, _ = L.attention_block(sp["attn"], h, cfg)
        elif mode == "prefill":
            y, _ = L.prefill_into_cache(sp["attn"], h, cfg, c,
                                        length=length)
        elif mode == "extend":
            y, _ = L.extend_into_cache(sp["attn"], h, cfg, c,
                                       lengths=length)
        elif mode == "decode":
            y, _ = L.attention_block(sp["attn"], h, cfg, cache=c)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        h, x = L.rms_norm(sp["ln2"], y, eps, residual=x)
        res = L.mlp(sp["mlp"], h)
    return x, res


def _run_blocks(params, x, cfg: ModelConfig, *, mode: str, cache=None,
                length=None):
    res = None
    for i in range(n_blocks(cfg)):
        c = None if cache is None else _at(cache, i)
        x, res = apply_block(_at(params["blocks"], i), x, res, cfg,
                             mode=mode, cache=c, length=length)
    return x, res


# --------------------------------------------------------------------- #
# full forward passes
# --------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, tokens=None, embeddings=None):
    """tokens: (B, L) ids -> (B, L, d) in the activation dtype."""
    if embeddings is not None:
        raise NotImplementedError(
            "frontend embeddings are not ported yet: ROADMAP section 1, "
            "item 10 (VLM embedding chunk)")
    return L.embed(params["embed"], tokens).to(cfg.act_dtype)


def logits_from(params, cfg: ModelConfig, x, res=None):
    """Final norm (adding the pending ``res``) and the LM head; f32."""
    h, _ = L.rms_norm(params["ln_f"], x, cfg.norm_eps, residual=res)
    if cfg.tie_embeddings:
        out = L.unembed(params["embed"], h)
    else:
        out = L.linear(params["lm_head"], h)
    return out.float()


def forward_train(params, cfg: ModelConfig, tokens, embeddings=None):
    """Returns (logits, aux_loss)."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res = _run_blocks(params, x, cfg, mode="train")
    return logits_from(params, cfg, x, res), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def last_valid(x, length):
    """x: (B, L, ...); length: (B,) valid counts -> (B, 1, ...) at each
    row's last valid position (the last position if None)."""
    if length is None:
        return x[:, -1:]
    idx = torch.clamp(length.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def prefill(params, cfg: ModelConfig, tokens, cache, embeddings=None,
            length=None):
    """Populates ``cache`` in place; returns (last-valid logits, cache)."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res = _run_blocks(params, x, cfg, mode="prefill", cache=cache,
                         length=length)
    return logits_from(params, cfg, last_valid(x, length),
                       last_valid(res, length)), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) ids. Returns (logits (B, 1, V), cache)."""
    x = embed_inputs(params, cfg, token)
    x, res = _run_blocks(params, x, cfg, mode="decode", cache=cache)
    return logits_from(params, cfg, x, res), cache


def extend_step(params, cfg: ModelConfig, tokens, cache, lengths=None,
                last_only=False, embeddings=None):
    """Masked multi-token cached forward at per-row offsets. tokens: (B,
    T); row b consumes ``tokens[b, :lengths[b]]`` (None = all T). Returns
    (logits, cache): (B, T, V), or (B, 1, V) at each row's last valid
    position when ``last_only``."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res = _run_blocks(params, x, cfg, mode="extend", cache=cache,
                         length=lengths)
    if last_only:
        x, res = last_valid(x, lengths), last_valid(res, lengths)
    return logits_from(params, cfg, x, res), cache
