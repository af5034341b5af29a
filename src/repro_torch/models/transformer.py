"""The decoder stacks (dense GQA and the Mamba-2 SSM family):
parameters, the stacked cache and the layer loop behind every forward
mode.

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
or for ``ln_f``. That is 2 * n_layers + 1 norm calls per forward. An
SSM sublayer has no FFN: ``ln1`` adds and normalises, and the mixer's
output is the pending ``res`` (its gated norm is the second norm call of
the layer, so an SSM stack also makes 2 * n_layers + 1). In fp32 this is
the JAX stack's arithmetic; in bf16 each norm reads the f32 sum where
the JAX stack rounds ``x + y`` to bf16 first (see
``kernels/rmsnorm/ref.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


# --------------------------------------------------------------------- #
# block structure
# --------------------------------------------------------------------- #
def block_spec(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """[(mixer, ffn)] per sublayer of the scan unit."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", "mlp")]
    if cfg.family == "ssm":
        return [("ssm", None)]
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

    def sub(mixer, ffn):
        out = {"ln1": {"scale": (nb, d)}}
        if mixer == "attn":
            out["attn"] = {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
                           "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                           "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                           "wo": lin(cfg.n_heads * hd, d)}
        else:
            out["ssm"] = S.ssm_param_shapes(cfg, nb)
        if ffn == "mlp":
            out["ln2"] = {"scale": (nb, d)}
            out["mlp"] = {"wi": lin(d, cfg.d_ff), "wg": lin(d, cfg.d_ff),
                          "wo": lin(cfg.d_ff, d)}
        return out

    p = {"embed": {"table": (cfg.vocab, d)},
         "blocks": {f"sub{i}": sub(*ms)
                    for i, ms in enumerate(block_spec(cfg))},
         "ln_f": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": (d, cfg.vocab)}
    if cfg.frontend is not None:
        p["frontend_proj"] = {"w": (cfg.frontend.d_embed, d)}
    return p


def init_transformer(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    """Weights from a seed, made on ``device`` with a ``torch.Generator``:
    N(0, 0.02) projections and embeddings, unit norm scales, zero biases,
    and the SSM mixer's own leaves (``ssm.init_ssm_leaf``; the JAX
    package's scheme; the random numbers are not JAX's)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(path, shape):
        leaf = path[-1]
        if "ssm" in path:
            t = S.init_ssm_leaf(cfg, leaf, shape, gen, device)
            if t is not None:
                return t
        if leaf == "scale":
            return torch.ones(shape, dtype=cfg.p_dtype, device=device)
        if leaf == "b":
            return torch.zeros(shape, dtype=cfg.p_dtype, device=device)
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(0.02).to(cfg.p_dtype)   # in place: one f32 copy

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
    ring is ``min(cache_len, sliding_window)`` long under a window.
    ``cfg.kv_quant``: int8 K/V with per-(slot, head) f32 scales. An SSM
    mixer's sub-cache is ``ssm.make_ssm_cache`` (conv tail, f32 state,
    depth and their checkpoints), whatever ``cache_len`` is."""
    dtype = dtype or cfg.act_dtype
    S_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    nb = n_blocks(cfg)
    c = {}
    for i, (mixer, _) in enumerate(block_spec(cfg)):
        if mixer == "attn":
            one = L.make_kv_cache(batch, S_len, cfg.n_kv_heads, cfg.hd,
                                  dtype, device, quant=cfg.kv_quant)
        else:
            one = S.make_ssm_cache(batch, cfg, dtype, device)
        c[f"sub{i}"] = _stacked(one, nb)
    return c


def _stacked(one, nb):
    return {k: v[None].repeat((nb,) + (1,) * v.dim())
            for k, v in one.items()}


def make_paged_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                     page_size: int, num_pages: int, dtype=None,
                     device="cpu"):
    """Paged decode cache (``layers.make_paged_kv_cache``,
    ``serving/paged_kv.py``) with the same ``[n_blocks, ...]`` stacking
    as ``make_cache``: pool leaves ``kp``/``vp`` are ``[n_blocks,
    num_pages + 1, page_size, Hkv, hd]`` (the pool replaces the batch
    axis as the storage axis), ``bt``/``pos``/``step`` are ``[n_blocks,
    batch, ...]``. Attention-only stacks (SSM recurrent state has no
    paged analogue)."""
    if any(mixer != "attn" for mixer, _ in block_spec(cfg)):
        raise NotImplementedError(
            f"paged KV caches require attention-only stacks; family "
            f"{cfg.family!r} has SSM mixers")
    dtype = dtype or cfg.act_dtype
    S_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    nb = n_blocks(cfg)
    return {f"sub{i}": _stacked(L.make_paged_kv_cache(
                batch, S_len, cfg.n_kv_heads, cfg.hd, dtype, device,
                page_size=page_size, num_pages=num_pages,
                quant=cfg.kv_quant), nb)
            for i in range(len(block_spec(cfg)))}


def cache_steps(cache):
    """Per-slot sequence depth (B,) from the first sub-cache that tracks
    one (attention rings and SSM state both carry a per-row ``step``)."""
    for sub in cache.values():
        if isinstance(sub, dict) and "step" in sub:
            return sub["step"][0]
    return None


def set_cache_steps(cache, steps):
    """Per-row rollback to depth ``steps`` (B,), in place, family-aware.

    * Attention sub-caches: ``step`` is rewritten; ``pos`` entries beyond
      the new depth stay, hidden by causal masking until the decode step
      that overwrites their slot.
    * SSM sub-caches: recurrent state cannot be rewound by masking, so
      rows with ``steps < step`` restore the ``*_ckpt`` snapshot taken
      before the most recent advance (the caller targets that snapshot's
      depth); the checkpoints themselves stay.

    Rows whose ``steps`` equals their depth are untouched bit for bit."""
    steps = steps.to(torch.int32)
    for sub in cache.values():
        tgt = steps[None].expand_as(sub["step"])
        if "ssm" in sub:
            back = tgt < sub["step"]                      # (n_blocks, B)
            for key in ("conv", "ssm"):
                cur, ck = sub[key], sub[key + "_ckpt"]
                m = back.reshape(back.shape + (1,) * (cur.dim() - 2))
                cur.copy_(torch.where(m, ck, cur))
            sub["step"].copy_(torch.where(back, tgt, sub["step"]))
        else:
            sub["step"].copy_(tgt)
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
    with the MLP output (an SSM sublayer: the mixer output) as the
    pending ``res``. mode: 'train' | 'prefill'
    | 'decode' | 'extend'; ``length`` is the valid count (prefill) or the
    per-row advance (extend). Cache writes go into ``cache`` in place."""
    eps = cfg.norm_eps
    for i, (mixer, ffn) in enumerate(block_spec(cfg)):
        sp = bp[f"sub{i}"]
        h, x = L.rms_norm(sp["ln1"], x, eps, residual=res)
        c = None if cache is None else cache[f"sub{i}"]
        if mixer == "ssm":
            y = _ssm_mixer(sp["ssm"], h, cfg, mode, c, length)
        elif mode == "train":
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
        if ffn is None:
            res = y          # no FFN: the mixer output is the pending add
            continue
        h, x = L.rms_norm(sp["ln2"], y, eps, residual=x)
        res = L.mlp(sp["mlp"], h)
    return x, res


def _ssm_mixer(p, h, cfg: ModelConfig, mode: str, cache, length):
    """The SSM mixer in ``mode``; cached modes write into ``cache``."""
    if mode == "train":
        y, _ = S.ssm_block(p, h, cfg)
    elif mode == "prefill":
        y, nc = S.ssm_block(p, h, cfg, return_cache=True, length=length)
        for key in S.CACHE_KEYS:
            cache[key].copy_(nc[key])
    elif mode == "extend":
        y, _ = S.ssm_block(p, h, cfg, cache=cache, length=length,
                           mode="extend")
    elif mode == "decode":
        y, _ = S.ssm_block(p, h, cfg, cache=cache)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return y


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
    """tokens: (B, Lt) ids; embeddings: (B, Le, d_embed) frontend stub
    output (VLM patches), projected by ``frontend_proj`` and placed before
    the tokens. Returns (B, L, d) in the activation dtype."""
    parts = []
    if embeddings is not None:
        parts.append(L.linear(params["frontend_proj"], embeddings))
    if tokens is not None:
        parts.append(L.embed(params["embed"], tokens))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return x.to(cfg.act_dtype)


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
