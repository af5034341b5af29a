"""The decoder stacks of every family the port builds (dense GQA, MoE,
the Mamba-2 SSM stack, the attention + SSM + MoE hybrid and the VLM's
decoder; the encoder-decoder's stack is ``models/encdec.py``):
parameters, the stacked cache and the layer loop behind every forward
mode.

Parameters and caches keep the JAX package's tree layout: block leaves
carry the stacked block axis first (``[n_blocks, ...]``), cache leaves
``[n_blocks, batch, ...]`` with a per-row ``step``, so slots at
different depths share one batched cache. A block is the scan unit:
one sublayer for homogeneous stacks, a super-block (Jamba's one
attention and seven SSM sublayers, MoE on the even ones) for a hybrid.
The layer loop takes the per-block views ``leaf[i]``; cache writes land
in the stacked tensors.

Every norm of the stack goes through the fused add + RMSNorm op, with
the add of the residual stream folded in: a block receives the stream
as ``x + res`` (``res`` is the previous sublayer's output, still to be
added; None before the first block), ``ln1`` adds and normalises in one
call, the mixer's output is added in the same call that computes
``ln2``, and the FFN's output (MLP or MoE) is left pending for the next
sublayer's ``ln1`` or for ``ln_f``. A pure SSM sublayer has no FFN:
``ln1`` adds and normalises, and the mixer's output is the pending
``res``. Each SSM mixer adds one gated norm. So a dense or MoE stack
makes 2 * n_layers + 1 norm calls a forward, a pure SSM stack 2 *
n_layers + 1 (``ln1`` and the gated norm), and a hybrid 2 * n_layers +
n_ssm + 1: 23 a Jamba super-block (8 ``ln1``, 8 ``ln2``, 7 gated) and
``ln_f``. In fp32 this is the JAX stack's arithmetic; in bf16 each norm
reads the f32 sum where the JAX stack rounds ``x + y`` to bf16 first
(see ``kernels/rmsnorm/ref.py``).

On a serving mesh (``distribution.sharding.use_mesh``) the same loop runs
rank-local: the layers issue the collectives (``models/layers.py``), the
logits are whole on every rank of a model group (the vocab blocks
gathered), and a MoE FFN routes over the rank's experts
(``models/moe.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


# --------------------------------------------------------------------- #
# block structure
# --------------------------------------------------------------------- #
def block_spec(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """[(mixer, ffn)] per sublayer of the scan unit."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", "mlp")]
    if cfg.family == "moe":
        return [("attn", "moe")]
    if cfg.family == "ssm":
        return [("ssm", None)]
    if cfg.family == "hybrid":
        every = max(1, cfg.moe.moe_every) if cfg.moe else 0
        return [("attn" if i == 0 else "ssm",
                 "moe" if (cfg.moe and i % every == 0) else "mlp")
                for i in range(cfg.attn_every)]
    raise ValueError(f"unknown family {cfg.family!r}")


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
        if ffn is not None:
            out["ln2"] = {"scale": (nb, d)}
        if ffn == "mlp":
            out["mlp"] = mlp(cfg.d_ff)
        elif ffn == "moe":
            m = cfg.moe
            E, f = m.n_experts, m.d_expert
            out["moe"] = {"router": {"w": (nb, d, E)},
                          "wi": (nb, E, d, f), "wg": (nb, E, d, f),
                          "wo": (nb, E, f, d)}
            if m.n_shared:
                out["moe"]["shared"] = mlp(m.d_shared
                                           or m.n_shared * m.d_expert)
        return out

    def mlp(d_ff):
        return {"wi": lin(d, d_ff), "wg": lin(d, d_ff), "wo": lin(d_ff, d)}

    p = {"embed": {"table": (cfg.vocab, d)},
         "blocks": {f"sub{i}": sub(*ms)
                    for i, ms in enumerate(block_spec(cfg))},
         "ln_f": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": (d, cfg.vocab)}
    if cfg.frontend is not None:
        p["frontend_proj"] = {"w": (cfg.frontend.d_embed, d)}
    return p


def init_transformer(cfg: ModelConfig, seed: int, device,
                     shapes=None) -> Dict[str, Any]:
    """Weights from a seed, made on ``device`` with a ``torch.Generator``:
    N(0, 0.02) projections, experts and embeddings (the MoE router in
    f32), unit norm scales, zero biases, and the SSM mixer's own leaves
    (``ssm.init_ssm_leaf``; the JAX package's scheme; the random numbers
    are not JAX's). ``shapes`` is the tree to fill (``param_shapes(cfg)``
    by default; the encoder-decoder passes ``encdec.param_shapes``)."""
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
        w.mul_(0.02)                          # in place: one f32 copy
        return w if is_f32_leaf(path) else w.to(cfg.p_dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return make(path, node)

    return walk(param_shapes(cfg) if shapes is None else shapes, ())


def is_f32_leaf(path) -> bool:
    """Leaves kept in float32 in every parameter dtype: an SSM mixer's
    ``A_log``/``D``/``dt_bias`` and a MoE router's weight, by their path
    in the tree (the router's leaf is named ``w`` like every projection
    weight, so the name alone does not say)."""
    return path[-1] in S.F32_LEAVES and "ssm" in path \
        or tuple(path[-2:]) == ("router", "w")


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
    one (attention rings and SSM state both carry a per-row ``step``;
    the encoder-decoder's ``self`` ring)."""
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

    * The encoder-decoder's cross-attention memory (bare ``xk``/``xv``
      tensors beside its ``self`` ring) has no depth: it passes through.

    Rows whose ``steps`` equals their depth are untouched bit for bit."""
    steps = steps.to(torch.int32)
    for sub in cache.values():
        if not isinstance(sub, dict):
            continue
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
    before the first block) and leaves the same way: returns (x, res,
    aux) with the FFN output (a pure SSM sublayer: the mixer output) as
    the pending ``res`` and the block's MoE load-balance loss (0.0 for a
    block without MoE, so a dense stack launches nothing for it). mode:
    'train' | 'prefill' | 'decode' | 'extend'; ``length`` is the valid
    count (prefill) or the per-row advance (extend). MoE FFNs route
    densely (per token, capacity-free) in the cached modes, decode and
    extend, as in JAX (``moe.moe_block``). Cache writes go into
    ``cache`` in place."""
    eps = cfg.norm_eps
    aux = 0.0            # a tensor once an MoE FFN adds its loss
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
        if ffn == "mlp":
            res = L.mlp(sp["mlp"], h, cfg.d_ff)
        else:
            res, a = M.moe_block(sp["moe"], h, cfg,
                                 dense=mode in ("decode", "extend"))
            aux = aux + a
    return x, res, aux


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


def _unbind(tree):
    """The per-block views of a stacked tree, one ``unbind`` a leaf: in a
    backward pass the blocks' gradients of a leaf come back as one
    stack, where ``leaf[i]`` views would each give a full-size zero
    gradient to sum."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _train_block(bp, x, res, cfg):
    return apply_block(bp, x, res, cfg, mode="train")


def _run_blocks(params, x, cfg: ModelConfig, *, mode: str, cache=None,
                length=None):
    """The stack: returns (x, res, aux), the stream, its pending add and
    the summed MoE load-balance loss (0.0 without MoE). In the train
    forward, with ``cfg.remat`` and a gradient to ask for, each block
    runs under ``torch.utils.checkpoint`` (non-reentrant; the JAX
    package's ``jax.checkpoint`` of the block): its activations are
    dropped after the forward and recomputed, through the same kernels,
    in the backward."""
    res, aux = None, 0.0
    if mode == "train":
        remat = cfg.remat and torch.is_grad_enabled()
        for bp in _unbind(params["blocks"]):
            if remat:
                x, res, a = checkpoint(_train_block, bp, x, res, cfg,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                x, res, a = _train_block(bp, x, res, cfg)
            aux = aux + a
        return x, res, aux
    for i in range(n_blocks(cfg)):
        c = None if cache is None else _at(cache, i)
        x, res, a = apply_block(_at(params["blocks"], i), x, res, cfg,
                                mode=mode, cache=c, length=length)
        aux = aux + a
    return x, res, aux


# --------------------------------------------------------------------- #
# full forward passes
# --------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, tokens=None, embeddings=None):
    """tokens: (B, Lt) ids; embeddings: (B, Le, d_embed) frontend stub
    output (VLM patches), projected by ``frontend_proj`` and placed before
    the tokens. Returns (B, L, d) in the activation dtype."""
    parts = []
    if embeddings is not None:
        parts.append(L.project(params["frontend_proj"], embeddings))
    if tokens is not None:
        parts.append(L.embed(params["embed"], tokens, cfg.vocab))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return x.to(cfg.act_dtype)


def logits_from(params, cfg: ModelConfig, x, res=None):
    """Final norm (adding the pending ``res``) and the LM head; f32."""
    h, _ = L.rms_norm(params["ln_f"], x, cfg.norm_eps, residual=res)
    if cfg.tie_embeddings:
        out = L.unembed(params["embed"], h, cfg.vocab)
    else:
        out = L.col_linear(params["lm_head"], h, cfg.vocab, gather=True)
    return out.float()


def forward_train(params, cfg: ModelConfig, tokens, embeddings=None):
    """Returns (logits, aux_loss)."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res, aux = _run_blocks(params, x, cfg, mode="train")
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_from(params, cfg, x, res), aux


def prefill(params, cfg: ModelConfig, tokens, cache, embeddings=None,
            length=None):
    """Populates ``cache`` in place; returns (last-valid logits, cache)."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res, _ = _run_blocks(params, x, cfg, mode="prefill", cache=cache,
                            length=length)
    return logits_from(params, cfg, L.last_valid(x, length),
                       L.last_valid(res, length)), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) ids. Returns (logits (B, 1, V), cache)."""
    x = embed_inputs(params, cfg, token)
    x, res, _ = _run_blocks(params, x, cfg, mode="decode", cache=cache)
    return logits_from(params, cfg, x, res), cache


def extend_step(params, cfg: ModelConfig, tokens, cache, lengths=None,
                last_only=False, embeddings=None):
    """Masked multi-token cached forward at per-row offsets. tokens: (B,
    T); row b consumes ``tokens[b, :lengths[b]]`` (None = all T). Returns
    (logits, cache): (B, T, V), or (B, 1, V) at each row's last valid
    position when ``last_only``."""
    x = embed_inputs(params, cfg, tokens, embeddings)
    x, res, _ = _run_blocks(params, x, cfg, mode="extend", cache=cache,
                            length=lengths)
    if last_only:
        x, res = L.last_valid(x, lengths), L.last_valid(res, lengths)
    return logits_from(params, cfg, x, res), cache
