"""Configuration schema for the PyTorch port.

The port's own copy of the JAX package's ``configs/base.py``: a frozen
``ModelConfig`` per architecture and ``ShapeConfig`` for input shapes.
Dtypes are kept as names (``"bfloat16"``, ``"float32"``) so a config
reads the same in both packages; ``act_dtype`` / ``p_dtype`` resolve
them to ``torch`` dtypes. Only the fields the ported families read
are carried: the dense decoder's, the mixture-of-experts FFN's
(``MoEConfig``), the Mamba-2 mixer's (``SSMConfig``), the hybrid's
interleave (``attn_every``), the frontend stub's (``FrontendConfig``:
the VLM's patch embeddings, the encoder-decoder's audio frames) and the
encoder-decoder's encoder stack (``EncoderConfig``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    n_experts: int                  # routed experts
    top_k: int
    d_expert: int                   # hidden dim of each routed expert
    n_shared: int = 0               # always-on shared experts
    d_shared: int = 0               # hidden dim of the shared expert block
    capacity_factor: float = 1.25   # tokens-per-expert capacity multiplier
    router_jitter: float = 0.0
    moe_every: int = 1              # 1 = every layer is MoE; 2 = alternate
    aux_loss_weight: float = 0.01   # load-balance auxiliary loss
    group_routing: bool = False     # route within per-row token groups


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length (dual form)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an encoder-decoder model (the decoder's d_model);
    it reads the frontend's frame embeddings, with no embedding table of
    its own."""

    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: precomputed frame/patch embeddings of shape
    ``(batch, n_tokens, d_embed)`` that a learned linear projector maps to
    ``d_model``."""

    kind: str                       # "vision" | "audio"
    n_tokens: int                   # patches / frames per example
    d_embed: int                    # embedding dim produced by the stub


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm |
                                    # encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0         # 0 = full attention
    attn_block: int = 0             # >0: chunked causal attention in the
                                    # cache-free forward
    kv_quant: bool = False          # int8 KV cache (per slot-head scales)
    quant: str = ""                 # weight-only PTQ: "" | "int8" | "int4"
                                    # (the knob quantize_for_cfg and the
                                    # edge variant key off)
    quant_group: int = 32           # int4 group size along d_in
    prefill_chunk: int = 0          # engine chunked-admission default
    prefix_cache_tokens: int = 0    # shared-prefix KV reuse budget
    mesh: str = ""                  # serving mesh spec ("auto", "dp,mp";
                                    # launch.mesh.make_serving_mesh)
    draft: str = ""                 # speculative draft: a self-draft spec
                                    # "<prec>[@<blocks>]" (quant.self_draft,
                                    # e.g. "int8@1") or "ngram"
    spec_gamma: int = 0             # draft tokens proposed per spec step
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0             # hybrid: one attention sublayer per
                                    # this many (the super-block's size)
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "bfloat16"
    remat: bool = False             # activation checkpointing per block
                                    # in the train forward
    source: str = ""                # citation for the architecture

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 heads, fp32.
        The same rule as the JAX package, so both packages build the same
        shapes from one variant name; an attention-free config keeps no
        heads (head_dim 1, no FFN) and a smaller SSM (d_state 32,
        head_dim 32, chunk 32); a mixture of experts keeps at most 4
        experts, top-2, of 128 hidden units, and one shared expert of
        128; an encoder keeps 2 layers of the decoder's heads and an FFN
        of at most 512; a frontend keeps 16 tokens of 64 dims; a hybrid
        keeps one full super-block (``n_layers = attn_every``)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        if n_heads:
            n_kv = max(1, min(self.n_kv_heads, n_heads))
            while n_heads % n_kv:
                n_kv -= 1
        else:
            n_kv = 0                # attention-free (ssm)
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 1024),
            head_dim=(d_model // n_heads) if n_heads else 1,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                n_shared=min(self.moe.n_shared, 1),
                d_shared=min(self.moe.d_shared, 128),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=32,
                                            head_dim=32, chunk=32)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(
                n_layers=2, n_heads=n_heads, n_kv_heads=n_kv,
                d_ff=min(self.encoder.d_ff, 512))
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(self.frontend, n_tokens=16,
                                                 d_embed=64)
        if self.attn_every:
            kw["n_layers"] = self.attn_every    # one full super-block
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

