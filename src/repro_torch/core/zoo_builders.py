"""Builders that wrap the port's models as zoo services (the port's copy
of the JAX package's ``core/zoo_builders.py``, same builder names,
configs and signatures, so a zoo published by one package is pulled by
the other).

These are the analogues of the paper's deployment example: ``image
classifier (InceptionV3) >> label decoder`` becomes ``embedding
classifier (assigned-arch backbone) >> label decoder``. Importing this
module registers the builders with the registry.

Both model services run the cache-free forward: on the card every
self-attention goes through the flash-attention kernel and every norm
through the fused add + RMSNorm kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig, get_arch
from repro_torch.core.registry import register_builder
from repro_torch.core.service import Service, Signature, TensorSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@register_builder("model.lm")
def lm_service(arch: str, variant: str = "", batch: int = -1,
               seq: int = -1) -> Service:
    """Next-token-logits service: {'tokens'} -> logits (B, L, V)."""
    return lm_service_for(get_arch(arch, variant=variant), arch=arch,
                          variant=variant, batch=batch, seq=seq)


def lm_service_for(cfg: ModelConfig, *, arch: str, variant: str = "",
                   batch: int = -1, seq: int = -1) -> Service:
    """``lm_service`` over a given config (a depth-cut model, say)."""
    def fn(params, inputs):
        logits, _ = T.forward_train(params, cfg, inputs["tokens"])
        return logits

    sig = Signature({"tokens": TensorSpec((batch, seq), "int32")},
                    TensorSpec((batch, seq, cfg.vocab), "float32"))
    return Service(name=f"lm_{arch}", fn=fn, signature=sig,
                   description=f"next-token logits for {arch}",
                   metadata={"arch": arch, "variant": variant,
                             "builder": "model.lm"})


@register_builder("model.classifier")
def classifier_service(arch: str, n_classes: int, variant: str = "reduced",
                       n_tokens: Optional[int] = None,
                       d_embed: Optional[int] = None) -> Service:
    """Embedding classifier (the InceptionV3 analogue): consumes frontend
    patch/frame embeddings, mean-pools the backbone output, projects to
    class logits. ``init_params(seed, device)`` hangs off the service
    metadata (weights from a ``torch.Generator``, not JAX's numbers)."""
    return classifier_service_for(get_arch(arch, variant=variant),
                                  n_classes, arch=arch, variant=variant,
                                  n_tokens=n_tokens, d_embed=d_embed)


def classifier_service_for(cfg: ModelConfig, n_classes: int, *, arch: str,
                           variant: str = "",
                           n_tokens: Optional[int] = None,
                           d_embed: Optional[int] = None) -> Service:
    """``classifier_service`` over a given config (a depth-cut model,
    say)."""
    assert cfg.frontend is not None, f"{arch} has no frontend stub"
    n_tokens = n_tokens or cfg.frontend.n_tokens
    d_embed = d_embed or cfg.frontend.d_embed

    def fn(params, inputs):
        bp = params["backbone"]
        x = T.embed_inputs(bp, cfg, embeddings=inputs["embeddings"])
        x, res, _ = T._run_blocks(bp, x, cfg, mode="train")
        # the last block's output is still pending: the final norm adds it
        h, _ = L.rms_norm(bp["ln_f"], x, cfg.norm_eps, residual=res)
        pooled = h.float().mean(dim=1)
        return L.linear(params["head"], pooled)

    def init_params(seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        w = torch.randn((cfg.d_model, n_classes), generator=gen,
                        dtype=torch.float32, device=device).mul_(0.02)
        return {"backbone": T.init_transformer(cfg, seed, device),
                "head": {"w": w}}

    sig = Signature(
        {"embeddings": TensorSpec((-1, n_tokens, d_embed), cfg.dtype)},
        TensorSpec((-1, n_classes), "float32"))
    return Service(name=f"classify_{arch}", fn=fn, signature=sig,
                   description=f"{arch} backbone patch-embedding classifier "
                               f"({n_classes} classes)",
                   metadata={"arch": arch, "variant": variant,
                             "n_classes": n_classes,
                             "init_params": init_params,
                             "builder": "model.classifier"})


@register_builder("adapter.label_decoder")
def label_decoder(n_classes: int) -> Service:
    """The paper's 'decoding service for ImageNet': class vector ->
    {class_id, confidence} in human-consumable form."""
    def fn(_params, logits):
        probs = torch.softmax(logits, dim=-1)
        return {"class_id": probs.argmax(dim=-1).to(torch.int32),
                "confidence": probs.amax(dim=-1)}

    sig = Signature(
        TensorSpec((-1, n_classes), "float32"),
        {"class_id": TensorSpec((-1,), "int32"),
         "confidence": TensorSpec((-1,), "float32")})
    return Service(name="label_decoder", fn=fn, signature=sig,
                   description="argmax + confidence label decoding",
                   metadata={"builder": "adapter.label_decoder"})


@register_builder("adapter.topk_decoder")
def topk_decoder(n_classes: int, k: int = 5) -> Service:
    def fn(_params, logits):
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.topk(probs, k, dim=-1)
        return {"class_ids": idx.to(torch.int32), "confidences": vals}

    sig = Signature(
        TensorSpec((-1, n_classes), "float32"),
        {"class_ids": TensorSpec((-1, k), "int32"),
         "confidences": TensorSpec((-1, k), "float32")})
    return Service(name=f"top{k}_decoder", fn=fn, signature=sig,
                   metadata={"builder": "adapter.topk_decoder"})
