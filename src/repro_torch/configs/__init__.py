"""Architecture registry: ``--arch <id>`` resolves through ``ARCHS``.

Only the architectures whose family the port can build are registered;
the JAX package's other ids raise ``NotImplementedError`` naming the
ROADMAP item that ports their family."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral

ARCHS = {c.name: c for c in [_llama32, _mamba2, _pixtral]}

#: architecture ids of the JAX package the port cannot build yet, with
#: the ROADMAP item (section 1) that brings their family over
NOT_PORTED = {
    "internlm2-20b": "item 10 of section 1 (other architectures)",
    "qwen2.5-14b": "item 10 of section 1 (other architectures)",
    "starcoder2-15b": "item 10 of section 1 (other architectures)",
    "qwen2-moe-a2.7b": "item 10 of section 1 (MoE family)",
    "granite-moe-3b-a800m": "item 10 of section 1 (MoE family)",
    "jamba-1.5-large-398b": "item 10 of section 1 (hybrid family)",
    "seamless-m4t-medium": "item 10 of section 1 (encoder-decoder)",
    "mixtral-8x7b": "item 10 of section 1 (MoE family)",
    "gemma2-9b-class": "item 10 of section 1 (other architectures)",
}

#: variants of the JAX registry the port does not build yet
_VARIANT_ITEMS = {
    "sharded": "item 13 of section 1 (distribution)",
}


def get_arch(name: str, *, variant: str = "") -> ModelConfig:
    """Resolve an architecture id with optional "+"-composed variants
    (applied left to right): "reduced" (smoke config), "swa"
    (sliding-window attention, window 4096), "edge" (the edge
    deployment profile: int4 weight-only quantization and an int8 KV
    cache), "continuous" (chunked admission, 64 tokens a chunk unless
    the config sets one, and an 8192-token shared-prefix KV budget unless
    it sets one) and "spec" (speculative decoding: an int8 self-draft of
    half the target's blocks at gamma 4), e.g. "reduced+edge",
    "reduced+continuous" or "reduced+spec"."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet: ROADMAP {NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    for v in filter(None, variant.split("+")):
        if v == "swa":
            cfg = cfg.replace(name=cfg.name + "-swa", sliding_window=4096)
        elif v == "reduced":
            cfg = cfg.reduced()
        elif v == "edge":
            cfg = cfg.replace(name=cfg.name + "-edge", quant="int4",
                              kv_quant=True)
        elif v == "continuous":
            cfg = cfg.replace(name=cfg.name + "-cont",
                              prefill_chunk=cfg.prefill_chunk or 64,
                              prefix_cache_tokens=cfg.prefix_cache_tokens
                              or 8192)
        elif v == "spec":
            # half-depth int8 self-draft: weight-sharing, no second
            # checkpoint (the edge deployment's speculative profile)
            from repro_torch.models.transformer import n_blocks
            nb = max(1, n_blocks(cfg) // 2)
            cfg = cfg.replace(name=cfg.name + "-spec",
                              draft=f"int8@{nb}", spec_gamma=4)
        elif v in _VARIANT_ITEMS:
            raise NotImplementedError(
                f"variant {v!r} is not ported yet: ROADMAP "
                f"{_VARIANT_ITEMS[v]}")
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_arch"]
