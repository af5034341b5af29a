"""Architecture registry: ``--arch <id>`` resolves through ``ARCHS``.

Only the architectures whose family the port can build are registered;
the JAX package's other ids raise ``NotImplementedError`` naming the
ROADMAP item that ports their family."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32

ARCHS = {c.name: c for c in [_llama32]}

#: architecture ids of the JAX package the port cannot build yet, with
#: the ROADMAP item (section 1) that brings their family over
NOT_PORTED = {
    "internlm2-20b": "item 10 of section 1 (other architectures)",
    "qwen2.5-14b": "item 10 of section 1 (other architectures)",
    "starcoder2-15b": "item 10 of section 1 (other architectures)",
    "qwen2-moe-a2.7b": "item 10 of section 1 (MoE family)",
    "granite-moe-3b-a800m": "item 10 of section 1 (MoE family)",
    "mamba2-780m": "item 10 of section 1 (SSM family)",
    "jamba-1.5-large-398b": "item 10 of section 1 (hybrid family)",
    "pixtral-12b": "item 10 of section 1 (VLM embedding chunk)",
    "seamless-m4t-medium": "item 10 of section 1 (encoder-decoder)",
    "mixtral-8x7b": "item 10 of section 1 (MoE family)",
    "gemma2-9b-class": "item 10 of section 1 (other architectures)",
}

#: variants of the JAX registry the port does not build yet
_VARIANT_ITEMS = {
    "edge": "item 8 of section 1 (int4 weights + int8 KV)",
    "spec": "item 9 of section 1 (speculative decoding)",
    "continuous": "item 6 of section 1 (prefix cache)",
    "sharded": "item 13 of section 1 (distribution)",
}


def get_arch(name: str, *, variant: str = "") -> ModelConfig:
    """Resolve an architecture id with optional "+"-composed variants
    (applied left to right): "reduced" (smoke config) and "swa"
    (sliding-window attention, window 4096)."""
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
        elif v in _VARIANT_ITEMS:
            raise NotImplementedError(
                f"variant {v!r} is not ported yet: ROADMAP "
                f"{_VARIANT_ITEMS[v]}")
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_arch"]
