"""Architecture registry: ``--arch <id>`` resolves through ``ARCHS``,
and the two stretch ids of ``extra.py`` through ``get_arch`` alone, as
in the JAX package."""
from repro_torch.configs.base import (SHAPES, EncoderConfig,
                                      FrontendConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig)
from repro_torch.configs.extra import EXTRA_ARCHS
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2

ARCHS = {c.name: c for c in [
    _internlm2, _seamless, _starcoder2, _qwen25, _qwen2moe, _pixtral,
    _llama32, _granite, _mamba2, _jamba,
]}


def get_arch(name: str, *, variant: str = "") -> ModelConfig:
    """Resolve an architecture id with optional "+"-composed variants
    (applied left to right): "reduced" (smoke config), "swa"
    (sliding-window attention, window 4096), "edge" (the edge
    deployment profile: int4 weight-only quantization and an int8 KV
    cache), "sharded" (serving on the mesh ``"auto"`` gives: every rank
    of the process group on the model axis), "continuous" (chunked
    admission, 64 tokens a chunk unless the config sets one, and an
    8192-token shared-prefix KV budget unless it sets one) and "spec" (speculative decoding: an int8 self-draft of
    half the target's blocks at gamma 4), e.g. "reduced+edge",
    "reduced+continuous" or "reduced+spec"."""
    cfg = ARCHS.get(name) or EXTRA_ARCHS.get(name)
    if cfg is None:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ARCHS)} and {sorted(EXTRA_ARCHS)}")
    for v in filter(None, variant.split("+")):
        if v == "swa":
            cfg = cfg.replace(name=cfg.name + "-swa", sliding_window=4096)
        elif v == "reduced":
            cfg = cfg.reduced()
        elif v == "edge":
            cfg = cfg.replace(name=cfg.name + "-edge", quant="int4",
                              kv_quant=True)
        elif v == "sharded":
            cfg = cfg.replace(name=cfg.name + "-sharded", mesh="auto")
        elif v == "continuous":
            cfg = cfg.replace(name=cfg.name + "-cont",
                              prefill_chunk=cfg.prefill_chunk or 64,
                              prefix_cache_tokens=cfg.prefix_cache_tokens
                              or 8192)
        elif v == "spec":
            # half-depth int8 self-draft: weight-sharing, no second
            # checkpoint (the edge deployment's speculative profile). An
            # encoder-decoder has no self-draft (the draft would need its
            # own cross-attention memory): it raises, as in JAX
            if cfg.family == "encdec":
                raise ValueError(
                    f"variant 'spec' takes a decoder-only stack; "
                    f"{cfg.name!r} is an encoder-decoder (serve it with "
                    f"draft='ngram')")
            from repro_torch.models.transformer import n_blocks
            nb = max(1, n_blocks(cfg) // 2)
            cfg = cfg.replace(name=cfg.name + "-spec",
                              draft=f"int8@{nb}", spec_gamma=4)
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


__all__ = ["ARCHS", "EXTRA_ARCHS", "SHAPES", "EncoderConfig",
           "FrontendConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "get_arch"]
