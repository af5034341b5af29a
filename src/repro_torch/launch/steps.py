"""Step configuration for the launchers: the single-device part of the
JAX package's ``launch/steps.py``. ``resolve_config`` maps an (arch x
input shape) pair to the config a step at that shape runs (a
sliding-window variant for a dense ``long_500k`` decode, ``remat`` for a
train shape; ``ShapeSkip`` where the pair is out of the family's
envelope); ``depth_counts`` / ``with_depth`` read and set a stack's
depth in its scan units; ``apply_opts`` applies the optimization knobs.

``build_step`` and ``activation_rules_for`` shard a step over a device
mesh and wait for ROADMAP section 1, item 13c (with the dry-run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ModelConfig


class ShapeSkip(Exception):
    """This (arch x shape) pair is skipped by design."""


def resolve_config(arch: str, shape_name: str) -> ModelConfig:
    shape = SHAPES[shape_name]
    cfg = get_arch(arch)
    if shape_name == "long_500k":
        if cfg.family == "encdec":
            raise ShapeSkip("enc-dec speech decoder: 512k-token decode is "
                            "out of the model family's envelope")
        if cfg.family in ("dense", "vlm") and not cfg.sliding_window:
            # sub-quadratic requirement: the sliding-window variant
            cfg = get_arch(arch, variant="swa")
    if shape.mode == "train":
        cfg = cfg.replace(remat=True)
    return cfg


def depth_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Trip counts by scan unit: encoder and decoder layers of an
    encoder-decoder, else the stack's blocks."""
    from repro_torch.models.transformer import n_blocks
    if cfg.family == "encdec":
        return {"enc": cfg.encoder.n_layers, "dec": cfg.n_layers}
    return {"blocks": n_blocks(cfg)}


def with_depth(cfg: ModelConfig, counts: Dict[str, int]) -> ModelConfig:
    """``cfg`` with the depth ``counts`` gives (``depth_counts``' keys),
    each block keeping its sublayers."""
    from repro_torch.models.transformer import block_spec
    if cfg.family == "encdec":
        return cfg.replace(
            n_layers=counts["dec"],
            encoder=dataclasses.replace(cfg.encoder,
                                        n_layers=counts["enc"]))
    return cfg.replace(n_layers=counts["blocks"] * len(block_spec(cfg)))


def apply_opts(cfg: ModelConfig, opts: Dict[str, Any]) -> ModelConfig:
    """The optimization knobs beyond the paper-faithful baseline: MoE
    group routing, the SSD chunk, chunked causal attention, an int8 KV
    cache."""
    if opts.get("moe_group") and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  group_routing=True))
    if opts.get("ssd_chunk") and cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                  chunk=opts["ssd_chunk"]))
    if opts.get("attn_block"):
        cfg = cfg.replace(attn_block=opts["attn_block"])
    if opts.get("kv_quant"):
        cfg = cfg.replace(kv_quant=True)
    return cfg
