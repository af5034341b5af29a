"""Param-tree quantization (the port's copy of the JAX package's
``quant/params.py``): walk the nested-dict parameter tree and replace
each projection weight ``{"w": tensor}`` with a QTensor dict.

Eligibility is structural: every projection weight sits at key ``"w"``
in its own sub-dict, so q/k/v/o and the MLP projections (and an untied
LM head) are quantized, while norms, biases and the embedding table (a
lookup, and the tied LM head) stay in full precision. Stacked block
weights carry the leading block axis; quantization treats the last two
dims as ``(d_in, d_out)`` and broadcasts over the rest.

The deploy layer's ``Endpoint(quantize=)`` stores a stage's tree through
``quantize_params`` and runs it through ``dequantize_params``; the
speculative self-draft (``quant/self_draft.py``) quantizes its views of
the target's blocks through it. ``save_quantized`` / ``load_quantized``
write and read a quantized tree in the pytree file format
(``training/checkpoints.py``), tagged ``{"format": "qtensor"}`` in its
manifest as JAX tags it, so either package reads the other's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.quant.qtensor import (dequantize_tensor, is_qtensor,
                                       qtensor_nbytes, qtensor_shapes,
                                       quantize_tensor)

SKIP_KEYS = ("router",)
_BITS = {"int8": 8, "int4": 4}


def _eligible(val) -> bool:
    return isinstance(val, torch.Tensor) and val.is_floating_point() \
        and val.dim() >= 2


def _bits_for(d_in: int, bits: int) -> int:
    """int4 needs an even d_in; odd ones fall back to int8."""
    return bits if (bits == 8 or d_in % 2 == 0) else 8


def quantize_params(params, bits: int = 8, group_size: int = 32):
    """Replace every floating ``{"w": tensor}`` leaf outside the
    ``SKIP_KEYS`` sub-trees with a QTensor dict.

    ``bits``: 8 (per-channel) or 4 (group-wise packed; odd d_in leaves
    fall back to int8).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def walk(node):
        if not isinstance(node, dict) or is_qtensor(node):
            return node
        out = {}
        for k, v in node.items():
            if k in SKIP_KEYS:
                out[k] = v
            elif k == "w" and _eligible(v):
                out[k] = quantize_tensor(v, bits=_bits_for(v.shape[-2], bits),
                                         group_size=group_size)
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)


def dequantize_params(params, dtype=None):
    """Inverse walk: QTensor leaves -> dense tensors (f32 by default)."""
    def walk(node):
        if is_qtensor(node):
            return dequantize_tensor(node, dtype or torch.float32)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def quantize_for_cfg(params, cfg):
    """The single ``cfg.quant`` knob: '' -> identity, 'int8'/'int4' ->
    quantized tree with ``cfg.quant_group`` group size."""
    if not cfg.quant:
        return params
    return quantize_params(params, bits=_BITS[cfg.quant],
                           group_size=cfg.quant_group)


def quantized_shapes(shapes, cfg):
    """A parameter tree of shapes (``transformer.param_shapes``) as
    ``quantize_for_cfg`` leaves it: under ``cfg.quant`` every ``"w"``
    shape becomes {leaf: (shape, dtype)} of its QTensor; other leaves stay
    shapes."""
    if not cfg.quant:
        return shapes

    def walk(node):
        out = {}
        for k, v in node.items():
            if k in SKIP_KEYS:
                out[k] = v
            elif k == "w" and not isinstance(v, dict):
                out[k] = qtensor_shapes(v, _bits_for(v[-2], _BITS[cfg.quant]),
                                        cfg.quant_group)
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(shapes)


# --------------------------------------------------------------------- #
# save / load (the pytree files of training/checkpoints.py)
# --------------------------------------------------------------------- #
def save_quantized(path, qparams, extra: Optional[dict] = None) -> str:
    """QTensor trees are plain nested dicts, so the content-addressed
    pytree file holds them as they are; the manifest is tagged for
    tooling. Returns the content hash."""
    from repro_torch.training.checkpoints import save_pytree
    meta = {"format": "qtensor"}
    meta.update(extra or {})
    return save_pytree(path, qparams, extra=meta)


def load_quantized(path, verify: bool = True, device=None):
    """The quantized tree at ``path`` as tensors on ``device`` (CUDA
    unless the caller names another)."""
    from repro_torch.training.checkpoints import load_pytree
    return load_pytree(path, verify=verify, device=device)


# --------------------------------------------------------------------- #
# accounting
# --------------------------------------------------------------------- #
def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def quantized_stats(params) -> Dict[str, int]:
    """Bytes of the projection ("w") weights, dense or quantized, plus
    leaf counts and the whole-tree total."""
    stats = {"weight_bytes": 0, "n_quantized": 0, "n_dense": 0,
             "total_bytes": sum(t.numel() * t.element_size()
                                for t in _leaves(params))}

    def walk(node):
        if is_qtensor(node):
            stats["weight_bytes"] += qtensor_nbytes(node)
            stats["n_quantized"] += 1
            return
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "w" and isinstance(v, torch.Tensor):
                    stats["weight_bytes"] += v.numel() * v.element_size()
                    stats["n_dense"] += 1
                elif isinstance(v, dict):
                    walk(v)

    walk(params)
    return stats
