"""Parameters and caches between the JAX package and the port.

Both packages keep the same trees: nested dicts with the same keys, the
stacked ``[n_blocks, ...]`` block axis on parameters and ``[n_blocks,
batch, ...]`` on caches. A tree crosses as numpy arrays (``jax.tree.map
(np.asarray, tree)`` on the JAX side), leaf for leaf; dtypes are kept,
bf16 included, and cache positions stay int32.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.transformer import param_shapes


def _map(tree, fn: Callable):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree of numpy arrays.
    Raises when a key or a shape differs from what ``cfg`` builds."""
    device = resolve_device(device)
    want = param_shapes(cfg)

    def check(node, ref, path):
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(f"params{list(path)}: keys {got} != "
                                 f"{sorted(ref)}")
            for k in ref:
                check(node[k], ref[k], path + (k,))
        elif tuple(np.shape(node)) != tuple(ref):
            raise ValueError(f"params{list(path)}: shape "
                             f"{np.shape(node)} != {ref}")

    check(tree, want, ())
    return _map(tree, lambda a: _to_torch(a, device))


def params_to_numpy(params) -> Dict[str, Any]:
    return _map(params, _to_numpy)


def cache_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's stacked cache from a JAX cache tree of numpy arrays
    (``k``, ``v``, ``pos`` int32, ``step`` int32 per sub-cache)."""
    device = resolve_device(device)
    return _map(tree, lambda a: _to_torch(a, device))


def cache_to_numpy(cache) -> Dict[str, Any]:
    return _map(cache, _to_numpy)
