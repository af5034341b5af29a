"""Parameters and caches between the JAX package and the port.

Both packages keep the same trees: nested dicts with the same keys, the
stacked ``[n_blocks, ...]`` block axis on parameters and ``[n_blocks,
batch, ...]`` on caches. A tree crosses as numpy arrays (``jax.tree.map
(np.asarray, tree)`` on the JAX side), leaf for leaf; dtypes are kept,
bf16 included, and cache positions and block tables stay int32. The
mapping is generic over the tree, so contiguous and paged caches cross
the same way, int8 KV caches (``k_scale``/``v_scale``,
``kp_scale``/``vp_scale`` leaves) included, and so does the
encoder-decoder's tree (``frontend_proj``, ``enc_layers``, ``enc_ln``,
``dec_layers``) and cache (its bare ``xk``/``xv`` memory beside the
``self`` ring). A quantized parameter tree (``quant.quantize_for_cfg``)
crosses as its QTensor leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import param_shapes
from repro_torch.models.transformer import is_f32_leaf
from repro_torch.quant.params import quantized_shapes

_NP_DTYPES = {torch.int8: np.int8, torch.float32: np.float32}


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
    Under ``cfg.quant`` the tree is the JAX package's ``quantize_for_cfg``
    of it: every projection weight a QTensor (``q`` (nb, K, N) or ``q4``
    (nb, K/2, N) int8, ``scale`` (nb, N) or (nb, K/gs, N) f32). Raises
    when a key or a shape differs from what ``cfg`` builds, or a leaf's
    dtype from ``cfg.param_dtype`` (float32 for an SSM mixer's
    ``A_log``/``D``/``dt_bias`` and a MoE router's ``w``, chosen by the
    leaf's path: ``transformer.is_f32_leaf``; the QTensor format's for a
    quantized leaf; the experts and the router stay unquantized, as the
    JAX package's ``quantize_params`` leaves them)."""
    device = resolve_device(device)
    want = quantized_shapes(param_shapes(cfg), cfg)

    def check(node, ref, path):
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(f"params{list(path)}: keys {got} != "
                                 f"{sorted(ref)}")
            for k in ref:
                check(node[k], ref[k], path + (k,))
            return
        if isinstance(ref[-1], torch.dtype):              # a QTensor leaf
            shape, want_dt = ref[0], np.dtype(_NP_DTYPES[ref[1]]).name
        else:
            shape = ref
            want_dt = "float32" if is_f32_leaf(path) else cfg.param_dtype
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"params{list(path)}: shape "
                             f"{np.shape(node)} != {shape}")
        if np.asarray(node).dtype.name != want_dt:
            raise ValueError(f"params{list(path)}: dtype "
                             f"{np.asarray(node).dtype} != {want_dt}")

    check(tree, want, ())
    return _map(tree, lambda a: _to_torch(a, device))


def params_to_numpy(params) -> Dict[str, Any]:
    return _map(params, _to_numpy)


def cache_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's stacked cache from a JAX cache tree of numpy arrays:
    contiguous (``k``, ``v``, ``pos`` int32, ``step`` int32 per
    sub-cache), paged (``kp``, ``vp``, ``bt`` int32, ``pos``, ``step``)
    or an SSM mixer's (``conv``, ``ssm`` f32, ``step`` int32 and their
    ``*_ckpt`` copies). Leaves may be read-only or broadcast views (a JAX engine's
    pushed block tables are ``np.broadcast_to`` views): each is copied
    into a tensor of its own."""
    device = resolve_device(device)
    return _map(tree, lambda a: _to_torch(a, device))


def cache_to_numpy(cache) -> Dict[str, Any]:
    return _map(cache, _to_numpy)
