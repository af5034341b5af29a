"""Sharding rules: the port of the JAX package's
``distribution/sharding.py``, as pure functions over shapes.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names, or None (replicated), where JAX has a ``PartitionSpec``. The
functions take a port ``Mesh`` (``launch/mesh.py``; only its
``axis_names`` and ``shape`` are read, so a mesh that is a shape alone
serves) and give, leaf for leaf, the specs JAX's give for the same tree:
``param_shapes`` by path rules (``param_shardings``, ``spec_for_path``;
a quantized tree's QTensor leaves follow their weight's rule),
``cache_shardings`` by cache key, ``batch_shardings`` on the leading
dim, ``add_zero_sharding`` for ZeRO-style leaves. A dim that does not
divide its axis is replicated (``_fit_spec``).

``local_shape`` is a leaf's shape on one rank and ``shard`` cuts that
rank's block out of a whole tensor, a view where it can be.

JAX's ``activation_sharding`` / ``shard_activation`` have no
counterpart: nothing partitions for the port. Its rank-local layers
(``models/layers.py``, ``models/moe.py``) keep activations in the
layout ``default_activation_rules`` names, with the model axis split
only between a column-parallel projection and the row-parallel one that
reduces after it, and issue the collectives themselves through the
mesh made current by :func:`use_mesh` (the engine enters it around its
step programs): ``current_mesh()`` is None outside, where every layer
runs as on one device.
"""
from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Any, Optional, Tuple

import numpy as np
import torch

_ctx = threading.local()


# --------------------------------------------------------------------- #
# the current mesh
# --------------------------------------------------------------------- #
@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current in this thread for the block (None: no mesh,
    every layer runs as on one device)."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def current_mesh():
    return getattr(_ctx, "mesh", None)


def model_axis_size(axis: str = "model") -> int:
    """Size of ``axis`` in the current mesh (1 when none is current or it
    has no such axis)."""
    mesh = current_mesh()
    return 1 if mesh is None else int(mesh.sizes.get(axis, 1))


# --------------------------------------------------------------------- #
# activation rules
# --------------------------------------------------------------------- #
def default_activation_rules(batch_axes=("data",), model_axis="model",
                             seq_axis=None):
    b = tuple(batch_axes)
    batch = b if len(b) > 1 else b[0]
    return {
        # (B, L, D)
        "act_btd": (batch, seq_axis, None),
        # (B, L, H, hd)
        "act_heads": (batch, seq_axis, model_axis, None),
        # (B, L, V)
        "logits": (batch, seq_axis, model_axis),
        # MoE dispatch (E, C, d)
        "moe_expert": (model_axis, None, None),
        # grouped MoE dispatch (G, E, C, d)
        "moe_expert_grouped": (batch, model_axis, None, None),
        # KV cache (B, S, Hkv, hd)
        "kv_cache": (batch, seq_axis, model_axis, None),
        # SSM state (B, nh, p, n)
        "ssm_state": (batch, model_axis, None, None),
    }


# --------------------------------------------------------------------- #
# parameter rules (path pattern -> spec)
# --------------------------------------------------------------------- #
# Patterns match '/'-joined tree paths, first match wins. A rule's value
# is a spec or a LIST of candidate specs: the first whose sharded dims
# all divide evenly is used (expert-parallel MoE falls back to
# tensor-parallel experts when E % mesh_model != 0).
def default_param_rules(model_axis="model", zero_axis=None):
    m = model_axis
    return [
        # embeddings / unembedding: shard vocab
        (r".*embed.*/table", (m, None)),
        (r".*lm_head/w", (None, m)),
        # attention
        (r".*attn.*/wq/w", (None, m)),
        (r".*attn.*/wk/w", (None, m)),
        (r".*attn.*/wv/w", (None, m)),
        (r".*attn.*/wo/w", (m, None)),
        (r".*attn.*/w[qkv]/b", (m,)),
        # dense MLP: d_ff on model
        (r".*mlp/wi/w", (None, m)),
        (r".*mlp/wg/w", (None, m)),
        (r".*mlp/wo/w", (m, None)),
        # MoE: experts on model (expert parallelism); d_expert on model
        # when E does not divide the axis
        (r".*moe/router/w", (None, None)),
        (r".*moe/w[ig]$", [(m, None, None), (None, None, m)]),
        (r".*moe/wo$", [(m, None, None), (None, m, None)]),
        (r".*moe/shared/wi/w", (None, m)),
        (r".*moe/shared/wg/w", (None, m)),
        (r".*moe/shared/wo/w", (m, None)),
        # SSM: inner dim on model; the input dim when the packed
        # projection width does not divide
        (r".*ssm/in_proj/w", [(None, m), (m, None)]),
        (r".*ssm/out_proj/w", (m, None)),
        (r".*ssm/conv_w", (m, None)),
        (r".*ssm/conv_b", (m,)),
        (r".*ssm/norm/scale", (m,)),
        # frontend projector
        (r".*frontend_proj/w", (None, m)),
        # norms and scalars: replicated
        (r".*", None),
    ]


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _axis_size(ax, axis_sizes) -> int:
    return int(np.prod([axis_sizes[a] for a in
                        (ax if isinstance(ax, tuple) else (ax,))]))


def _fit_spec(spec, shape, axis_sizes):
    """Pad a spec to rank; returns (fixed_spec, fully_ok). Sharded dims
    that do not divide are replicated (fully_ok False, so candidates can
    fall through)."""
    if spec is None:
        return (None,) * len(shape), True
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    elif len(spec) > len(shape):
        return (None,) * len(shape), False
    fixed, ok = [], True
    for dim, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
        elif shape[dim] % _axis_size(ax, axis_sizes) == 0:
            fixed.append(ax)
        else:
            fixed.append(None)
            ok = False
    return tuple(fixed), ok


def _sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for_path(path_str: str, shape, rules, axis_sizes) -> Tuple:
    qspec = _qtensor_spec(path_str, shape, rules, axis_sizes)
    if qspec is not None:
        return qspec
    for pat, spec in rules:
        if re.fullmatch(pat, path_str):
            candidates = spec if isinstance(spec, list) else [spec]
            fallback = None
            for cand in candidates:
                fixed, ok = _fit_spec(cand, shape, axis_sizes)
                if ok:
                    return fixed
                if fallback is None:
                    fallback = fixed
            return fallback
    return ()


def _qtensor_spec(path_str: str, shape, rules, axis_sizes
                  ) -> Optional[Tuple]:
    """Spec of a QTensor leaf (``.../w/q``, ``.../w/q4``, ``.../w/scale``):
    ``q``/``q4`` keep the weight's own rule (divisibility re-checked on
    the leaf's shape: ``q4`` halves K); ``scale`` shards its last dim iff
    the weight's rule shards the output dim, and replicates the rest.
    None for any other leaf."""
    head, _, last = path_str.rpartition("/")
    if not head.endswith("/w"):
        return None
    if last in ("q", "q4"):
        return spec_for_path(head, shape, rules, axis_sizes)
    if last == "scale":
        for pat, spec in rules:
            if re.fullmatch(pat, head):
                cand = (spec[0] if isinstance(spec, list) else spec)
                out_ax = cand[-1] if cand else None
                fixed, _ = _fit_spec((None,) * (len(shape) - 1) + (out_ax,),
                                     shape, axis_sizes)
                return fixed
        return ()
    return None


# --------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------- #
def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (a leaf: a tensor,
    or a shape tuple)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params_tree, mesh, rules=None):
    """The spec of every leaf of a param tree (tensors or shapes) by the
    path rules. Dims that do not divide their axis are replicated;
    QTensor leaves follow their weight's rule, so a quantized model
    shards as its full-precision parent does."""
    rules = rules or default_param_rules()
    axis_sizes = _sizes(mesh)
    return map_with_path(
        lambda path, leaf: spec_for_path(_path_str(path), _shape(leaf),
                                         rules, axis_sizes), params_tree)


def add_zero_sharding(specs_tree, shapes_tree, mesh, zero_axes=("data",)):
    """ZeRO-style: additionally shard each leaf's largest still-replicated
    dim over ``zero_axes``."""
    axis_sizes = _sizes(mesh)
    z = int(np.prod([axis_sizes[a] for a in zero_axes]))
    zax = zero_axes if len(zero_axes) > 1 else zero_axes[0]

    def one(spec, leaf):
        shape = _shape(leaf)
        spec = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = None, 0
        for dim in range(len(shape)):
            if spec[dim] is None and shape[dim] % z == 0 \
                    and shape[dim] > best_size:
                best, best_size = dim, shape[dim]
        if best is not None:
            spec[best] = zax
        return tuple(spec)

    def walk(specs, shapes):
        if isinstance(shapes, dict):
            return {k: walk(specs[k], v) for k, v in shapes.items()}
        return one(specs, shapes)

    return walk(specs_tree, shapes_tree)


def cache_shardings(cache_shapes, mesh, batch_axes=("data",), *,
                    seq_axis=None, model_axis="model"):
    """Decode-cache specs by cache key: k/v/xk/xv (nb, B, S, H, hd), pos
    (nb, B, S), step (nb, B), conv (nb, B, K-1, C), ssm (nb, B, nh, p,
    n), the paged pools and block tables; every other key replicated.
    ``seq_axis`` shards the KV sequence dim instead (batch-1 long
    context)."""
    axis_sizes = _sizes(mesh)
    b = tuple(batch_axes)
    batch = b if len(b) > 1 else b[0]
    m = model_axis
    seq_axes = (seq_axis if isinstance(seq_axis, tuple)
                else ((seq_axis,) if seq_axis else ()))
    heads = None if model_axis in seq_axes else m
    by_name = {
        "k": (None, batch, seq_axis, heads, None),
        "v": (None, batch, seq_axis, heads, None),
        "xk": (None, batch, seq_axis, heads, None),
        "xv": (None, batch, seq_axis, heads, None),
        "pos": (None, batch, seq_axis),
        "step": (None, batch),
        "k_scale": (None, batch, seq_axis, heads),
        "v_scale": (None, batch, seq_axis, heads),
        "conv": (None, batch, None, m),
        "ssm": (None, batch, m, None, None),
        "kp": (None, None, None, heads, None),
        "vp": (None, None, None, heads, None),
        "kp_scale": (None, None, None, heads),
        "vp_scale": (None, None, None, heads),
        "bt": (None, batch, None),
    }

    def one(path, leaf):
        spec = by_name.get(_path_str(path).split("/")[-1])
        if spec is None:
            return ()
        return _fit_spec(spec, _shape(leaf), axis_sizes)[0]

    return map_with_path(one, cache_shapes)


def batch_shardings(batch_shapes, mesh, batch_axes=("data",)):
    """Host batch: shard the leading (global batch) dim. A single tensor
    or shape takes its spec alone."""
    axis_sizes = _sizes(mesh)
    b = tuple(batch_axes)
    batch = b if len(b) > 1 else b[0]

    def one(_, leaf):
        shape = _shape(leaf)
        return _fit_spec((batch,) + (None,) * (len(shape) - 1), shape,
                         axis_sizes)[0]

    return map_with_path(one, batch_shapes)


# --------------------------------------------------------------------- #
# one rank's block
# --------------------------------------------------------------------- #
def _parts(ax, mesh, coords=None) -> Tuple[int, int]:
    """(number of blocks, the block of the rank at ``coords``, default
    this rank's) along a dim sharded over ``ax`` (an axis name or a tuple
    of them, major first)."""
    coords = dict(zip(mesh.axis_names, coords or mesh.coords))
    sizes = _sizes(mesh)
    n, i = 1, 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n, i = n * sizes[a], i * sizes[a] + coords[a]
    return n, i


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """``shape`` on one rank under ``spec`` (an empty spec: replicated)."""
    shape = tuple(shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(s if ax is None else s // _parts(ax, mesh)[0]
                 for s, ax in zip(shape, spec))


def shard(tensor: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """The block of ``tensor`` under ``spec`` on the rank at ``coords``
    (default this rank): a view (a slice along each sharded dim), never
    a copy."""
    spec = tuple(spec) + (None,) * (tensor.dim() - len(spec))
    for dim, ax in enumerate(spec):
        if ax is not None:
            n, i = _parts(ax, mesh, coords)
            size = tensor.shape[dim] // n
            tensor = tensor.narrow(dim, i * size, size)
    return tensor


def shard_tree(tree, specs, mesh, copy: bool = True) -> Any:
    """Each leaf's block under its spec, copied out where it is not the
    whole leaf (contiguous, and the whole leaf can be freed), or a view
    with ``copy=False``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, copy)
                for k, v in tree.items()}
    out = shard(tree, specs, mesh)
    if copy and out.shape != tree.shape:
        out = out.clone(memory_format=torch.contiguous_format)
    return out
