"""A small pytree helper over nested dicts, lists and tuples.

Dicts flatten in sorted key order, as ``jax.tree`` does, so leaf order,
ensemble stacking, compatibility paths and error messages match the JAX
package's. ``None`` is an empty subtree (no leaves), as in JAX; every
other object (a tensor, a ``TensorSpec``, a number) is a leaf. Paths are
tuples of dict keys and sequence indices.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def tree_flatten_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or set(r) != set(tree) for r in rest):
            raise ValueError("tree_map: trees differ in structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree)
               for r in rest):
            raise ValueError("tree_map: trees differ in structure")
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def path_str(path: Path) -> Tuple[str, ...]:
    """A path as JAX prints its keys: ``['key']`` for a dict key, ``[i]``
    for a sequence index."""
    return tuple(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                 for k in path)
