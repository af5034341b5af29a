"""Static compatibility checking for service composition: the analogue
of the OCaml type checking the original Zoo relied on. Composition fails
before anything runs, with a precise diagnostic. Paths and messages are
the JAX package's (``core/compat.py``)."""
from __future__ import annotations

from typing import Any, List

from repro_torch.core.pytree import path_str, tree_flatten_with_path
from repro_torch.core.service import TensorSpec, spec_tree_of


class CompositionError(TypeError):
    pass


def _paths(tree):
    return {path_str(path): leaf
            for path, leaf in tree_flatten_with_path(tree)}


def unify(producer: Any, consumer: Any, *, where: str = "") -> List[str]:
    """Check a producer's output spec tree feeds a consumer's input spec
    tree. Returns a list of human-readable mismatch strings (empty = ok)."""
    errs: List[str] = []
    p, c = _paths(producer), _paths(consumer)
    if set(p) != set(c):
        missing = sorted(set(c) - set(p))
        extra = sorted(set(p) - set(c))
        if missing:
            errs.append(f"{where}: consumer expects missing fields {missing}")
        if extra:
            errs.append(f"{where}: producer has unconsumed fields {extra}")
    for k in sorted(set(p) & set(c)):
        a, b = p[k], c[k]
        if not isinstance(a, TensorSpec) or not isinstance(b, TensorSpec):
            continue
        if not a.matches(b):
            errs.append(f"{where}: field {'/'.join(k) or '<root>'} "
                        f"produces {a.shape}:{a.dtype} but consumer needs "
                        f"{b.shape}:{b.dtype}")
    return errs


def check_composable(s1, s2) -> None:
    errs = unify(s1.signature.outputs, s2.signature.inputs,
                 where=f"{s1.name} >> {s2.name}")
    if errs:
        raise CompositionError("; ".join(errs))


def check_concrete(spec_tree: Any, value_tree: Any, *, where: str = "") -> None:
    errs = unify(spec_tree_of(value_tree), spec_tree, where=where)
    if errs:
        raise CompositionError("; ".join(errs))
