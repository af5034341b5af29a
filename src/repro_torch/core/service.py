"""The paper's central abstraction: a typed, composable ML *service*.

Following the paper, a service = **functionality** (a computational
function with a typed interaction interface) + **deployment** (interface
and location, handled in :mod:`repro_torch.core.deploy`, deliberately
separate, so a service can move local -> remote -> split without
structural change).

A ``Signature`` is a pytree (:mod:`repro_torch.core.pytree`) of
``TensorSpec`` (shape with ``-1`` wildcards + dtype) for inputs and
outputs. A ``TensorSpec`` keeps numpy-style dtype *names* (``"float32"``,
``"bfloat16"``, ``"int32"``), so a signature written to a zoo manifest by
the JAX package and one written by the port compare equal; ``torch_dtype``
maps a name to torch. Composition primitives live in
:mod:`repro_torch.core.compose`; compatibility checking in
:mod:`repro_torch.core.compat`.

Where the JAX package derives an output signature with ``jax.eval_shape``
(abstract evaluation), the port runs the function once on the example
itself (under ``torch.no_grad``): the meta device cannot stand in,
because a service that reaches a kernel op refuses meta tensors
(``kernels.dispatch.use_kernel``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.program import ServiceProgram
from repro_torch.core.pytree import tree_leaves, tree_map

_BY_NAME = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16, "float64": torch.float64,
            "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
            "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_BY_DTYPE = {v: k for k, v in _BY_NAME.items()}


def dtype_name(dtype) -> str:
    """A torch dtype, or a dtype name, as its numpy-style name."""
    if isinstance(dtype, str):
        if dtype not in _BY_NAME:
            raise ValueError(f"unknown dtype name {dtype!r}")
        return dtype
    return _BY_DTYPE[dtype]


def torch_dtype(name) -> torch.dtype:
    return _BY_NAME[dtype_name(name)]


# --------------------------------------------------------------------- #
# typed signatures
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype spec; -1 dims are wildcards (e.g. batch)."""

    shape: Tuple[int, ...]
    dtype: str

    @classmethod
    def of(cls, x) -> "TensorSpec":
        return cls(tuple(int(s) for s in x.shape), dtype_name(x.dtype))

    def matches(self, other: "TensorSpec") -> bool:
        if len(self.shape) != len(other.shape):
            return False
        for a, b in zip(self.shape, other.shape):
            if a != -1 and b != -1 and a != b:
                return False
        return dtype_name(self.dtype) == dtype_name(other.dtype)

    def to_json(self):
        return {"shape": list(self.shape), "dtype": self.dtype}

    @classmethod
    def from_json(cls, d):
        return cls(tuple(d["shape"]), d["dtype"])


def spec_tree_of(tree) -> Any:
    """Tensor pytree -> TensorSpec pytree."""
    return tree_map(TensorSpec.of, tree)


@dataclass(frozen=True)
class Signature:
    inputs: Any     # pytree of TensorSpec
    outputs: Any


# --------------------------------------------------------------------- #
# service
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Service:
    """Functionality half of a Zoo service.

    ``fn(params, inputs) -> outputs`` must be a pure function of its
    arguments. ``params`` may be ``None`` for stateless adapter services.
    A ``seq`` or ``route`` keeps its component services in ``parts``:
    the program ``jitted()`` returns splits a composition around a route
    by them (``core/program.py``).
    """

    name: str
    fn: Callable[[Any, Any], Any]
    signature: Signature
    params: Any = None
    version: str = "0.1.0"
    description: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)
    parts: Tuple["Service", ...] = field(default=(), repr=False,
                                         compare=False)

    # -- ergonomics ---------------------------------------------------- #
    def __rshift__(self, other: "Service") -> "Service":
        from repro_torch.core.compose import seq
        return seq(self, other)

    def __call__(self, inputs, params=None):
        return self.fn(self.params if params is None else params, inputs)

    def jitted(self) -> Callable[[Any, Any], Any]:
        """``(params, inputs) -> outputs`` as a program: CUDA graphs on
        the card, eager on the CPU (``core.program.ServiceProgram``)."""
        return ServiceProgram(self)

    def with_params(self, params) -> "Service":
        return dataclasses.replace(self, params=params)

    def check_input(self, inputs) -> None:
        from repro_torch.core.compat import check_concrete
        check_concrete(self.signature.inputs, inputs, where=self.name)

    @property
    def n_params(self) -> int:
        if self.params is None:
            return 0
        return sum(int(x.numel()) for x in tree_leaves(self.params))

    def output_eval_shape(self, inputs):
        """The output spec tree for ``inputs``, from one run of ``fn``."""
        with torch.no_grad():
            return spec_tree_of(self.fn(self.params, inputs))


def service_from_fn(name, fn, example_in, params=None, **kw) -> Service:
    """Build a service; its signature is the example's spec tree and that
    of ``fn``'s output on the example (one run, under ``no_grad``)."""
    with torch.no_grad():
        out = fn(params, example_in)
    sig = Signature(spec_tree_of(example_in), spec_tree_of(out))
    return Service(name=name, fn=fn, signature=sig, params=params, **kw)
