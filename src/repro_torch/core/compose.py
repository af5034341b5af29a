"""Composition primitives: the paper's "construct new services from
existing ones". Sequential connection is the primary primitive (paper
§3); parallel, ensemble, routing and batch-mapping combinators and a set
of adapter services come beside it, as in the JAX package's
``core/compose.py``.

A composed service is one function over the combined params tree; a
``seq`` or a ``route`` also keeps its component services
(``Service.parts``). JAX compiles it into
one XLA program; the port's ``Service.jitted()`` captures it as one CUDA
graph, or as segments split around each ``route``, which reads its
branch index on the host (``core/program.py``). Called directly, a
service runs eagerly, as JAX's ``Service.__call__`` is not jitted.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.compat import CompositionError, check_composable, unify
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.service import (Service, Signature, TensorSpec,
                                      dtype_name, torch_dtype)


# --------------------------------------------------------------------- #
# sequential connection (the paper's primary primitive)
# --------------------------------------------------------------------- #
def seq(*services: Service, name: Optional[str] = None) -> Service:
    assert len(services) >= 2
    for a, b in zip(services, services[1:]):
        check_composable(a, b)
    name = name or "_then_".join(s.name for s in services)
    params = {f"stage{i}": s.params for i, s in enumerate(services)}
    fns = [s.fn for s in services]

    def fn(p, x):
        for i, f in enumerate(fns):
            x = f(p[f"stage{i}"], x)
        return x

    sig = Signature(services[0].signature.inputs,
                    services[-1].signature.outputs)
    return Service(name=name, fn=fn, signature=sig, params=params,
                   description=f"sequential composition of "
                               f"{[s.name for s in services]}",
                   metadata={"combinator": "seq",
                             "stages": [s.name for s in services]},
                   parts=tuple(services))


# --------------------------------------------------------------------- #
# parallel: independent services over a dict of inputs
# --------------------------------------------------------------------- #
def parallel(named: Dict[str, Service], *, name: Optional[str] = None) -> Service:
    name = name or "par_" + "_".join(named)
    params = {k: s.params for k, s in named.items()}
    fns = {k: s.fn for k, s in named.items()}

    def fn(p, xs):
        return {k: f(p[k], xs[k]) for k, f in fns.items()}

    sig = Signature({k: s.signature.inputs for k, s in named.items()},
                    {k: s.signature.outputs for k, s in named.items()})
    return Service(name=name, fn=fn, signature=sig, params=params,
                   metadata={"combinator": "parallel",
                             "stages": list(named)})


# --------------------------------------------------------------------- #
# ensemble: same input to N services, combine outputs
# --------------------------------------------------------------------- #
def ensemble(services: Sequence[Service], combine: str = "mean",
             *, name: Optional[str] = None) -> Service:
    s0 = services[0]
    for s in services[1:]:
        errs = unify(s0.signature.inputs, s.signature.inputs,
                     where=f"ensemble inputs {s0.name} vs {s.name}")
        errs += unify(s0.signature.outputs, s.signature.outputs,
                      where=f"ensemble outputs {s0.name} vs {s.name}")
        if errs:
            raise CompositionError("; ".join(errs))
    name = name or "ens_" + "_".join(s.name for s in services)
    params = {f"member{i}": s.params for i, s in enumerate(services)}
    fns = [s.fn for s in services]

    def fn(p, x):
        outs = [f(p[f"member{i}"], x) for i, f in enumerate(fns)]
        if combine == "mean":
            return tree_map(lambda *ys: sum(ys) / len(ys), *outs)
        if combine == "sum":
            return tree_map(lambda *ys: sum(ys), *outs)
        if combine == "stack":
            return tree_map(lambda *ys: torch.stack(ys), *outs)
        raise ValueError(combine)

    out_sig = s0.signature.outputs
    if combine == "stack":
        out_sig = tree_map(
            lambda t: TensorSpec((len(services),) + t.shape, t.dtype),
            out_sig)
    return Service(name=name, fn=fn,
                   signature=Signature(s0.signature.inputs, out_sig),
                   params=params,
                   metadata={"combinator": "ensemble", "combine": combine,
                             "stages": [s.name for s in services]})


# --------------------------------------------------------------------- #
# route: data-dependent branch selection
# --------------------------------------------------------------------- #
def route(selector: Service, branches: Sequence[Service],
          *, name: Optional[str] = None) -> Service:
    """selector maps the input to an int32 scalar branch index; all
    branches must share input/output signatures.

    JAX chooses on the device with ``lax.switch``. The port needs the
    choice on the host: the index is read back (a device sync, the
    port's cost of a route) and only that branch runs, as ``lax.switch``
    runs one; a program runs the selector and the branch as separate
    graphs for it. An index out of range is clamped into it, as
    ``lax.switch`` clamps."""
    s0 = branches[0]
    for s in branches[1:]:
        errs = unify(s0.signature.outputs, s.signature.outputs,
                     where=f"route {s0.name} vs {s.name}")
        if errs:
            raise CompositionError("; ".join(errs))
    name = name or "route_" + "_".join(s.name for s in branches)
    params = {"selector": selector.params,
              **{f"branch{i}": s.params for i, s in enumerate(branches)}}
    bfns = [s.fn for s in branches]
    sel_fn = selector.fn

    def fn(p, x):
        idx = int(torch.as_tensor(sel_fn(p["selector"], x)).reshape(()))
        i = min(max(idx, 0), len(bfns) - 1)
        return bfns[i](p[f"branch{i}"], x)

    return Service(name=name, fn=fn,
                   signature=Signature(s0.signature.inputs,
                                       s0.signature.outputs),
                   params=params,
                   metadata={"combinator": "route",
                             "stages": [s.name for s in branches]},
                   parts=(selector, *branches))


# --------------------------------------------------------------------- #
# map_batch: lift a per-example service over a leading batch axis
# --------------------------------------------------------------------- #
def map_batch(service: Service, *, name: Optional[str] = None) -> Service:
    """``jax.vmap`` of the service over the leading axis of every input
    leaf. ``torch.func.vmap`` cannot trace a kernel launched through
    ctypes, so the port loops over the axis and stacks the outputs: the
    same function."""
    name = name or f"vmap_{service.name}"
    inner = service.fn

    def fn(p, x):
        n = tree_leaves(x)[0].shape[0]
        outs = [inner(p, tree_map(lambda a, i=i: a[i], x))
                for i in range(n)]
        return tree_map(lambda *ys: torch.stack(ys), *outs)

    sig = Signature(
        tree_map(lambda t: TensorSpec((-1,) + t.shape, t.dtype),
                 service.signature.inputs),
        tree_map(lambda t: TensorSpec((-1,) + t.shape, t.dtype),
                 service.signature.outputs))
    return Service(name=name, fn=fn, signature=sig, params=service.params,
                   metadata={"combinator": "map_batch",
                             "stages": [service.name]})


# --------------------------------------------------------------------- #
# adapters: stateless glue services
# --------------------------------------------------------------------- #
def adapter(name: str, f: Callable[[Any], Any], in_spec, out_spec) -> Service:
    return Service(name=name, fn=lambda _p, x: f(x),
                   signature=Signature(in_spec, out_spec),
                   metadata={"combinator": "adapter"})


def cast_adapter(in_spec, dtype) -> Service:
    """``dtype``: a torch dtype or a dtype name."""
    dname = dtype_name(dtype)
    out_spec = tree_map(lambda t: TensorSpec(t.shape, dname), in_spec)
    return adapter(f"cast_{dname}",
                   lambda x: tree_map(lambda a: a.to(torch_dtype(dname)), x),
                   in_spec, out_spec)


def select_adapter(in_spec, key: str) -> Service:
    """Pick one field out of a dict output."""
    return adapter(f"select_{key}", lambda x: x[key], in_spec, in_spec[key])
