"""Programs: work recorded once as a CUDA graph and replayed, the port's
counterpart of the JAX package's jitted programs.

Two kinds use one core, :func:`capture`: the engine's step programs
(``serving/engine.py::StepProgram``) and the Zoo's compiled service
call, :class:`ServiceProgram`, which ``Service.jitted()`` returns and
which runs each endpoint group of a ``DeployedService`` and each stage
of ``profile_stages`` (where JAX calls ``jax.jit``).

A ``ServiceProgram`` on CUDA tensors runs the first call of a key
eagerly (the warm-up: kernel builds, attributes, library handles; no
build may fall inside a capture), then copies the inputs into static
buffers it owns and captures the service on a side stream, from a
memory pool of its own. Later calls of that key copy their inputs in,
replay the graph, add the launches its capture recorded to the kernel
counters and return clones of its outputs (JAX returns fresh arrays;
the next replay overwrites the graph's). The key is the inputs' spec
tree (shapes, dtypes, devices) and the storage of every params leaf: a
graph reads fixed addresses, so another params tree is another capture.
On the CPU the service runs eagerly on every call, and autograd works
as it does through ``jax.jit``.

A graph cannot read the device from the host, and ``route`` must read
its branch index. A composition holding a route runs as segments split
around it, taken from the composition's own structure (``seq`` and
``route`` keep their parts): the work before the route and its selector
are one graph; the index is read (one device sync, the port's cost of a
route); the branch taken runs as its own graph, captured the first time
that branch runs; the work after the route is another graph. A route
the program cannot see through ``seq`` and ``route`` parts (inside
``parallel``, ``ensemble`` or ``map_batch``, or in a quantized group)
is captured with the rest, and like any function that reads the host
its capture raises, naming the service.

Nothing falls back to eager: a failed capture raises, and so does a call
on the card under grad mode with an input or param that requires grad
(a graph carries no autograd, and the port's kernels give no backward).
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core.pytree import tree_flatten_with_path, tree_leaves, \
    tree_map

#: what a gradient through a captured call waits for
TRAINING_ITEM = "ROADMAP section 1, item 12 (training)"


def capture(body: Callable[[], Any], recording) -> Tuple[Any, Dict[str, int]]:
    """Record ``body()`` inside ``recording`` (a ``torch.cuda.graph``
    context): returns its output and the kernel launches the capture
    counted, by wrapper name. The counters are set back, since a capture
    records kernels and runs none of them, also when the capture raises.
    The garbage collector is off meanwhile: a collection inside the
    capture could destroy an unreachable program's graphs, which
    invalidates the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with kernels.recorded_launches() as launches:
            with recording:
                out = body()
    finally:
        if collecting:
            gc.enable()
    return out, launches


def _clone(a):
    return a.clone() if isinstance(a, torch.Tensor) else a


def _spec_key(tree) -> Tuple[Any, ...]:
    """The spec tree of ``tree``: each leaf's path with its shape, dtype
    and device (a tensor) or its value (anything else)."""
    return tuple((path, (tuple(a.shape), a.dtype, a.device))
                 if isinstance(a, torch.Tensor) else (path, a)
                 for path, a in tree_flatten_with_path(tree))


def _storage_key(tree) -> Tuple[Any, ...]:
    """Where each tensor leaf of ``tree`` lives: what a captured graph
    reads."""
    return tuple((path, a.data_ptr(), tuple(a.shape), a.stride(), a.dtype,
                  a.device)
                 for path, a in tree_flatten_with_path(tree)
                 if isinstance(a, torch.Tensor))


class _Segment:
    """A run of device work ``fn(params, x)`` and its captures, one a key:
    (graph, static inputs, outputs, launches)."""

    def __init__(self, name: str, fn: Callable[[Any, Any], Any]):
        self.name, self.fn = name, fn
        self.graphs: Dict[Tuple[Any, ...], Tuple[Any, Any, Any,
                                                 Dict[str, int]]] = {}

    def __call__(self, prog: "ServiceProgram", params, x, pkey):
        key = (pkey, _spec_key(x))
        hit = self.graphs.get(key)
        if hit is None:
            y = self.fn(params, x)           # the warm-up
            self.graphs[key] = prog._capture(self, params, x)
            return y
        graph, static, out, launches = hit
        for s, a in zip(tree_leaves(static), tree_leaves(x)):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
        graph.replay()
        kernels.add_launches(launches)
        return out


class _Switch:
    """A route: ``head`` (the work before it and its selector) returns
    (x, index); the index picks one of ``branches``, each a step list."""

    def __init__(self, head: _Segment, branches: List[list]):
        self.head, self.branches = head, branches


def _splits(svc) -> bool:
    """Whether ``svc``'s parts (``seq`` and ``route`` keep them) show a
    route to split around."""
    return bool(svc.parts) and (svc.metadata.get("combinator") == "route"
                                or any(_splits(s) for s in svc.parts))


def _items(svc, get) -> list:
    """``svc`` as a flat list of work items (name, fn(root params, x))
    and routes (name, selector fn, [branch item lists]); ``get`` maps the
    root params tree to ``svc``'s."""
    if not _splits(svc):
        return [(svc.name, lambda p, x, f=svc.fn: f(get(p), x))]
    if svc.metadata["combinator"] == "seq":
        return [it for i, s in enumerate(svc.parts)
                for it in _items(s, lambda p, i=i: get(p)[f"stage{i}"])]
    sel, *branches = svc.parts
    return [(svc.name,
             lambda p, x, f=sel.fn: f(get(p)["selector"], x),
             [_items(b, lambda p, i=i: get(p)[f"branch{i}"])
              for i, b in enumerate(branches)])]


def _chain(fns):
    def fn(p, x):
        for f in fns:
            x = f(p, x)
        return x
    return fn


def _head(pre, sel):
    """The work before a route, then its selector: (x, index)."""
    def fn(p, x):
        y = pre(p, x)
        return y, sel(p, y)
    return fn


def _steps(items: list) -> list:
    """Merge consecutive work items into one segment each, and the work
    before a route with its selector into the route's head."""
    steps, names, fns = [], [], []
    for it in items:
        if len(it) == 2:
            names.append(it[0])
            fns.append(it[1])
            continue
        name, sel, branches = it
        steps.append(_Switch(
            _Segment("+".join(names + [f"{name}.selector"]),
                     _head(_chain(fns), sel)),
            [_steps(b) for b in branches]))
        names, fns = [], []
    if fns:
        steps.append(_Segment("+".join(names), _chain(fns)))
    return steps


class ServiceProgram:
    """A service's call as CUDA graphs on the card, eagerly on the CPU
    (the module's docstring says how). ``cache_size()`` counts the
    captures held, as ``jax.jit``'s ``_cache_size()`` counts its
    compilations: steady calls add none. ``pool_bytes`` is the device
    memory the captures reserved in the program's own pool, kept for as
    long as the program lives."""

    def __init__(self, service):
        self.service = service
        self.pool_bytes = 0
        self._plan: Optional[list] = None
        self._device: Optional[torch.device] = None
        self._pool = None
        self._stream = None

    def __call__(self, params, inputs):
        leaves = [a for a in tree_leaves((params, inputs))
                  if isinstance(a, torch.Tensor)]
        if not self._on_card(leaves):
            return self.service.fn(params, inputs)
        if torch.is_grad_enabled() and any(a.requires_grad for a in leaves):
            raise RuntimeError(
                f"{self.service.name}: a captured call carries no autograd "
                f"and the port's kernels give no backward; gradients on "
                f"the card wait for {TRAINING_ITEM}")
        if self._plan is None:
            self._device = next((a.device for a in leaves if a.is_cuda),
                                None)
            self._plan = _steps(_items(self.service, lambda p: p))
        return tree_map(_clone, self._run(self._plan, params, inputs,
                                          _storage_key(params)))

    def cache_size(self) -> int:
        def count(steps):
            return sum(len(s.graphs) if isinstance(s, _Segment) else
                       len(s.head.graphs) + sum(count(b) for b in s.branches)
                       for s in steps)
        return count(self._plan or [])

    def _run(self, steps, params, x, pkey):
        for step in steps:
            if isinstance(step, _Segment):
                x = step(self, params, x, pkey)
                continue
            x, idx = step.head(self, params, x, pkey)
            i = min(max(self._read_index(idx), 0), len(step.branches) - 1)
            x = self._run(step.branches[i], params, x, pkey)
        return x

    def _capture(self, seg: _Segment, params, x):
        static = tree_map(lambda a: a.detach().clone()
                          if isinstance(a, torch.Tensor) else a, x)
        graph = self._new_graph()
        before = self._reserved()
        try:
            out, launches = capture(lambda: seg.fn(params, static),
                                    self._recording(graph))
        except RuntimeError as e:
            raise RuntimeError(
                f"service {self.service.name!r}: the capture of "
                f"{seg.name!r} failed (a function that reads the host "
                f"cannot run as a CUDA graph): {e}") from e
        self.pool_bytes += self._reserved() - before
        return graph, static, out, launches

    # -- the card; a test substitutes these ----------------------------- #
    def _on_card(self, leaves) -> bool:
        return any(a.is_cuda for a in leaves)

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _recording(self, graph):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self._device)
        return torch.cuda.graph(graph, pool=self._pool, stream=self._stream)

    def _reserved(self) -> int:
        """Device bytes reserved, after the free cached blocks are
        released (as ``torch.cuda.graph`` releases them on entry)."""
        torch.cuda.synchronize(self._device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self._device)

    @staticmethod
    def _read_index(idx) -> int:
        return int(torch.as_tensor(idx).reshape(()))
