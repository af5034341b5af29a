"""The train step and its driver loop: the port's copy of the JAX
package's ``training/train_loop.py``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``,
the port's ``jax.jit(make_train_step(...))``. A step is the loss forward
(on the card through the flash and RMSNorm kernels, and the SSD dual
form and the gated norm on an SSM stack, with ``cfg.remat`` recomputing
each block in the backward), ``torch.autograd.grad`` through their
backward kernels, the gradient clip and the AdamW update. With
``microbatch`` the batch is split into ``B // microbatch`` chunks whose
losses and gradients are summed in f32 and divided by their count, as
JAX's scan does. Metrics (``lm_loss``, ``aux_loss``, ``loss``,
``grad_norm``, ``lr``) are 0-d tensors on the device: nothing inside a
step reads a value back to the host.

The step is a :class:`TrainProgram`: the state lives in static buffers
(parameters, moments, step counters), updated in place
(``AdamW.update_``), and each batch is copied into a static buffer (on
the card from a fresh pinned block, without blocking the host). On a
CUDA model the first call runs the body eagerly on the device's capture
stream (the warm-up: kernel builds, autograd's and cuBLAS's state), the
second captures the whole step, forward, backward and update, as one
CUDA graph from the step's own memory pool (``core.program.capture``),
and later calls replay it: the host issues one graph launch a step,
where JAX runs one XLA program. On the CPU the same body runs eagerly on
every call. ``graphs=False`` keeps the functional eager step
(``AdamW.update``, a new state each call), for comparison. Nothing falls
back: a capture or replay that fails raises, naming the step.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.program import capture, capture_stream
from repro_torch.core.pytree import (tree_flatten_with_path, tree_leaves,
                                     tree_map)
from repro_torch.training.optimizer import AdamW, global_norm

#: eager calls of a captured step before its capture: the warm-up is a
#: real step, run by the body on the static buffers
WARMUP_STEPS = 1


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


def batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``; to a
    CUDA device through pinned memory, without blocking the host."""
    pin = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = _as_tensor(v)
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def _unflatten_like(tree, leaves):
    """A nested-dict ``tree`` with its leaves replaced by ``leaves``,
    given in ``tree_leaves`` order (sorted keys)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def _grads_of(model, params, batch):
    """(loss, metrics, gradient tree) of one train loss: the leaves are
    ``requires_grad_`` views of ``params``, so a captured step reads each
    step's parameters."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.train_loss(_unflatten_like(params, leaves),
                                         batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten_like(params, grads)


def _loss_and_grads(model, params, batch, microbatch: int):
    """``_grads_of`` over the batch, or summed in f32 over its chunks of
    ``microbatch`` rows and divided by their count."""
    if not microbatch:
        return _grads_of(model, params, batch)
    B = next(iter(batch.values())).shape[0]
    n = B // microbatch
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(n):
        mb = {k: v[i * microbatch:(i + 1) * microbatch]
              for k, v in batch.items()}
        li, metrics, gi = _grads_of(model, params, mb)
        loss = loss + li
        grads = tree_map(torch.add, grads, gi)
    return loss / n, metrics, tree_map(lambda g: g / n, grads)


def _metrics(metrics, loss, grads, lr) -> Dict[str, torch.Tensor]:
    out = dict(metrics)
    out.update(loss=loss, grad_norm=global_norm(grads), lr=lr)
    return out


def _eager_step(model, opt: AdamW, microbatch: int):
    """The functional step: a new state each call (``AdamW.update``)."""

    def step(state, batch):
        params = state["params"]
        batch = batch_to(batch, tree_leaves(params)[0].device)
        loss, metrics, grads = _loss_and_grads(model, params, batch,
                                               microbatch)
        new_params, new_opt = opt.update(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, _metrics(metrics, loss, grads,
                                   opt.lr(new_opt["step"]))

    return step


def _layout(tree):
    """Each tensor leaf's path, shape and dtype."""
    return [(path, tuple(a.shape), a.dtype)
            for path, a in tree_flatten_with_path(tree)]


class TrainProgram:
    """The train step over static buffers (the module's docstring says
    how it runs). ``state`` holds the step's own tensors once the first
    call copied the caller's state in; every call returns a state tree
    of those tensors, and a call given a state whose tensors are not
    the step's own (another run's, or a loaded one) copies it in first.
    ``graphs``: capture and replay (a CUDA model), or run the body
    eagerly on every call. ``cache_size()`` counts the captures held (at
    most one: later calls replay it); ``pool_bytes`` is the device memory
    the capture reserved in the step's own pool, which holds the step's
    activations, gradients and temporaries between replays."""

    def __init__(self, model, opt: AdamW, *, microbatch: int = 0,
                 graphs: bool = False):
        self.model, self.opt, self.microbatch = model, opt, microbatch
        self.graphs = graphs
        self.device = torch.device(model.device)
        self.name = f"the train step of {model.cfg.name}"
        self.state: Optional[Dict[str, Any]] = None
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.graph = None
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.launches: Dict[str, int] = {}
        self.calls = 0
        self.pool_bytes = 0
        self._pool = None

    def __call__(self, state, batch):
        self._load(state)
        self._stage(batch)
        metrics = self._run() if self.graphs else self._body()
        self.calls += 1
        return tree_map(lambda a: a, self.state), metrics

    def cache_size(self) -> int:
        return int(self.graph is not None)

    # -- the static buffers --------------------------------------------- #
    @torch.no_grad()
    def _load(self, state) -> None:
        if self.state is None:
            self.state = tree_map(lambda a: torch.empty(
                a.shape, dtype=a.dtype, device=self.device).copy_(a), state)
            return
        own, given = tree_leaves(self.state), tree_leaves(state)
        if len(own) == len(given) and all(
                a is b for a, b in zip(own, given)):
            return
        if _layout(state) != _layout(self.state):
            raise ValueError(
                f"{self.name}: the state's leaves differ from the step's "
                f"buffers (paths, shapes, dtypes)")
        for a, b in zip(own, given):
            a.copy_(b)

    def _stage(self, batch) -> None:
        host = {k: _as_tensor(v) for k, v in batch.items()}
        if self.batch is None:
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                          for k, v in host.items()}
        want = {k: (tuple(v.shape), v.dtype) for k, v in self.batch.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in host.items()}
        if got != want:
            raise ValueError(f"{self.name} takes batches of one layout, "
                             f"{want}; got {got}")
        pin = self.device.type == "cuda"
        for k, v in host.items():
            if pin and v.device.type == "cpu":
                v = v.pin_memory()      # a fresh block each step
            self.batch[k].copy_(v, non_blocking=pin)

    def _body(self) -> Dict[str, torch.Tensor]:
        """One step on the static buffers: reads and writes nothing else,
        reads nothing back to the host."""
        params, opt_state = self.state["params"], self.state["opt"]
        loss, metrics, grads = _loss_and_grads(self.model, params,
                                               self.batch, self.microbatch)
        self.opt.update_(grads, opt_state, params)
        self.state["step"].add_(1)
        return _metrics(metrics, loss, grads, self.opt.lr(opt_state["step"]))

    # -- graphs --------------------------------------------------------- #
    def _run(self) -> Dict[str, torch.Tensor]:
        """Warm up, capture or replay on the capture stream, ordered after
        the caller's work and before it; the metrics are copied out of
        the graph's buffers, which the next replay overwrites."""
        with self._on_stream() as main:
            if self.graph is None and self.calls >= WARMUP_STEPS:
                self._capture()
            if self.graph is None:
                out = self._body()
            else:
                self._replay()
                out = self.out
            metrics = {k: v.clone() for k, v in out.items()}
        if main is not None:
            for v in metrics.values():
                v.record_stream(main)
        return metrics

    def _capture(self) -> None:
        graph = self._new_graph()
        before = self._reserved()
        try:
            out, launches = capture(self._body, self._recording(graph))
        except RuntimeError as e:
            raise RuntimeError(
                f"{self.name}: the capture failed (a step that reads the "
                f"host cannot run as a CUDA graph): {e}") from e
        self.pool_bytes += self._reserved() - before
        self.graph, self.out, self.launches = graph, out, launches

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: the replay failed: {e}") \
                from e
        kernels.add_launches(self.launches)

    # -- the card; a test substitutes these ----------------------------- #
    @contextlib.contextmanager
    def _on_stream(self):
        """The device's capture stream, after the caller's stream's work
        and before its later work; yields the caller's stream."""
        main = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                yield main
        finally:
            main.wait_stream(side)

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _recording(self, graph):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return torch.cuda.graph(graph, pool=self._pool,
                                stream=capture_stream(self.device))

    def _reserved(self) -> int:
        """Device bytes reserved, after the free cached blocks are
        released (as ``torch.cuda.graph`` releases them on entry)."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)


def make_train_step(model, opt: AdamW, *, microbatch: int = 0,
                    graphs: Optional[bool] = None):
    """The train step of ``model``: a :class:`TrainProgram` (captured as
    a CUDA graph on a CUDA model, eager on the CPU), or with
    ``graphs=False`` the functional eager step. ``graphs=True`` needs a
    CUDA model. microbatch: if > 0, split the global batch into chunks
    of this many examples and accumulate the gradients in f32 (an
    activation memory saver; JAX's ``lax.scan`` over the chunks).

    A :class:`TrainProgram` updates its state in place (what the capture
    needs, and what keeps one copy of the parameters and moments on the
    card): the state a call returns is the step's own static buffers,
    and the next call overwrites it. JAX's jitted step donates nothing,
    so a state it returned keeps its values; here a caller that keeps a
    state across steps (a best-so-far, a rollback) clones it. With
    ``graphs=False`` every call returns fresh tensors, as JAX's."""
    if graphs is False:
        return _eager_step(model, opt, microbatch)
    on_card = torch.device(model.device).type == "cuda"
    if graphs and not on_card:
        raise ValueError(f"graphs=True needs a model on a CUDA device; "
                         f"{model.cfg.name} is on {model.device}")
    return TrainProgram(model, opt, microbatch=microbatch, graphs=on_card)


def init_train_state(model, opt: AdamW, seed: int = 0) -> Dict[str, Any]:
    """Parameters from ``seed`` on the model's device, the optimizer's
    zero state and a 0-d int32 step."""
    params = model.init(seed)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train(model, opt: AdamW, data: Iterator, *, steps: int, seed: int = 0,
          log_every: int = 10, state=None,
          callback: Optional[Callable] = None):
    """The loop the examples and tests use: ``steps`` steps of
    ``make_train_step`` (captured on the card) over ``data``; returns
    (state, history), a history entry (the step's metrics as floats,
    ``step``, ``wall_s``) every ``log_every`` steps and at the last, the
    only host reads of a run."""
    if state is None:
        state = init_train_state(model, opt, seed)
    step_fn = make_train_step(model, opt)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(data)
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(m)
    return state, history


def param_count(params) -> int:
    """Elements over the tree's leaves."""
    return sum(int(leaf.numel()) for leaf in tree_leaves(params))
