"""The train step and its driver loop: the port's copy of the JAX
package's ``training/train_loop.py``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
It runs eagerly: the loss forward (on the card through the flash and
RMSNorm kernels, with ``cfg.remat`` recomputing each block in the
backward), ``torch.autograd.grad`` through their backward kernels, then
``AdamW.update``. With ``microbatch`` the batch is split into ``B //
microbatch`` chunks whose losses and gradients are summed in f32 and
divided by their count, as JAX's scan does. Metrics (``lm_loss``,
``aux_loss``, ``loss``, ``grad_norm``, ``lr``) stay 0-d tensors on the
device: nothing inside a step reads a value back to the host. Capturing
the step as a CUDA graph is ROADMAP section 1, item 12c.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamW, global_norm


def batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def _unflatten_like(tree, leaves):
    """A nested-dict ``tree`` with its leaves replaced by ``leaves``,
    given in ``tree_leaves`` order (sorted keys)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def make_train_step(model, opt: AdamW, *, microbatch: int = 0):
    """microbatch: if > 0, split the global batch into chunks of this
    many examples and accumulate the gradients in f32 (an activation
    memory saver; JAX's ``lax.scan`` over the chunks)."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = model.train_loss(
                _unflatten_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, _unflatten_like(params, grads)

    def step(state, batch):
        params = state["params"]
        batch = batch_to(batch, tree_leaves(params)[0].device)
        if microbatch:
            B = next(iter(batch.values())).shape[0]
            n = B // microbatch
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n):
                mb = {k: v[i * microbatch:(i + 1) * microbatch]
                      for k, v in batch.items()}
                li, metrics, gi = grads_of(params, mb)
                loss = loss + li
                grads = tree_map(torch.add, grads, gi)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, metrics, grads = grads_of(params, batch)

        new_params, new_opt = opt.update(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=global_norm(grads),
                       lr=opt.lr(new_opt["step"]))
        return new_state, metrics

    return step


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
    """The driver the examples and tests use: ``steps`` steps over
    ``data``; returns (state, history), a history entry (the step's
    metrics as floats, ``step``, ``wall_s``) every ``log_every`` steps
    and at the last, the only host reads of a run."""
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
