"""Kernel launches under autograd.

A tensor filled by a ctypes launch has no ``grad_fn`` of its own: a
``backward()`` through it would give the kernel's inputs no gradient and
raise nothing. Two ways in, both calling the launch straight when no
gradient can be asked for (grad mode off, or no input that requires
grad), so the engine, whose tensors never require grad, pays no
``Function.apply`` and launches exactly what it launched before:

* ``differentiable``: the forward launch runs inside a node whose
  backward is a kernel too (the flash-attention, RMSNorm add / norm /
  gated and SSD dual-form backward kernels, ROADMAP section 1, items 12a
  and 12b). The forward saves what the backward reads through
  ``save_for_backward``, so activation checkpointing
  (``torch.utils.checkpoint``, non-reentrant) drops and recomputes it
  like any other saved tensor.
* ``launch``: the forward inside a node whose backward raises, saying
  that the op is for inference only (``INFERENCE_ONLY``: the decode
  attention kernels, the quantized matmuls, and the SSD recurrence,
  which no training path differentiates: the train forward runs the
  dual form).

On the CPU the ops run their plain versions, which autograd
differentiates.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

#: the ops that run through ``launch``, by the name their launch passes:
#: none has a backward, by design
INFERENCE_ONLY = ("decode attention", "paged decode attention",
                  "int8 quant_matmul", "int4 quant_matmul", "ssd_extend")


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"{ctx.name} has no backward kernel: the "
                                  f"op is for inference only")


def _wants_grad(args) -> bool:
    """Grad mode on and a tensor among ``args`` requiring grad. (A loop,
    not ``any`` over a generator: this runs on every launch.)"""
    if torch.is_grad_enabled():
        for a in args:
            if isinstance(a, torch.Tensor) and a.requires_grad:
                return True
    return False


def launch(name, fn, *args):
    """``fn(*args)``; inside a node whose backward raises when grad mode
    is on and a tensor among ``args`` requires grad."""
    if _wants_grad(args):
        return _NoBackward.apply(name, fn, *args)
    return fn(*args)


class _WithBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd, bwd, *args):
        outs, saved, meta = fwd(*args)
        ctx.set_materialize_grads(False)    # an unused output gives None
        ctx.bwd, ctx.meta = bwd, meta
        ctx.save_for_backward(*saved)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.bwd(ctx.meta, ctx.saved_tensors,
                                            *grads))


def differentiable(fast: Callable, fwd: Callable[..., Tuple[Any, Sequence,
                                                            Any]],
                   bwd: Callable, *args):
    """The op's outputs for ``args``. With no gradient to ask for:
    ``fast(*args)``, the plain launch. Otherwise ``fwd(*args)`` inside a
    node: it returns ``(outputs, tensors to save, meta)``; the node's
    backward calls ``bwd(meta, saved tensors, *output grads)`` (a grad
    None for an output that took no part) and takes its return, one
    gradient (or None) a member of ``args``."""
    if _wants_grad(args):
        return _WithBackward.apply(fwd, bwd, *args)
    return fast(*args)
