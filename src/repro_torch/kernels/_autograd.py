"""Kernel launches under autograd.

A tensor filled by a ctypes launch has no ``grad_fn`` of its own: a
``backward()`` through it would give the kernel's inputs no gradient and
raise nothing. ``launch`` runs a kernel's launch inside a node whose
backward raises, when a gradient could be asked for (grad mode on and an
input that requires grad), and calls it straight otherwise, so the
engine, whose tensors never require grad, pays no ``Function.apply``.
The backward kernels are ROADMAP section 1, item 12 (training). On the
CPU the ops run their plain versions, which autograd differentiates.
"""
from __future__ import annotations

import torch


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward kernel yet: ROADMAP section 1, "
            f"item 12 (training)")


def launch(name, fn, *args):
    """``fn(*args)``; inside a node whose backward raises when grad mode
    is on and a tensor among ``args`` requires grad. (A loop, not
    ``any`` over a generator: this runs on every launch.)"""
    if torch.is_grad_enabled():
        for a in args:
            if isinstance(a, torch.Tensor) and a.requires_grad:
                return _NoBackward.apply(name, fn, *args)
    return fn(*args)
