"""AdamW with gradient clipping and the cosine learning-rate schedule: the
port's copy of the JAX package's ``training/optimizer.py``.

The optimizer state mirrors the parameter tree (nested dicts,
``core/pytree.py``): f32 first and second moments ``m`` and ``v`` and a
0-d int32 ``step``, so a state crosses between the packages leaf for
leaf. ``update`` is functional, as in JAX: it returns new parameters and
a new state, computed under ``torch.no_grad()`` in f32 and cast back to
each parameter's dtype, one leaf at a time, so the f32 gradient and the
update's temporaries of one leaf are alive at once, not of the whole
tree (qwen2-moe-a2.7b on 4 layers, 2.9 B parameters, fits one card). A schedule takes the step as a tensor and
returns a 0-d f32 tensor on its device: nothing here reads a value back
to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_map


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Any], Any]:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac * base_lr`` at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: torch.full(
        (), base_lr, dtype=torch.float32,
        device=step.device if isinstance(step, torch.Tensor) else None)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[Any], Any]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def _clip_and_bias(self, grads, step):
        """The clip factor, the bias corrections and the learning rate of
        the step that ends at ``step``."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        sf = step.float()
        return scale, 1 - self.b1 ** sf, 1 - self.b2 ** sf, self.lr(step)

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Any]:
        """(new params, new state): the gradients clipped to a global
        norm of ``clip_norm``, then one AdamW step with bias-corrected
        moments and decoupled weight decay, all in f32."""
        step = state["step"] + 1
        scale, bc1, bc2, lr = self._clip_and_bias(grads, step)
        moments = []

        def upd(p, g, m, v):
            # JAX's expressions, op for op (b1 m + (1 - b1) g; b2 v + ((1
            # - b2) g) g; m^ / (sqrt(v^) + eps) + wd p; p - lr delta),
            # with the temporaries this function made reused in place (an
            # input is never written: an f32 leaf's .float() is itself):
            # at most three f32 copies of the leaf besides its new moments
            g = g.float() * scale
            m = (self.b1 * m).add_((1 - self.b1) * g)
            v = (self.b2 * v).add_(((1 - self.b2) * g).mul_(g))
            del g
            moments.append((m, v))
            return self._apply(p, m, v, bc1, bc2, lr)

        new_params = tree_map(upd, params, grads, state["m"], state["v"])
        it_m, it_v = (iter(t) for t in zip(*moments))
        return new_params, {"m": tree_map(lambda _: next(it_m), params),
                            "v": tree_map(lambda _: next(it_v), params),
                            "step": step}

    @torch.no_grad()
    def update_(self, grads, state, params) -> None:
        """``update`` written in place: each parameter, ``m`` and ``v``
        and ``state["step"]`` take their new values in their own tensors,
        from the same expressions in the same order (the same bits)."""
        step = state["step"].add_(1)
        scale, bc1, bc2, lr = self._clip_and_bias(grads, step)

        def upd(p, g, m, v):
            g = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_(((1 - self.b2) * g).mul_(g))
            del g
            p.copy_(self._apply(p, m, v, bc1, bc2, lr))

        tree_map(upd, params, grads, state["m"], state["v"])

    def _apply(self, p, m, v, bc1, bc2, lr):
        """p - lr (m^ / (sqrt(v^) + eps) + wd p) in f32, cast to p's
        dtype."""
        delta = m / bc1
        delta.div_((v / bc2).sqrt_().add_(self.eps))
        pf = p.to(torch.float32, copy=True)
        delta.add_(self.weight_decay * pf)
        return pf.sub_(delta.mul_(lr)).to(p.dtype)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the JAX package's leaf order) of
    each leaf's f32 sum of squares: a 0-d f32 tensor."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    total = leaves[0]
    for s in leaves[1:]:
        total = total + s
    return torch.sqrt(total)
