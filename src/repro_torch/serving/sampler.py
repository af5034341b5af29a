"""Token samplers: greedy, temperature, top-k and top-p.

The sampler is a frozen dataclass of static knobs that the engine calls
on device-resident logits inside its fused steps, so sampled tokens
never leave the device. Stochastic sampling draws with the Gumbel-max
rule from a caller-owned ``torch.Generator``: an exact sample of the
(filtered) softmax that needs no host sync. It cannot reproduce
``jax.random``'s bits; it matches the JAX sampler's distribution. The
speculative accept/resample rule waits for the speculative slice
(ROADMAP section 1, item 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class Sampler:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full distribution
    top_p: float = 1.0         # 1 = no nucleus truncation

    def __call__(self, generator: Optional[torch.Generator], logits):
        """logits: (B, V) f32 -> token ids (B,) int64. ``generator`` is
        unused (but accepted) for greedy decoding, where ties go to the
        lowest index as in the JAX sampler."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / self.temperature
        if self.top_p < 1.0:
            logits = self._nucleus(logits)
        if self.top_k:
            vals, idx = torch.topk(logits, self.top_k, dim=-1)
            choice = self._gumbel_argmax(generator, vals)
            return torch.gather(idx, -1, choice[:, None])[:, 0]
        return self._gumbel_argmax(generator, logits)

    @staticmethod
    def _gumbel_argmax(generator, logits):
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    def _nucleus(self, logits):
        """Mask logits outside the smallest set with cumulative
        probability >= top_p (the most likely token always survives)."""
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < self.top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        return torch.where(logits >= cutoff, logits,
                           torch.full_like(logits, NEG_INF))
