"""Token samplers: greedy, temperature, top-k and top-p, plus the
speculative-decoding accept/resample rule.

The sampler is a frozen dataclass of static knobs that the engine calls
on device-resident logits inside its fused steps, so sampled tokens
never leave the device. Stochastic sampling draws with the Gumbel-max
rule from a caller-owned ``torch.Generator``: an exact sample of the
(filtered) softmax that needs no host sync. It cannot reproduce
``jax.random``'s bits; it matches the JAX sampler's distribution. The
speculative rule (``speculative``) runs on device too: acceptance, the
first rejection's resample and the bonus token, drawn from the same
generator. On a serving mesh a data rank samples only its slots' rows:
``rows`` names them in the whole batch, and every draw is made for the
whole batch and cut to those rows, so each rank consumes its generator
as one device would and its rows get the noise one device gives them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import top_k

NEG_INF = -1e30


@dataclass(frozen=True)
class Sampler:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full distribution
    top_p: float = 1.0         # 1 = no nucleus truncation
    # (whole batch, first row) when the logits are rows [b0, b0 + B) of a
    # larger batch (a data rank's slots); None: the logits are the batch
    rows: Optional[Tuple[int, int]] = None

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
            vals, idx = self._topk(logits)
            choice = self._gumbel_argmax(generator, vals)
            return torch.gather(idx, -1, choice[:, None])[:, 0]
        return self._gumbel_argmax(generator, logits)

    def _topk(self, logits):
        """The one top-k rule of the sampler: the k largest logits, ties
        at the k-th value broken by lowest index, as ``lax.top_k`` does
        (a descending stable sort cut at k). ``__call__`` and
        ``filtered_logits`` both select through it, so the speculative
        accept/resample distributions are the ones the engine samples."""
        return top_k(logits, self.top_k)

    def filtered_logits(self, logits):
        """The post-knob logits over the full vocab: temperature, then
        nucleus, then top-k masking (masked entries at NEG_INF), so
        ``softmax(filtered_logits(l))`` is the distribution ``__call__``
        samples from, ties included (the same k entries ``_topk``
        selects). Any leading shape (..., V). Greedy has no such
        distribution; callers special-case it."""
        assert self.temperature != 0.0
        lead = logits.shape[:-1]
        logits = logits.reshape(-1, logits.shape[-1]) / self.temperature
        if self.top_p < 1.0:
            logits = self._nucleus(logits)
        if self.top_k:
            vals, idx = self._topk(logits)
            logits = torch.full_like(logits, NEG_INF).scatter(-1, idx, vals)
        return logits.reshape(lead + (-1,))

    def speculative(self, generator: Optional[torch.Generator],
                    draft_tokens, draft_logits, target_logits):
        """Speculative-decoding accept/resample (Leviathan et al. 2023),
        over the batch and on device.

        draft_tokens: (B, G) proposals; draft_logits: (B, G, V) the
        logits they were drawn from; target_logits: (B, G+1, V) the
        target's at the same positions (G is the bonus position).

        Returns ``(block, n_acc)``: ``block`` (B, G+1) int64 whose first
        ``n_acc[b] + 1`` entries are row b's tokens to emit, the accepted
        draft prefix then the resampled first rejection (or the bonus
        token when every proposal was accepted).

        Greedy: accept while a proposal equals the target's argmax, so
        the emitted prefix is the target's greedy continuation. Otherwise
        accept x when ``u * q(x) < p(x)`` (u uniform) and resample the
        first rejection from ``norm(max(p - q, 0))`` (q = 0 at the bonus
        position), so each emitted token is a sample of the target's
        distribution. The draws come from ``generator``; they cannot
        reproduce ``jax.random``'s bits, only the distribution."""
        B, G = draft_tokens.shape
        if self.temperature == 0.0:
            block = torch.argmax(target_logits, dim=-1)
            acc = draft_tokens.long() == block[:, :G]
            n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
            return block, n_acc
        p = torch.softmax(self.filtered_logits(target_logits), dim=-1)
        q = torch.softmax(self.filtered_logits(draft_logits), dim=-1)
        d = draft_tokens.long()[..., None]
        p_d = torch.gather(p[:, :G], -1, d)[..., 0]              # (B, G)
        q_d = torch.gather(q, -1, d)[..., 0]
        u = self._uniform(generator, (B, G), p.device)
        acc = u * q_d < p_d          # u < p/q without dividing by q = 0
        n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
        resid = torch.clamp(p - q_pad, min=0.0)
        # p == q: the residual is empty and any token of p will do
        empty = resid.sum(dim=-1, keepdim=True) <= 0.0
        resid = torch.where(empty, p, resid)
        r = self._gumbel_argmax(generator,
                                torch.log(torch.clamp(resid, min=1e-30)))
        d_pad = torch.cat([draft_tokens.long(),
                           torch.zeros_like(draft_tokens[:, :1]).long()],
                          dim=1)
        idx = torch.arange(G + 1, device=p.device)[None, :]
        return torch.where(idx < n_acc[:, None], d_pad, r), n_acc

    def _uniform(self, generator, shape, device):
        """U[0, 1) noise of ``shape`` (batch first), drawn for the whole
        batch and cut to this sampler's ``rows``."""
        if self.rows is None:
            return torch.rand(shape, generator=generator, device=device,
                              dtype=torch.float32)
        n, b0 = self.rows
        return torch.rand((n,) + tuple(shape[1:]), generator=generator,
                          device=device,
                          dtype=torch.float32)[b0:b0 + shape[0]]

    def _gumbel_argmax(self, generator, logits):
        u = self._uniform(generator, logits.shape, logits.device)
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
