"""Prompt-lookup (n-gram) speculative drafter: the port's copy of the JAX
package's ``serving/ngram_draft.py``. Draft proposals with no draft
model, no draft cache and no second forward.

Each slot keeps a token *history* on the device, its effective stream
(prompt, then everything emitted), so the fused spec step stays free of
host syncs. To propose, the drafter matches the most recent ``n``-gram
of each row against earlier occurrences in the row's own stream and
proposes the tokens that followed the most recent match (descending
``n``, so the longest context wins). Every op is a static-shape device
op (``torch.roll``, ``gather``, ``where``): no boolean indexing and no
``.item()``, so the drafter runs inside a captured CUDA graph.

Proposals are deterministic functions of the history, so greedy
decoding is token-identical to plain decode: ``Sampler.speculative``
emits the target argmax prefix whatever the drafter proposed. For
stochastic sampling the drafter's distribution is the one-hot of its
proposal, so the accept ratio ``p/q`` reduces to accepting with the
target's own probability of the proposed token.
"""
from __future__ import annotations

import torch

__all__ = ["ngram_propose"]


def ngram_propose(hist, hist_len, *, gamma: int, vocab: int,
                  max_n: int = 3):
    """Propose ``gamma`` draft tokens per row from the row's own stream.

    Args:
      hist: (B, H) integer token history, front-filled, ``-1`` past
        ``hist_len``.
      hist_len: (B,) valid prefix length of each row.
      gamma: number of tokens to propose.
      vocab: vocabulary size (for the one-hot proposal distribution).
      max_n: longest context n-gram to try (descending to 1).

    Returns ``(draft_tokens, draft_logits)``: (B, gamma) int64 proposals
    and (B, gamma, vocab) f32 one-hot logits (0 on the proposal, -1e9
    elsewhere).

    Matching, as in the JAX drafter: for each ``n`` from ``max_n`` down
    to 1, row ``b``'s context is its last ``n`` valid tokens; a window
    at ``j`` matches when ``hist[b, j:j+n]`` equals the context and
    ``j + n <= hist_len - 1`` (a continuation exists before the context
    itself, which excludes the trivial self-match). The most recent
    match wins and proposals start at its continuation, clamped to the
    last valid position; rows with no match propose repeat-last.
    """
    B, H = hist.shape
    dev = hist.device
    hist = hist.long()
    l = hist_len.long()                                        # (B,)
    last = torch.clamp(l - 1, min=0)
    j_idx = torch.arange(H, device=dev)                        # (H,)
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    start = last                                  # fallback: repeat-last
    for n in range(max_n, 0, -1):
        cpos = l[:, None] - n + torch.arange(n, device=dev)[None, :]
        ctx = torch.gather(hist, 1, torch.clamp(cpos, min=0))  # (B, n)
        ok = torch.ones((B, H), dtype=torch.bool, device=dev)
        for k in range(n):
            # shifted[:, j] = hist[:, j+k]; the wrap past H-1 is
            # unreachable under the j + n <= l-1 bound below
            ok = ok & (torch.roll(hist, -k, dims=1) == ctx[:, k][:, None])
        ok = ok & (j_idx[None, :] + n <= l[:, None] - 1) \
            & (l[:, None] >= n + 1)
        j = torch.where(ok, j_idx[None, :],
                        torch.full_like(ok, -1, dtype=torch.long)
                        ).amax(dim=1)                          # (B,)
        hit = (j >= 0) & ~found
        start = torch.where(hit, j + n, start)
        found = found | hit
    pos = torch.minimum(start[:, None]
                        + torch.arange(gamma, device=dev)[None, :],
                        last[:, None])                         # (B, g)
    draft = torch.clamp(torch.gather(hist, 1, pos), min=0)
    onehot = torch.arange(vocab, device=dev) == draft[..., None]
    logits = torch.where(onehot, torch.zeros((), device=dev),
                         torch.full((), -1e9, device=dev))
    return draft, logits
