"""Synthetic data pipeline: the port's own copy of the JAX package's
``data/pipeline.py``, numpy only, so both packages yield the same batches
from one seed.

No corpus is shipped; the language is a *learnable* synthetic one: a
fixed random first-order Markov chain over the vocabulary with low
entropy. A model that trains correctly drives its loss well below the
unigram entropy, toward ``MarkovLM.entropy_bound``. Documents are packed
into fixed-length rows (``pack_documents``) and served by an infinite
batch iterator (``synthetic_batches``, ``batches_for``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    vocab: int
    branching: int = 8          # out-degree a state: entropy ~ log(branching)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(
            0, self.vocab, size=(self.vocab, self.branching))
        probs = rng.dirichlet(np.ones(self.branching), size=self.vocab)
        self.next_probs = probs

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        tok = int(rng.integers(self.vocab))
        for i in range(length):
            out[i] = tok
            j = rng.choice(self.branching, p=self.next_probs[tok])
            tok = int(self.next_tokens[tok, j])
        return out

    def entropy_bound(self) -> float:
        """Per-token conditional entropy (nats): the loss floor."""
        ent = -np.sum(self.next_probs * np.log(self.next_probs + 1e-12),
                      axis=1)
        return float(np.mean(ent))


def pack_documents(docs, seq_len: int) -> np.ndarray:
    """Concatenate token streams and cut them into (N, seq_len) rows."""
    flat = np.concatenate(docs)
    n = len(flat) // seq_len
    return flat[: n * seq_len].reshape(n, seq_len)


def synthetic_batches(vocab: int, batch: int, seq_len: int, *,
                      seed: int = 0, branching: int = 8,
                      frontend: Optional[dict] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {'tokens': (B, L) int32 [, 'embeddings' (B,
    n_tokens, d_embed) f32]}."""
    lm = MarkovLM(vocab, branching=branching, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = np.stack([lm.sample(rng, seq_len) for _ in range(batch)])
        out = {"tokens": toks.astype(np.int32)}
        if frontend is not None:
            out["embeddings"] = rng.normal(
                0, 1, size=(batch, frontend["n_tokens"], frontend["d_embed"])
            ).astype(np.float32)
        yield out


def batches_for(cfg, batch: int, seq_len: int, seed: int = 0):
    """Shape-aware iterator for a ModelConfig: a VLM's frontend prefix
    takes its positions out of ``seq_len``; a frontend adds embeddings."""
    fe = cfg.frontend
    if fe is not None and cfg.family == "vlm":
        seq_len = seq_len - fe.n_tokens
    frontend = None if fe is None else {"n_tokens": fe.n_tokens,
                                        "d_embed": fe.d_embed}
    return synthetic_batches(cfg.vocab, batch, seq_len, seed=seed,
                             frontend=frontend)
