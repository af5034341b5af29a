"""Request/response dataclasses for the serving engine (the port's own
copy of the JAX package's ``serving/request.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass(eq=False)
class Request:
    # eq=False: identity equality. The generated __eq__ would compare the
    # numpy prompt fields and raise "truth value is ambiguous" the moment
    # two distinct Request objects meet in a container operation
    # (deque.remove/`in` during cancel or preemptive requeue).
    uid: int
    prompt: np.ndarray              # (L,) int32 token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    embeddings: Optional[np.ndarray] = None  # vlm/audio frontend output

    # --- lifecycle control (serving resilience) ------------------- #
    deadline_s: Optional[float] = None  # wall-clock budget from submit;
    # enforced at poll boundaries: an expired request finishes with
    # finish_reason "timeout" (keeping any tokens already produced)
    priority: int = 0               # higher preempts lower when slots or
    # KV pages run short (victim = lowest priority, then latest deadline)

    submitted_s: float = 0.0
    started_s: float = 0.0          # prefill dispatched
    first_token_s: float = 0.0      # first token available on host
    finished_s: float = 0.0
    preemptions: int = 0            # times evicted-and-requeued; resumed
    # streams replay their generated prefix, so output is unaffected

    def deadline_abs(self) -> float:
        """Absolute ``perf_counter`` deadline (+inf when none)."""
        if self.deadline_s is None:
            return float("inf")
        return self.submitted_s + self.deadline_s


#: Finish reasons a Response can carry. "eos"/"length" are the normal
#: completions; the rest are resilience outcomes (docs/robustness.md).
FINISH_REASONS = ("eos", "length", "cancelled", "timeout", "error")


@dataclass
class Response:
    uid: int
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    prompt_len: int = 0
    finish_reason: str = ""         # one of FINISH_REASONS, or ""
    # "" while still running. "cancelled"/"timeout"/"error" responses
    # keep the tokens produced before the event (partial output).

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def ok(self) -> bool:
        """Finished normally (eos or length budget)."""
        return self.finished and self.finish_reason in ("eos", "length")
