"""Replica selection for the serving fleet: prefix affinity, load, breakers
(the port's own copy of the JAX package's ``serving/router.py``, standard
library only, the same behaviour line for line).

The :class:`Router` answers one question for ``serving/fleet.py``: which
replica should serve this request now? Its policy, in priority order:

1. **Prefix affinity**: a request whose prompt head was already served by
   some replica routes back to it (the replica's prefix cache holds that
   KV, so admission copies or aliases it instead of recomputing). The
   affinity key is the first ``affinity_tokens`` prompt tokens; the map
   is written on every successful dispatch.
2. **Health ranking**: healthy replicas before degraded ones; dead or
   draining replicas and replicas whose circuit breaker is open are
   never candidates (their traffic waits in the fleet queue).
3. **Least loaded**: among equally ranked candidates the one with the
   fewest outstanding streams wins, ties broken on the replica id, so a
   deterministic arrival order routes deterministically.

The :class:`CircuitBreaker` is the three-state machine: closed, open on
``failure_threshold`` consecutive failures, half-open after
``cooldown_ticks`` fleet ticks, closed again on one success and reopened
on one failure. The fleet records a failure when a replica stream errors
or the replica dies, and a success on every normal completion.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["CircuitBreaker", "Router"]


class CircuitBreaker:
    """Per-replica failure breaker, advanced by fleet ticks (not wall
    time: ticks are the fleet's deterministic clock)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 cooldown_ticks: int = 8):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_ticks = max(1, int(cooldown_ticks))
        self.state = self.CLOSED
        self.failures = 0          # consecutive failures while closed
        self._cooldown = 0
        self.opens = 0             # lifetime open transitions

    def record_failure(self) -> None:
        if self.state == self.HALF_OPEN:
            self._trip()
            return
        self.failures += 1
        if self.state == self.CLOSED \
                and self.failures >= self.failure_threshold:
            self._trip()

    def record_success(self) -> None:
        self.failures = 0
        if self.state == self.HALF_OPEN:
            self.state = self.CLOSED

    def force_open(self) -> None:
        """Trip unconditionally (replica declared dead)."""
        self._trip()

    def _trip(self) -> None:
        if self.state != self.OPEN:
            self.opens += 1
        self.state = self.OPEN
        self._cooldown = self.cooldown_ticks
        self.failures = 0

    def tick(self) -> None:
        """One fleet tick elapsed: an open breaker cools toward half-open
        (one probe request allowed through)."""
        if self.state == self.OPEN:
            self._cooldown -= 1
            if self._cooldown <= 0:
                self.state = self.HALF_OPEN

    @property
    def allows(self) -> bool:
        return self.state != self.OPEN

    def reset(self) -> None:
        """Back to closed (replica rejoined with a fresh engine)."""
        self.state = self.CLOSED
        self.failures = 0
        self._cooldown = 0


class Router:
    """Prefix-affinity and least-loaded replica selection (policy above).

    Pure host bookkeeping: the fleet passes candidate ``(rid, rank,
    load)`` tuples each dispatch (rank 0 healthy, 1 degraded; dead and
    draining replicas are never offered) and gets the chosen rid back, or
    ``None`` when every candidate's breaker is open."""

    def __init__(self, affinity_tokens: int = 16,
                 breaker_threshold: int = 3, breaker_cooldown: int = 8):
        self.affinity_tokens = max(1, int(affinity_tokens))
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._bt = breaker_threshold
        self._bc = breaker_cooldown
        # affinity key (prompt-head tuple) -> rid of the last dispatch
        self.affinity: Dict[Tuple[int, ...], int] = {}
        self.affinity_hits = 0
        self.sheds = 0             # dispatches refused (breakers open)

    def breaker(self, rid: int) -> CircuitBreaker:
        b = self._breakers.get(rid)
        if b is None:
            b = self._breakers[rid] = CircuitBreaker(self._bt, self._bc)
        return b

    def tick(self) -> None:
        for b in self._breakers.values():
            b.tick()

    def key(self, prompt) -> Tuple[int, ...]:
        return tuple(int(t) for t in prompt[: self.affinity_tokens])

    def route(self, prompt,
              candidates: Sequence[Tuple[int, int, int]],
              exclude: Iterable[int] = ()) -> Optional[int]:
        """Pick a replica for ``prompt`` from ``candidates`` (tuples of
        ``(rid, rank, load)``), skipping ``exclude`` (rids that already
        hold a live copy of this request: hedges and failover must land
        elsewhere). Returns ``None`` when nothing is routable."""
        excl = set(exclude)
        open_cands = [(rid, rank, load) for rid, rank, load in candidates
                      if rid not in excl and self.breaker(rid).allows]
        if not open_cands:
            if any(rid not in excl for rid, _, _ in candidates):
                self.sheds += 1
            return None
        want = self.affinity.get(self.key(prompt))
        if want is not None:
            for rid, _, _ in open_cands:
                if rid == want:
                    self.affinity_hits += 1
                    return rid
        return min(open_cands, key=lambda c: (c[1], c[2], c[0]))[0]

    def note_dispatch(self, prompt, rid: int) -> None:
        """Record where this prompt head now lives (its prefix KV)."""
        self.affinity[self.key(prompt)] = rid

    def forget_replica(self, rid: int) -> None:
        """Drop the affinity entries of a dead or rebuilt replica: its
        prefix cache is gone, so the hint would only mislead."""
        self.affinity = {k: v for k, v in self.affinity.items()
                         if v != rid}

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "affinity_hits": self.affinity_hits,
            "affinity_entries": len(self.affinity),
            "router_sheds": self.sheds,
        }
        for rid, b in sorted(self._breakers.items()):
            out[f"breaker_{rid}_state"] = b.state
            out[f"breaker_{rid}_opens"] = b.opens
        return out
