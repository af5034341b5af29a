"""Deterministic, seeded fault injection (the part of the JAX package's
``serving/faults.py`` that the port fires so far).

Resilience claims are untestable without a way to *cause* the failures
they guard against. A fault schedule names **sites** (places that ask
"should I fail here?") and is driven by one seeded generator, so every
chaos run is reproducible. The default, :class:`NoFaults`, is a no-op
whose ``enabled`` flag short-circuits every hook to one attribute read.

The port's sites are the transport's: ``transport_drop`` (one
``Transport.fetch``/``push`` attempt fails, exercising retry and
backoff) and ``transport_latency`` (``delay_s`` added to an attempt's
seconds, exercising timeouts). The engine's sites, the schedule grammar
and its environment variable arrive with the engine lifecycle (ROADMAP
section 1, item 5).

Usage::

    faults = Faults(seed=0).on("transport_drop", op="fetch", times=2)
    transport = RepoTransport(root, faults=faults)
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["FaultSpec", "NoFaults", "Faults", "SITES", "truncate_file"]

#: The sites the port fires.
SITES = frozenset({"transport_drop", "transport_latency"})


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. ``attempt``/``op`` are *filters* (``None`` =
    match any call of the site); ``delay_s`` is the *payload* the firing
    site consumes; ``times`` bounds how often the spec fires (-1 =
    unlimited) and ``p`` makes firing probabilistic against the
    schedule's seeded stream."""
    site: str
    attempt: Optional[int] = None   # transport-attempt filter
    op: Optional[str] = None        # transport op filter ("fetch"/"push")
    delay_s: float = 0.0            # payload: injected stall seconds
    times: int = 1                  # max firings (-1 = unlimited)
    p: float = 1.0                  # per-eligible-call fire probability
    fired: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(sites: {sorted(SITES)})")

    @property
    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times

    def matches(self, ctx: Dict[str, Any]) -> bool:
        return all(getattr(self, key) is None
                   or ctx.get(key) == getattr(self, key)
                   for key in ("attempt", "op"))


class NoFaults:
    """The default: nothing ever fires. ``enabled`` is the hot-path
    short-circuit (one attribute read per site check)."""
    enabled = False

    def fire(self, site: str, **ctx) -> Optional[FaultSpec]:
        return None

    def stats(self) -> Dict[str, float]:
        return {}


class Faults(NoFaults):
    """A seeded fault schedule. ``fire(site, **ctx)`` returns the first
    matching, non-exhausted :class:`FaultSpec` (consuming one of its
    ``times``) or ``None``. All randomness (the ``p < 1`` dice) comes
    from one seeded generator, so identical schedules replay
    identically."""
    enabled = True

    def __init__(self, seed: int = 0,
                 specs: Optional[List[FaultSpec]] = None):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs or [])
        self._rng = np.random.default_rng(self.seed)
        self.fired_total = 0
        self.fired_by_site: Dict[str, int] = {}

    def on(self, site: str, **kw) -> "Faults":
        """Schedule a fault (chainable): ``Faults().on("transport_drop",
        op="fetch").on("transport_latency", delay_s=0.2)``."""
        self.specs.append(FaultSpec(site=site, **kw))
        return self

    def fire(self, site: str, **ctx) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.site != site or spec.exhausted \
                    or not spec.matches(ctx):
                continue
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                continue
            spec.fired += 1
            self.fired_total += 1
            self.fired_by_site[site] = self.fired_by_site.get(site, 0) + 1
            return spec
        return None

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {"faults_fired_total": self.fired_total}
        for site, n in sorted(self.fired_by_site.items()):
            out[f"faults_fired_{site}"] = n
        return out


def truncate_file(path, keep_frac: float = 0.5) -> int:
    """Chop a file to ``keep_frac`` of its bytes (a crash mid-write or a
    partial transfer). Returns the new size."""
    p = Path(path)
    size = p.stat().st_size
    keep = max(0, int(size * keep_frac))
    with open(p, "r+b") as fh:
        fh.truncate(keep)
    return keep
