"""Deterministic, seeded fault injection for the serving stack (the
port's own copy of the JAX package's ``serving/faults.py``).

Resilience claims are untestable without a way to *cause* the failures
they guard against. This module is the single fault switchboard: a
registry of named **sites** (places in the engine, transport and
checkpoint layers that ask "should I fail here?") driven by a seeded
schedule, so every chaos run is reproducible.

The default, :class:`NoFaults`, is a no-op whose ``enabled`` flag
short-circuits every hook to one attribute read, so an engine built
without faults runs the same step programs, gives the same outputs and
builds the same programs as one built with an empty schedule. Injection
never changes a program: the NaN site writes into the engine's
always-present poison buffer, which every step program reads (on the
card, inside its CUDA graph).

Fault sites
-----------
``page_alloc``           one KV page-pool allocation reports exhaustion
                         (the engine degrades: poll, then preemptive
                         requeue, never a crash mid-decode);
``nan_logits``           slot ``k``'s sampler logits are poisoned to NaN
                         at engine step ``n`` (the on-device guard must
                         contain it to that slot);
``slow_step``            ``delay_s`` of host stall before a step
                         dispatch (exercises deadline enforcement);
``transport_drop``       one ``Transport.fetch``/``push`` attempt fails
                         (exercises retry and backoff);
``transport_latency``    ``delay_s`` added to a transfer's modelled
                         seconds (exercises timeouts);
``truncated_checkpoint`` a just-written checkpoint loses its tail
                         (``truncate_file``; exercises fail-fast load
                         validation).

Other layers register their own sites into the same catalogue through
:func:`register_site`. Unknown site names raise ``ValueError`` naming the
nearest registered site.

Usage::

    faults = (Faults(seed=0)
              .on("nan_logits", step=12, slot=1)
              .on("page_alloc", step=30, times=2))
    eng = Engine(model, params, faults=faults)

or through the environment (read when ``Engine(faults=None)``)::

    REPRO_FAULTS="nan_logits@12/1,page_alloc@30x2,slow_step@5+0.05"

Grammar: comma-separated ``site[@step][/slot][xN][+delay][%prob]``.
The dice of a ``%prob`` schedule come from ``np.random.default_rng(seed)``
as in the JAX package, so one schedule fires at the same calls in both.
"""
from __future__ import annotations

import dataclasses
import difflib
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["FaultSpec", "NoFaults", "Faults", "SITES", "register_site",
           "known_sites", "truncate_file", "from_env", "ENV_VAR"]

ENV_VAR = "REPRO_FAULTS"

#: The registered site catalogue: every schedule (a string, ``Faults.on``
#: calls or the environment) validates against it, so a typo like
#: ``nan_logit`` fails fast, naming the nearest known site.
SITES = {
    "page_alloc", "nan_logits", "slow_step",
    "transport_drop", "transport_latency", "truncated_checkpoint",
}

_SPEC = re.compile(
    r"^(?P<site>[a-z][a-z0-9_]*)"
    r"(?:@(?P<step>\d+))?"
    r"(?:/(?P<slot>\d+))?"
    r"(?:x(?P<times>-?\d+))?"
    r"(?:\+(?P<delay>[0-9.]+))?"
    r"(?:%(?P<p>[0-9.]+))?$")


def register_site(name: str) -> str:
    """Add a fault site to the catalogue (idempotent). Subsystems that
    fire their own sites register them at import, so ``Faults.parse``
    and ``Faults.on`` validate against the full set."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"bad fault site name {name!r} "
                         "(want lowercase_snake_case)")
    SITES.add(name)
    return name


def known_sites() -> frozenset:
    """Snapshot of the currently registered site catalogue."""
    return frozenset(SITES)


def _unknown_site_error(name: str) -> ValueError:
    near = difflib.get_close_matches(name, sorted(SITES), n=1, cutoff=0.5)
    hint = f"; did you mean {near[0]!r}?" if near else ""
    return ValueError(f"unknown fault site {name!r}{hint} "
                      f"(registered sites: {sorted(SITES)})")


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. ``step``/``attempt``/``op`` are *filters*
    (``None`` = match any call of the site); ``slot`` and ``delay_s``
    are *payloads* the firing site consumes; ``times`` bounds how often
    the spec fires (-1 = unlimited) and ``p`` makes firing probabilistic
    against the schedule's seeded stream.

    ``step`` matches *at or after*: the spec fires on the first site
    call whose step is >= the scheduled one, bounded by ``times``."""
    site: str
    step: Optional[int] = None      # engine-step filter
    attempt: Optional[int] = None   # transport-attempt filter
    op: Optional[str] = None        # transport op filter ("fetch"/"push")
    slot: Optional[int] = None      # payload: target batch slot
    delay_s: float = 0.0            # payload: injected stall seconds
    times: int = 1                  # max firings (-1 = unlimited)
    p: float = 1.0                  # per-eligible-call fire probability
    fired: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise _unknown_site_error(self.site)

    @property
    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if self.step is not None:
            got = ctx.get("step")
            if got is None or got < self.step:
                return False
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
    from one seeded generator, and the engine calls sites in a fixed
    host order, so identical schedules replay identically."""
    enabled = True

    def __init__(self, seed: int = 0,
                 specs: Optional[List[FaultSpec]] = None):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs or [])
        self._rng = np.random.default_rng(self.seed)
        self.fired_total = 0
        self.fired_by_site: Dict[str, int] = {}

    def on(self, site: str, **kw) -> "Faults":
        """Schedule a fault (chainable): ``Faults().on("nan_logits",
        step=12, slot=1).on("page_alloc", times=2)``."""
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

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "Faults":
        """Parse the compact schedule grammar (see the module docstring):
        comma-separated ``site[@step][/slot][xN][+delay][%prob]``."""
        f = cls(seed=seed)
        for entry in filter(None, (e.strip() for e in text.split(","))):
            m = _SPEC.match(entry)
            if m is None:
                raise ValueError(f"bad fault spec {entry!r} (grammar: "
                                 "site[@step][/slot][xN][+delay][%prob])")
            g = m.groupdict()
            f.on(g["site"],
                 step=None if g["step"] is None else int(g["step"]),
                 slot=None if g["slot"] is None else int(g["slot"]),
                 times=1 if g["times"] is None else int(g["times"]),
                 delay_s=float(g["delay"] or 0.0),
                 p=float(g["p"] or 1.0))
        return f


def from_env(env: Optional[Dict[str, str]] = None):
    """The ambient fault schedule: ``REPRO_FAULTS`` parsed when set
    (``REPRO_FAULTS_SEED`` seeds it), else :class:`NoFaults`."""
    e = os.environ if env is None else env
    text = e.get(ENV_VAR, "")
    if not text:
        return NoFaults()
    return Faults.parse(text, seed=int(e.get(ENV_VAR + "_SEED", "0")))


def truncate_file(path, keep_frac: float = 0.5) -> int:
    """The ``truncated_checkpoint`` fault's effect: chop a file to
    ``keep_frac`` of its bytes (a crash mid-write or a partial
    transfer). Returns the new size."""
    p = Path(path)
    size = p.stat().st_size
    keep = max(0, int(size * keep_frac))
    with open(p, "r+b") as fh:
        fh.truncate(keep)
    return keep
