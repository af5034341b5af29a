"""Fault-tolerant multi-replica serving fleet (the port's own copy of the
JAX package's ``serving/fleet.py``, the same behaviour line for line).

:class:`Fleet` runs N :class:`~repro_torch.serving.engine.Engine`
replicas behind the engine's own ``submit`` / ``tick`` / ``poll`` facade
and turns one fragile engine into a service that survives replica
failure:

* **Health model**: each replica carries a liveness state machine
  (``healthy -> degraded -> dead``, plus ``draining -> drained`` for
  rolling restarts) driven by tick progress and a tick-wall EWMA: a tick
  whose wall blows past ``degrade_factor x`` the EWMA marks the replica
  degraded (routed around, still serving); ``hang_ticks`` consecutive
  ticks with work but no progress, or past the optional
  ``tick_budget_s`` watchdog, declare it dead.
* **Failover by replay**: the fleet keeps a request journal (the
  original prompt plus every token already delivered). When a replica
  dies its in-flight requests are rebuilt from the journal and
  resubmitted to a survivor as ``prompt + delivered_tokens`` with the
  remaining token budget, the replay the engine's own preemption resume
  uses; no request is silently lost.
* **Routing**: ``serving/router.py``: prefix affinity first, healthy
  before degraded, least loaded, and a per-replica circuit breaker that
  sheds to the fleet queue while open.
* **Hedging**: an unstarted request that has waited longer than the
  fleet's observed p99 TTFT (or ``hedge_delay_s``) is copied to a second
  replica; the first copy to produce a token is *bound* and the other is
  cancelled through the idempotent ``Engine.cancel``. Tokens are only
  ever copied from the bound assignment, so each is delivered once.
* **Drain / rejoin**: ``drain(rid)`` stops new dispatches and lets the
  replica finish its streams (``draining -> drained``); ``rejoin(rid)``
  builds a fresh engine in its place (also how a dead replica returns).

Fleet fault sites (registered into the ``serving/faults.py`` catalogue):
``replica_crash`` (kill replica ``/rid`` at fleet tick ``@n``),
``replica_hang`` (the replica stops making progress until the watchdog
declares it dead), ``router_drop`` (a routed submit is lost in flight;
the fleet's probe notices the journal entry missing from the replica and
redispatches). The same seeded ``Faults`` schedule drives the engine
sites inside every replica.

On one device the replicas share it: every replica is an ``Engine`` on
``model.device`` over the one ``params`` tree (the weights are held
once); each owns its cache, step programs (on the card, CUDA graphs from
its own graph pool), generator and prefix cache. The fleet ticks them
one after another, and each ``Engine.tick`` ends in a device sync, so
one replica's burst is on the device at a time and a tick's wall, which
the health model reads, holds that replica's device work. The fleet
reads only host state (``Response`` objects, ``engine.responses``, the
engine queues): it adds no device read, no sync and no capture of its
own.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving import faults as faults_mod
from repro_torch.serving import telemetry
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Response
from repro_torch.serving.router import Router

__all__ = ["Fleet", "Replica", "HEALTHY", "DEGRADED", "DEAD",
           "DRAINING", "DRAINED", "FLEET_SITES"]

# replica health states (gauge encoding in parentheses)
HEALTHY = "healthy"      # (0) full service
DEGRADED = "degraded"    # (1) serving, routed around when possible
DEAD = "dead"            # (2) failed over, awaiting rejoin
DRAINING = "draining"    # (3) no new work, finishing its streams
DRAINED = "drained"      # (4) empty and parked, awaiting rejoin
_HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, DEAD: 2, DRAINING: 3,
                DRAINED: 4}

FLEET_SITES = ("replica_crash", "replica_hang", "router_drop")
for _s in FLEET_SITES:
    faults_mod.register_site(_s)


class Replica:
    """One engine plus its health bookkeeping. A dead or drained replica
    keeps its engine, whose stats and trace ``latency_stats`` and
    ``export_trace`` still read, so its device memory (cache, graphs,
    graph pool) stays held until ``Fleet.rejoin`` replaces and frees
    it."""

    def __init__(self, rid: int, engine: Engine):
        self.rid = rid
        self.engine: Optional[Engine] = engine
        self.state = HEALTHY
        self.ewma_s: Optional[float] = None   # per-tick wall EWMA
        self.ticks = 0
        self.stall_strikes = 0    # consecutive no-progress ticks
        self.overruns = 0         # wall-budget blowouts (lifetime)
        self.hung = False         # replica_hang fault in effect
        self.death_reason = ""

    @property
    def alive(self) -> bool:
        return self.state in (HEALTHY, DEGRADED, DRAINING)

    @property
    def routable(self) -> bool:
        return self.state in (HEALTHY, DEGRADED)


@dataclass
class _Assignment:
    """One copy of a request living on one replica."""
    rid: int
    base: int                 # fleet tokens already delivered at dispatch
    dispatched_s: float
    hedge: bool = False
    dropped: bool = False     # lost/cancelled/failed over: ignore it


@dataclass
class _Entry:
    """Journal record: everything needed to replay the request."""
    req: Request
    resp: Response
    assigns: List[_Assignment] = field(default_factory=list)
    bound: Optional[int] = None   # rid whose copy owns the output stream

    @property
    def live(self) -> List[_Assignment]:
        return [a for a in self.assigns if not a.dropped]


class Fleet:
    """N engine replicas behind one ``submit``/``tick``/``poll`` facade
    (see the module docstring for the resilience model).

    ``engine_kwargs`` is forwarded to every replica's ``Engine(...)``;
    ``faults`` (a schedule, a spec string, or ``None`` for the
    environment's) drives the fleet sites here and the engine sites in
    every replica; ``trace=True`` gives each replica a tracing recorder
    and enables the merged ``export_trace``."""

    def __init__(self, model, params, *, replicas: int = 2,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 hedge: bool = False,
                 hedge_delay_s: Optional[float] = None,
                 hedge_min_wait_s: float = 0.05,
                 ewma_alpha: float = 0.3, degrade_factor: float = 4.0,
                 hang_ticks: int = 5,
                 tick_budget_s: Optional[float] = None,
                 max_outstanding: Optional[int] = None,
                 affinity_tokens: int = 16,
                 breaker_threshold: int = 3, breaker_cooldown: int = 8,
                 faults: Any = None, trace: bool = False):
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        self._t0 = time.perf_counter()
        self.model, self.params = model, params
        self.engine_kwargs = dict(engine_kwargs or {})
        self.engine_kwargs.pop("recorder", None)
        self.trace = bool(trace)

        if faults is None:
            faults = faults_mod.from_env()
        elif isinstance(faults, str):
            faults = faults_mod.Faults.parse(faults)
        self.faults = faults or faults_mod.NoFaults()

        self.hedge = bool(hedge)
        self.hedge_delay_s = hedge_delay_s
        self.hedge_min_wait_s = float(hedge_min_wait_s)
        self.ewma_alpha = float(ewma_alpha)
        self.degrade_factor = float(degrade_factor)
        self.hang_ticks = max(1, int(hang_ticks))
        self.tick_budget_s = tick_budget_s

        self.router = Router(affinity_tokens=affinity_tokens,
                             breaker_threshold=breaker_threshold,
                             breaker_cooldown=breaker_cooldown)
        self.metrics = telemetry.MetricsRegistry()
        self._c = {name: self.metrics.counter(name) for name in (
            "dispatches", "failovers", "requests_migrated",
            "hedges_issued", "hedges_won", "hedges_wasted",
            "router_drops", "redispatches", "replica_deaths",
            "drains", "rejoins", "fleet_timeouts",
            "fleet_cancellations", "fleet_errors")}
        self._ttft = self.metrics.histogram("fleet_ttft_s")
        self.metrics.add_collector(self.router.stats)
        if self.faults.enabled:
            self.metrics.add_collector(self.faults.stats)

        self.replicas: List[Replica] = [
            Replica(rid, self._new_engine()) for rid in range(replicas)]
        self._entries: Dict[int, _Entry] = {}
        self.queue: deque = deque()       # uids awaiting dispatch
        self._ticks = 0
        self._starved = 0                 # ticks with work but no capacity
        self._events: List[Dict[str, Any]] = []   # fleet trace lane
        if max_outstanding is None:
            mb = int(self.engine_kwargs.get("max_batch", 8))
            max_outstanding = 2 * mb
        self.max_outstanding = max(1, int(max_outstanding))
        self._refresh_gauges()

    # ---------------------------------------------------------------- #
    # construction / lifecycle
    # ---------------------------------------------------------------- #
    def _new_engine(self) -> Engine:
        return Engine(self.model, self.params,
                      faults=self.faults if self.faults.enabled
                      else faults_mod.NoFaults(),
                      recorder=self.trace, **self.engine_kwargs)

    def _event(self, name: str, **args) -> None:
        self._events.append({"ts": time.perf_counter(), "name": name,
                             "args": args})

    def replica(self, rid: int) -> Replica:
        if not 0 <= rid < len(self.replicas):
            raise ValueError(f"no replica {rid} "
                             f"(fleet size {len(self.replicas)})")
        return self.replicas[rid]

    def drain(self, rid: int) -> None:
        """Stop routing new work to ``rid``; its live streams finish in
        place, then the replica parks as ``drained`` (rolling-restart
        half one; ``rejoin`` is half two)."""
        r = self.replica(rid)
        if not r.alive:
            raise ValueError(f"replica {rid} is {r.state}: cannot drain")
        if r.state != DRAINING:
            r.state = DRAINING
            self._c["drains"].inc()
            self._event("drain", rid=rid)
            self._refresh_gauges()

    def rejoin(self, rid: int) -> None:
        """Bring a dead or drained replica back with a **fresh** engine
        (rolling-restart semantics: the old cache state is gone, the
        breaker closes, its affinity hints were already dropped). The
        replaced engine is released first (``Engine._release``) and the
        fleet keeps no reference to it, so its cache, CUDA graphs and
        graph pool are freed before the new engine allocates its own."""
        r = self.replica(rid)
        if r.alive and r.state != DRAINING:
            raise ValueError(f"replica {rid} is {r.state}: nothing to "
                             "rejoin")
        if r.engine is not None:
            r.engine._release()
        r.engine = None           # the last reference: its memory goes now
        r.engine = self._new_engine()
        r.state = HEALTHY
        r.ewma_s, r.ticks = None, 0
        r.stall_strikes, r.hung, r.death_reason = 0, False, ""
        self.router.breaker(rid).reset()
        self._c["rejoins"].inc()
        self._event("rejoin", rid=rid)
        self._refresh_gauges()

    def _kill(self, rid: int, why: str) -> None:
        r = self.replicas[rid]
        if r.state == DEAD:
            return
        r.state = DEAD
        r.death_reason = why
        self._c["replica_deaths"].inc()
        self.router.breaker(rid).force_open()
        self.router.forget_replica(rid)
        self._event("replica_dead", rid=rid, why=why)
        self._failover(rid)
        self._refresh_gauges()

    # ---------------------------------------------------------------- #
    # public request API (mirrors Engine)
    # ---------------------------------------------------------------- #
    @property
    def responses(self) -> Dict[int, Response]:
        return {uid: e.resp for uid, e in self._entries.items()}

    @property
    def has_work(self) -> bool:
        return any(not e.resp.finished for e in self._entries.values())

    def submit(self, req: Request) -> None:
        """Validate and journal a request; dispatch happens on the next
        ``tick``. Raises ``ValueError`` for malformed requests (the same
        host-boundary contract as ``Engine.submit``)."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"request {req.uid}: prompt must be a "
                             f"non-empty 1-D token array, got shape "
                             f"{prompt.shape}")
        if prompt.dtype.kind not in "iu":
            raise ValueError(f"request {req.uid}: prompt must hold "
                             f"integer token ids, got {prompt.dtype}")
        if req.max_new_tokens <= 0:
            raise ValueError(f"request {req.uid}: max_new_tokens must "
                             f"be positive, got {req.max_new_tokens}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(f"request {req.uid}: deadline_s must be "
                             f"positive, got {req.deadline_s}")
        old = self._entries.get(req.uid)
        if old is not None and not old.resp.finished:
            raise ValueError(f"request uid {req.uid} is already in "
                             "flight")
        req.submitted_s = time.perf_counter()
        self._entries[req.uid] = _Entry(
            req=req, resp=Response(uid=req.uid,
                                   prompt_len=int(prompt.size)))
        self.queue.append(req.uid)

    def cancel(self, uid: int) -> bool:
        """Cancel in any live state (idempotent: unknown or finished uids
        return ``False``). Live copies on replicas are cancelled through
        ``Engine.cancel``; tokens already delivered stay in the
        response."""
        e = self._entries.get(uid)
        if e is None or e.resp.finished:
            return False
        if uid in self.queue:
            self.queue.remove(uid)
        for a in e.live:
            r = self.replicas[a.rid]
            if r.alive and r.engine is not None:
                r.engine.cancel(uid)
            a.dropped = True
        self._finish(e, "cancelled")
        self._c["fleet_cancellations"].inc()
        return True

    # ---------------------------------------------------------------- #
    # the tick pipeline
    # ---------------------------------------------------------------- #
    def tick(self, steps: Optional[int] = None) -> int:
        """Advance the fleet: sweep fleet-queue deadlines, fire fleet
        faults, detect lost dispatches, dispatch and hedge, tick every
        live replica (wall-timed for the health model), harvest tokens,
        settle drains. Returns the engine steps made this tick."""
        self._ticks += 1
        now = time.perf_counter()
        self._sweep_queue_deadlines(now)
        self._fire_fleet_faults()
        self.router.tick()
        self._probe_drops()
        self._dispatch_pass(now)
        made = self._tick_replicas(steps)
        self._harvest()
        self._settle_drains()
        self._starvation_valve()
        self._refresh_gauges()
        return made

    def poll(self) -> Dict[int, Response]:
        """Harvest without advancing: copy any freshly produced tokens
        out of the replicas into the fleet responses."""
        self._harvest()
        return self.responses

    def run(self, max_steps: int = 100_000,
            sync_every: Optional[int] = None) -> Dict[int, Response]:
        steps = 0
        while self.has_work and steps < max_steps:
            steps += max(1, self.tick(sync_every))
        return self.responses

    # -- deadline sweep (fleet queue: never admitted anywhere) -------- #
    def _sweep_queue_deadlines(self, now: float) -> None:
        for uid in [u for u in self.queue
                    if self._entries[u].req.deadline_abs() <= now]:
            self.queue.remove(uid)
            self._finish(self._entries[uid], "timeout")
            self._c["fleet_timeouts"].inc()

    # -- fleet fault sites ------------------------------------------- #
    def _fire_fleet_faults(self) -> None:
        if not self.faults.enabled:
            return
        spec = self.faults.fire("replica_crash", step=self._ticks)
        if spec is not None:
            rid = spec.slot if spec.slot is not None else next(
                (r.rid for r in self.replicas if r.alive), None)
            if rid is not None and self.replicas[rid].alive:
                self._event("fault_replica_crash", rid=rid,
                            tick=self._ticks)
                self._kill(rid, "crash")
        spec = self.faults.fire("replica_hang", step=self._ticks)
        if spec is not None:
            rid = spec.slot if spec.slot is not None else next(
                (r.rid for r in self.replicas if r.alive), None)
            if rid is not None and self.replicas[rid].alive:
                self.replicas[rid].hung = True
                self._event("fault_replica_hang", rid=rid,
                            tick=self._ticks)

    # -- lost-dispatch probe ----------------------------------------- #
    def _probe_drops(self) -> None:
        """A dispatch can be lost in flight (``router_drop``): the
        journal says the request lives on replica ``rid`` but the replica
        has never heard of the uid. Drop the assignment and requeue at
        the front (a redispatch, not a new arrival)."""
        for uid, e in self._entries.items():
            if e.resp.finished:
                continue
            for a in e.live:
                r = self.replicas[a.rid]
                if not r.alive or r.engine is None:
                    continue
                if uid not in r.engine.responses:
                    a.dropped = True
                    self._c["router_drops"].inc()
                    if e.bound == a.rid:
                        e.bound = None
                    if not e.live and uid not in self.queue:
                        self.queue.appendleft(uid)
                        self._c["redispatches"].inc()
                        self._event("redispatch", uid=uid, rid=a.rid)

    # -- failover ----------------------------------------------------- #
    def _failover(self, rid: int) -> None:
        """Rebuild the dead replica's in-flight requests from the
        journal: every unfinished entry whose only live copy was on
        ``rid`` goes back to the *front* of the fleet queue and is
        redispatched as prompt + delivered tokens (resume by replay)."""
        moved = 0
        for uid, e in self._entries.items():
            if e.resp.finished:
                continue
            touched = False
            for a in e.live:
                if a.rid == rid:
                    a.dropped = True
                    touched = True
            if not touched:
                continue
            if e.bound == rid:
                e.bound = None       # a surviving hedge may now bind
            if not e.live and uid not in self.queue:
                self.queue.appendleft(uid)
                e.req.preemptions += 1
                moved += 1
        if moved:
            self._c["requests_migrated"].inc(moved)
        self._c["failovers"].inc()
        self._event("failover", rid=rid, migrated=moved)

    # -- dispatch + hedging ------------------------------------------- #
    def _outstanding(self, rid: int) -> int:
        return sum(1 for e in self._entries.values()
                   if not e.resp.finished
                   for a in e.live if a.rid == rid)

    def _candidates(self) -> List[tuple]:
        cands = []
        for r in self.replicas:
            if not r.routable or r.engine is None:
                continue
            out = self._outstanding(r.rid)
            if out >= self.max_outstanding:
                continue
            rank = 0 if r.state == HEALTHY else 1
            cands.append((r.rid, rank, out + len(r.engine.queue)))
        return cands

    def _dispatch(self, e: _Entry, rid: int, hedge: bool) -> bool:
        """Submit one copy of the journal entry to replica ``rid``,
        replaying any already-delivered tokens as a prompt suffix."""
        r = self.replicas[rid]
        delivered = len(e.resp.tokens)
        prompt = np.asarray(e.req.prompt)
        if delivered:
            prompt = np.concatenate(
                [prompt, np.asarray(e.resp.tokens, prompt.dtype)])
        now = time.perf_counter()
        remaining = e.req.deadline_abs() - now
        if remaining <= 0:
            self._finish(e, "timeout")
            self._c["fleet_timeouts"].inc()
            return False
        copy = Request(
            uid=e.req.uid, prompt=prompt,
            max_new_tokens=e.req.max_new_tokens - delivered,
            eos_id=e.req.eos_id, embeddings=e.req.embeddings,
            deadline_s=None if e.req.deadline_s is None else remaining,
            priority=e.req.priority)
        if self.faults.enabled and not hedge and self.faults.fire(
                "router_drop", step=self._ticks) is not None:
            # the submit is lost in flight: the journal says rid, the
            # replica never hears of it; the probe notices and redispatches
            e.assigns.append(_Assignment(rid=rid, base=delivered,
                                         dispatched_s=now, hedge=hedge))
            self._event("router_drop", uid=e.req.uid, rid=rid)
            return True
        try:
            r.engine.submit(copy)
        except ValueError as err:
            # a replay that no longer fits this replica (or malformed
            # growth) must not wedge the fleet: fail the request loudly
            self._finish(e, "error")
            self._c["fleet_errors"].inc()
            self._event("dispatch_error", uid=e.req.uid, rid=rid,
                        err=str(err))
            return False
        e.assigns.append(_Assignment(rid=rid, base=delivered,
                                     dispatched_s=now, hedge=hedge))
        self.router.note_dispatch(e.req.prompt, rid)
        self._c["dispatches"].inc()
        return True

    def _dispatch_pass(self, now: float) -> None:
        guard = len(self.queue)
        while self.queue and guard > 0:
            guard -= 1
            uid = self.queue[0]
            e = self._entries[uid]
            if e.resp.finished:
                self.queue.popleft()
                continue
            rid = self.router.route(
                e.req.prompt, self._candidates(),
                exclude=[a.rid for a in e.live])
            if rid is None:
                break                 # no capacity / breakers open: wait
            self.queue.popleft()
            self._dispatch(e, rid, hedge=False)
        if self.hedge:
            self._hedge_pass(now)

    def _hedge_delay(self) -> float:
        if self.hedge_delay_s is not None:
            return self.hedge_delay_s
        if len(self._ttft.samples) >= 8:
            return max(self.hedge_min_wait_s,
                       telemetry.percentile(self._ttft.samples, 99))
        return self.hedge_min_wait_s

    def _hedge_pass(self, now: float) -> None:
        delay = self._hedge_delay()
        for uid, e in self._entries.items():
            if e.resp.finished or e.bound is not None or e.resp.tokens:
                continue
            live = e.live
            if len(live) != 1 or live[0].hedge:
                continue
            if now - live[0].dispatched_s < delay:
                continue
            rid = self.router.route(e.req.prompt, self._candidates(),
                                    exclude=[live[0].rid])
            if rid is None:
                continue
            if self._dispatch(e, rid, hedge=True):
                self._c["hedges_issued"].inc()
                self._event("hedge", uid=uid, rid=rid)

    # -- replica ticking + health ------------------------------------- #
    def _tick_replicas(self, steps: Optional[int]) -> int:
        made = 0
        for r in self.replicas:
            if not r.alive or r.engine is None:
                continue
            if r.hung:
                # a wedged worker never returns from its tick: the
                # watchdog sees work pending and no progress
                if r.engine.has_work or self._outstanding(r.rid):
                    self._strike(r)
                continue
            had_work = r.engine.has_work
            t0 = time.perf_counter()
            n = r.engine.tick(steps)
            wall = time.perf_counter() - t0
            made += n
            r.ticks += 1
            self._health_update(r, wall, had_work, n)
        return made

    def _strike(self, r: Replica) -> None:
        r.stall_strikes += 1
        if r.stall_strikes >= self.hang_ticks:
            self._kill(r.rid, "hang")

    def _health_update(self, r: Replica, wall: float, had_work: bool,
                       n_steps: int) -> None:
        """Feed one tick's wall to ``r``'s health model. On the card the
        wall holds the replica's device work up to the tick's closing
        sync, and a first call's capture when a step program is built."""
        if had_work and n_steps == 0:
            self._strike(r)
            if not r.alive:
                return
        else:
            r.stall_strikes = 0
        if self.tick_budget_s is not None and wall > self.tick_budget_s:
            r.overruns += 1
            self._strike(r)
            if not r.alive:
                return
        prev = r.ewma_s
        a = self.ewma_alpha
        r.ewma_s = wall if prev is None else a * wall + (1 - a) * prev
        if prev is None or r.ticks < 3 or not had_work:
            return
        if wall > self.degrade_factor * prev:
            r.overruns += 1
            if r.state == HEALTHY:
                r.state = DEGRADED
                self._event("degraded", rid=r.rid, wall_s=round(wall, 6))
        elif r.state == DEGRADED and wall <= self.degrade_factor * prev:
            r.state = HEALTHY
            self._event("recovered", rid=r.rid)

    # -- harvest (exactly-once token delivery) ------------------------- #
    def _harvest(self) -> None:
        for uid, e in self._entries.items():
            if e.resp.finished:
                continue
            order = sorted(e.live, key=lambda a: a.hedge)  # primary 1st
            for a in order:
                if e.bound is not None and a.rid != e.bound:
                    continue
                r = self.replicas[a.rid]
                if not r.alive or r.engine is None:
                    continue
                er = r.engine.responses.get(uid)
                if er is None:
                    continue
                # this copy regenerated fleet tokens [base:], so only the
                # tokens past what the fleet already delivered are new
                new = er.tokens[len(e.resp.tokens) - a.base:]
                if new:
                    if e.bound is None:
                        self._bind(e, a)
                    if e.bound == a.rid:
                        first = not e.resp.tokens
                        e.resp.tokens.extend(new)
                        if first and not e.req.first_token_s:
                            e.req.first_token_s = time.perf_counter()
                            self._ttft.observe(e.req.first_token_s
                                               - e.req.submitted_s)
                if er.finished and (e.bound in (None, a.rid)):
                    self._settle_terminal(e, a, er)
                if e.resp.finished:
                    break

    def _bind(self, e: _Entry, winner: _Assignment) -> None:
        """First token wins: this copy owns the output stream from now
        on; every other live copy is cancelled (idempotent) and dropped,
        so no token is delivered twice."""
        e.bound = winner.rid
        if winner.hedge:
            self._c["hedges_won"].inc()
            self._event("hedge_won", uid=e.req.uid, rid=winner.rid)
        for a in e.live:
            if a is winner:
                continue
            r = self.replicas[a.rid]
            if r.alive and r.engine is not None:
                r.engine.cancel(e.req.uid)
            a.dropped = True
            if a.hedge:
                self._c["hedges_wasted"].inc()

    def _settle_terminal(self, e: _Entry, a: _Assignment,
                         er: Response) -> None:
        reason = er.finish_reason
        if reason in ("eos", "length"):
            if e.bound is None:
                self._bind(e, a)
            if e.bound == a.rid:
                self._finish(e, reason)
                self.router.breaker(a.rid).record_success()
            return
        if reason == "cancelled":
            a.dropped = True         # our own loser-cancel echoing back
            return
        # error / timeout on this copy: drop it; another live copy may
        # still win, otherwise the failure is the request's outcome
        a.dropped = True
        if e.bound == a.rid:
            e.bound = None
        if reason == "error":
            self.router.breaker(a.rid).record_failure()
        if not e.live:
            self._finish(e, reason)
            self._c["fleet_errors" if reason == "error"
                    else "fleet_timeouts"].inc()

    def _finish(self, e: _Entry, reason: str) -> None:
        e.resp.finished = True
        e.resp.finish_reason = reason
        e.req.finished_s = time.perf_counter()
        self._event("finish", uid=e.req.uid, reason=reason)

    # -- drain / starvation ------------------------------------------- #
    def _settle_drains(self) -> None:
        for r in self.replicas:
            if r.state != DRAINING or r.engine is None:
                continue
            if not r.engine.has_work and not self._outstanding(r.rid):
                r.state = DRAINED
                self._event("drained", rid=r.rid)

    def _starvation_valve(self) -> None:
        """Terminal backstop: when no routable replica exists, queued
        work can never be served; after ``hang_ticks`` such ticks the
        fleet fails the stuck requests loudly (finish_reason ``error``)
        instead of spinning forever. If nothing is alive, in-flight
        entries are unrecoverable too."""
        routable = any(r.routable for r in self.replicas)
        alive = any(r.alive for r in self.replicas)
        stuck = bool(self.queue) or (not alive and self.has_work)
        if routable or not stuck:
            self._starved = 0
            return
        self._starved += 1
        if self._starved < self.hang_ticks:
            return
        doomed = [self._entries[u] for u in list(self.queue)]
        self.queue.clear()
        if not alive:
            doomed += [e for e in self._entries.values()
                       if not e.resp.finished]
        for e in doomed:
            if not e.resp.finished:
                self._finish(e, "error")
                self._c["fleet_errors"].inc()

    # ---------------------------------------------------------------- #
    # stats / steady state / tracing
    # ---------------------------------------------------------------- #
    def _refresh_gauges(self) -> None:
        for r in self.replicas:
            self.metrics.gauge(f"replica_{r.rid}_health").set(
                _HEALTH_CODE[r.state])
        self.metrics.gauge("fleet_queue_depth").set(len(self.queue))
        self.metrics.gauge("fleet_inflight").set(
            sum(1 for e in self._entries.values()
                if not e.resp.finished and e.live))
        self.metrics.gauge("replicas_routable").set(
            sum(1 for r in self.replicas if r.routable))

    def reset_stats(self) -> None:
        """The fleet's ``Engine.reset_stats``: drop finished journal
        entries and the fleet metrics, and reset every live replica
        (which also arms each recompile watchdog: the steady-state
        boundary for chaos gates)."""
        self.metrics.reset()
        self.router.affinity_hits = 0
        self.router.sheds = 0
        for uid in [u for u, e in self._entries.items()
                    if e.resp.finished]:
            del self._entries[uid]
        self._events.clear()
        for r in self.replicas:
            if r.alive and r.engine is not None:
                r.engine.reset_stats()
        self._refresh_gauges()

    def mark_steady(self) -> None:
        for r in self.replicas:
            if r.alive and r.engine is not None:
                r.engine.mark_steady()

    def steady_compiles(self) -> Dict[int, int]:
        """Steady-state program builds per replica (on the card, CUDA
        graph captures after ``mark_steady``: the no-capture gate, per
        replica)."""
        out: Dict[int, int] = {}
        for r in self.replicas:
            if r.engine is not None:
                out[r.rid] = int(r.engine.metrics.snapshot()["counters"]
                                 .get("steady_compiles", 0))
        return out

    def latency_stats(self) -> Dict[str, Any]:
        """Fleet summary: the fleet counters and gauges, fleet TTFT
        percentiles, and each replica's own ``latency_stats`` under
        ``replica_{rid}``."""
        snap = self.metrics.snapshot()
        stats: Dict[str, Any] = dict(snap["counters"])
        stats.update({f"gauge_{k}": v for k, v in snap["gauges"].items()})
        telemetry.pct_stats(stats, "fleet_ttft_ms", self._ttft.samples,
                            (50, 95, 99))
        stats["n_finished"] = sum(1 for e in self._entries.values()
                                  if e.resp.finished)
        for r in self.replicas:
            if r.engine is not None:
                stats[f"replica_{r.rid}"] = r.engine.latency_stats()
            stats[f"replica_{r.rid}_state"] = r.state
        return stats

    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Merged Chrome trace: one process lane per replica (pid
        ``100 + rid``) plus a fleet lane (pid 99) of orchestration
        instants (health transitions, failovers, hedges, drains).
        Requires ``Fleet(..., trace=True)``."""
        from repro_torch.serving.tracing import merge_chrome_traces
        parts = []
        for r in self.replicas:
            exp = getattr(r.engine, "recorder", None)
            exp = getattr(exp, "export_chrome_trace", None)
            if r.engine is None or exp is None:
                continue
            off = (r.engine.recorder.t0 - self._t0) * 1e6
            parts.append((f"replica {r.rid}", 100 + r.rid, exp(), off))
        if not parts:
            raise RuntimeError("export_trace needs Fleet(..., "
                               "trace=True)")
        fleet_events = [
            {"name": ev["name"], "ph": "i",
             "ts": round((ev["ts"] - self._t0) * 1e6, 1),
             "pid": 99, "tid": 0, "s": "t", "args": ev["args"]}
            for ev in self._events]
        return merge_chrome_traces(parts, extra=fleet_events,
                                   extra_label="fleet", extra_pid=99,
                                   path=path)
