"""Request-lifecycle tracing: Chrome trace-event export for serving runs
(the port's own copy of the JAX package's ``serving/tracing.py``).

:class:`Tracer` is the recording :class:`~repro_torch.serving.telemetry.
Recorder`: the engine feeds it span events for every request (enqueued,
admission chunks, first token, per-poll emissions, finished or evicted),
finalised per-step timings, poll-time pool samples and step-program
builds, all host-side with ``time.perf_counter`` timestamps.
``export_chrome_trace`` renders the run as Chrome trace-event JSON (open
it at ``ui.perfetto.dev`` or ``chrome://tracing``):

* one lane per batch **slot** (``slot 0..B-1``): a complete span per
  request occupying it, with instants for admission chunks, the first
  token, and each poll's token emissions;
* a **queue** lane: per-request wait between ``submit`` and admission;
* a **steps** lane: one slice per engine step, named by kind (``plain``
  / ``mixed``);
* a **compiles** lane: every step-program build (on the card a warm-up
  and a CUDA graph capture) with its wall time, steady-state ones
  flagged;
* a **faults** lane when a fault fired, and counter tracks for **active
  slots** and **page-pool occupancy** (live/free pages), sampled at every
  poll.

Timestamps are microseconds from the tracer's construction (the
engine's, with ``recorder=True``). The tracer never touches the device,
so a traced run's greedy outputs and program counts are those of an
untraced one.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.telemetry import Recorder

__all__ = ["Tracer", "validate_chrome_trace", "complete_spans",
           "merge_chrome_traces"]

# fixed thread-lane ids (slot lanes are 1..max_batch)
QUEUE_TID = 0
STEP_TID = 900
COMPILE_TID = 901
FAULT_TID = 902
_PID = 1


class Tracer(Recorder):
    enabled = True

    def __init__(self):
        self.t0 = time.perf_counter()
        # uid -> lifecycle record (insertion order = submit order)
        self.requests: Dict[int, Dict[str, Any]] = {}
        self.steps: List[Tuple[float, float, str]] = []
        self.polls: List[Tuple[float, int, Dict[str, float]]] = []
        self.compiles: List[Tuple[float, str, float, bool]] = []
        self.faults: List[Tuple[float, str, int]] = []

    # -- Recorder hooks ------------------------------------------------ #
    def on_submit(self, req) -> None:
        self.requests[req.uid] = {
            "uid": req.uid, "prompt_len": len(req.prompt),
            "submitted": time.perf_counter(), "admitted": None,
            "slot": None, "kind": "", "base": 0, "chunks": [],
            "first_token": None, "emits": [], "finished": None,
            "reason": "", "generated": 0, "preempts": []}

    def on_admission(self, req, slot: int, base: int, kind: str) -> None:
        r = self.requests.get(req.uid)
        if r is None:
            return
        r["admitted"] = time.perf_counter()
        r["slot"] = slot
        r["kind"] = kind
        r["base"] = base

    def on_chunk(self, req, slot: int, lo: int, hi: int,
                 last: bool) -> None:
        r = self.requests.get(req.uid)
        if r is not None:
            r["chunks"].append((time.perf_counter(), lo, hi, last))

    def on_first_token(self, req, ts: float) -> None:
        r = self.requests.get(req.uid)
        if r is not None and r["first_token"] is None:
            r["first_token"] = ts

    def on_emit(self, req, slot: int, n: int, ts: float) -> None:
        r = self.requests.get(req.uid)
        if r is not None and n:
            r["emits"].append((ts, n))
            r["generated"] += n

    def on_finish(self, req, reason: str, ts: float) -> None:
        r = self.requests.get(req.uid)
        if r is not None:
            r["finished"] = ts
            r["reason"] = reason

    def on_preempt(self, req, slot: int, ts: float) -> None:
        r = self.requests.get(req.uid)
        if r is not None:
            r["preempts"].append((ts, slot))

    def on_fault(self, site: str, step: int, ts: float) -> None:
        self.faults.append((ts, site, step))

    def on_steps(self, spans: List[Tuple[float, float, str]]) -> None:
        self.steps.extend(spans)

    def on_poll(self, ts: float, active: int,
                stats: Dict[str, float]) -> None:
        self.polls.append((ts, active, dict(stats)))

    def on_compile(self, name: str, elapsed_s: float, steady: bool,
                   ts: float) -> None:
        self.compiles.append((ts, name, elapsed_s, steady))

    # -- export -------------------------------------------------------- #
    def _us(self, t: float) -> float:
        return round((t - self.t0) * 1e6, 1)

    def export_chrome_trace(self, path: Optional[str] = None
                            ) -> Dict[str, Any]:
        """Render the collected run as a Chrome trace-event object
        (``{"traceEvents": [...]}``); write JSON to ``path`` when given.
        Requests still running (or never admitted) at export time get an
        open-ended span cut at "now" with reason ``evicted``."""
        now = time.perf_counter()
        ev: List[Dict[str, Any]] = []

        def meta(tid: int, name: str) -> None:
            ev.append({"name": "thread_name", "ph": "M", "ts": 0,
                       "pid": _PID, "tid": tid,
                       "args": {"name": name}})

        ev.append({"name": "process_name", "ph": "M", "ts": 0,
                   "pid": _PID, "tid": 0,
                   "args": {"name": "serving engine"}})
        meta(QUEUE_TID, "queue")
        slots = sorted({r["slot"] for r in self.requests.values()
                       if r["slot"] is not None})
        for b in slots:
            meta(1 + b, f"slot {b}")
        meta(STEP_TID, "steps")
        meta(COMPILE_TID, "compiles")
        if self.faults:
            meta(FAULT_TID, "faults")

        for r in self.requests.values():
            uid = r["uid"]
            adm = r["admitted"]
            end = r["finished"] if r["finished"] is not None else now
            # queue lane: submit -> admission (or still waiting)
            ev.append({"name": f"queue u{uid}", "ph": "X",
                       "ts": self._us(r["submitted"]),
                       "dur": max(0.0, round(
                           ((adm if adm is not None else end)
                            - r["submitted"]) * 1e6, 1)),
                       "pid": _PID, "tid": QUEUE_TID,
                       "args": {"uid": uid,
                                "prompt_len": r["prompt_len"]}})
            if adm is None:
                continue
            tid = 1 + r["slot"]
            # the request's complete span on its slot lane
            ev.append({"name": f"req {uid}", "ph": "X",
                       "ts": self._us(adm),
                       "dur": max(0.0, round((end - adm) * 1e6, 1)),
                       "pid": _PID, "tid": tid,
                       "args": {"uid": uid,
                                "prompt_len": r["prompt_len"],
                                "admission": r["kind"],
                                "prefix_reused": r["base"],
                                "generated": r["generated"],
                                "preemptions": len(r["preempts"]),
                                "finish": r["reason"] or "evicted"}})
            for (t, pslot) in r["preempts"]:
                ev.append({"name": "preempt", "ph": "i",
                           "ts": self._us(t), "pid": _PID,
                           "tid": 1 + pslot, "s": "t",
                           "args": {"uid": uid}})
            for (t, lo, hi, last) in r["chunks"]:
                ev.append({"name": f"chunk {lo}:{hi}", "ph": "i",
                           "ts": self._us(t), "pid": _PID, "tid": tid,
                           "s": "t",
                           "args": {"uid": uid, "last": bool(last)}})
            if r["first_token"] is not None:
                ev.append({"name": "first_token", "ph": "i",
                           "ts": self._us(r["first_token"]),
                           "pid": _PID, "tid": tid, "s": "t",
                           "args": {"uid": uid}})
            for (t, n) in r["emits"]:
                ev.append({"name": f"emit {n}", "ph": "i",
                           "ts": self._us(t), "pid": _PID, "tid": tid,
                           "s": "t", "args": {"uid": uid, "n": n}})
            if r["finished"] is not None:
                ev.append({"name": f"finish:{r['reason']}", "ph": "i",
                           "ts": self._us(r["finished"]), "pid": _PID,
                           "tid": tid, "s": "t", "args": {"uid": uid}})

        for (start, end, kind) in self.steps:
            ev.append({"name": kind, "ph": "X", "ts": self._us(start),
                       "dur": max(0.0, round((end - start) * 1e6, 1)),
                       "pid": _PID, "tid": STEP_TID})
        for (t, site, step) in self.faults:
            ev.append({"name": f"fault {site}", "ph": "i",
                       "ts": self._us(t), "pid": _PID, "tid": FAULT_TID,
                       "s": "t", "args": {"site": site, "step": step}})
        for (t, name, elapsed, steady) in self.compiles:
            ev.append({"name": f"compile {name}", "ph": "X",
                       "ts": self._us(max(t, self.t0)),
                       "dur": round(elapsed * 1e6, 1),
                       "pid": _PID, "tid": COMPILE_TID,
                       "args": {"steady": bool(steady)}})
        for (t, active, stats) in self.polls:
            ev.append({"name": "active_slots", "ph": "C",
                       "ts": self._us(t), "pid": _PID,
                       "args": {"active": active}})
            if "kv_pages_live" in stats:
                ev.append({"name": "page_pool", "ph": "C",
                           "ts": self._us(t), "pid": _PID,
                           "args": {"live": stats["kv_pages_live"],
                                    "free": stats["kv_pages_free"]}})

        trace = {"traceEvents": ev, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


# --------------------------------------------------------------------- #
# multi-process merge (one trace per engine, e.g. a fleet's replicas)
# --------------------------------------------------------------------- #
def merge_chrome_traces(parts, extra=None, extra_label: str = "fleet",
                        extra_pid: int = 99,
                        path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-replica Chrome traces into one multi-process trace.

    ``parts`` is a list of ``(label, pid, trace, offset_us)`` tuples:
    every event in ``trace`` is rewritten onto process ``pid`` (named
    ``label``) and shifted by ``offset_us`` — each replica tracer's
    timestamps are relative to its own construction, so the caller
    passes the tracer-epoch offset that aligns them on one clock.
    ``extra`` is an optional list of ready-made events for an
    orchestration lane on ``extra_pid`` (health transitions, failovers,
    hedges)."""
    ev: List[Dict[str, Any]] = []
    for label, pid, trace, offset_us in parts:
        ev.append({"name": "process_name", "ph": "M", "ts": 0,
                   "pid": pid, "tid": 0, "args": {"name": label}})
        for e in trace.get("traceEvents", ()):
            if e.get("ph") == "M" and e.get("name") == "process_name":
                continue
            e2 = dict(e)
            e2["pid"] = pid
            if e.get("ph") != "M":
                e2["ts"] = round(e.get("ts", 0) + offset_us, 1)
            ev.append(e2)
    if extra:
        ev.append({"name": "process_name", "ph": "M", "ts": 0,
                   "pid": extra_pid, "tid": 0,
                   "args": {"name": extra_label}})
        ev.extend(extra)
    merged = {"traceEvents": ev, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(merged, f)
    return merged


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #
_PHASES = {"X", "i", "C", "M"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural validation of a Chrome trace-event object (or a path
    to one): returns a list of problems, empty when the trace is
    loadable by Perfetto / chrome://tracing."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    errs: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["not a dict with a 'traceEvents' key"]
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' is not a non-empty list"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        errs.append(f"not JSON-serializable: {e}")
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"{where}: missing/empty 'name'")
        ph = e.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: bad phase {ph!r}")
        if not isinstance(e.get("ts"), (int, float)):
            errs.append(f"{where}: missing numeric 'ts'")
        if not isinstance(e.get("pid"), int):
            errs.append(f"{where}: missing integer 'pid'")
        if ph == "X":
            d = e.get("dur")
            if not isinstance(d, (int, float)) or d < 0:
                errs.append(f"{where}: 'X' event needs dur >= 0")
        if ph == "C" and not isinstance(e.get("args"), dict):
            errs.append(f"{where}: counter event needs numeric args")
    return errs


def complete_spans(trace: Dict[str, Any], prefix: str = "req "
                   ) -> Dict[str, Dict[str, Any]]:
    """Complete ('X') events whose name starts with ``prefix``, keyed by
    name — the per-request span lookup tests assert on."""
    return {e["name"]: e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X" and str(e.get("name", "")
                                          ).startswith(prefix)}
