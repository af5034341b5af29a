"""Serving telemetry: the metrics registry, the percentile helpers, the
recorder interface and the recompile watchdog (the port's own copy of
the JAX package's ``serving/telemetry.py``).

* :class:`MetricsRegistry`: named counters (persistent ones survive a
  reset), gauges, bounded-reservoir histograms and aligned step series.
  The engine owns one; ``latency_stats()`` and the serve CLI's JSONL
  records are derived from it. Components that keep their own counters
  (the fault schedule, the page allocator) are attached as
  *collectors*: ``snapshot()`` pulls their live ``stats()``.
* :func:`pct_stats` / :func:`percentile`: the one percentile
  implementation (an empty stream contributes no keys, never a
  fabricated 0.0).
* :class:`Recorder`: the request-lifecycle event interface. The base
  class is the no-op default (``enabled`` False, every hook ``pass``);
  ``serving/tracing.Tracer`` records.
* :class:`CompileWatchdog` and :class:`RecompileWarning`: every step
  program the engine builds (a CUDA graph capture on the card) is
  recorded and reaches ``Recorder.on_compile``; once armed
  (``Engine.reset_stats`` or ``Engine.mark_steady``) a build is a
  steady-state regression: a warning and the ``steady_compiles``
  counter.

Host-side only: no device work.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "percentile", "pct_stats",
    "Counter", "Gauge", "Histogram", "Series", "MetricsRegistry",
    "Recorder", "RecompileWarning", "CompileWatchdog",
]


def percentile(samples: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile over raw samples (numpy's
    default). Raises on an empty sample set: callers decide the empty
    contract (``pct_stats`` omits keys)."""
    return float(np.percentile(np.asarray(samples, np.float64), p))


def pct_stats(stats: Dict[str, float], prefix: str, samples,
              pcts: Tuple[int, ...]) -> None:
    """Add ``{prefix}_mean`` / ``{prefix}_p{p}`` keys (in ms, samples in
    seconds) for one latency stream, only when it produced samples: an
    empty stream contributes no keys, never a fabricated 0.0."""
    arr = np.asarray(samples, np.float64)
    if arr.size == 0:
        return
    stats[f"{prefix}_mean"] = float(arr.mean() * 1e3)
    for p in pcts:
        stats[f"{prefix}_p{p}"] = float(np.percentile(arr, p) * 1e3)


class Counter:
    """Monotonic counter. ``persist=True`` survives ``registry.reset()``
    (total compiles: the warm-up's history outlives a benchmark's stats
    reset)."""
    __slots__ = ("value", "persist")

    def __init__(self, persist: bool = False):
        self.value = 0
        self.persist = persist

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        if not self.persist:
            self.value = 0


class Gauge:
    """Last-sampled value (active slots, free pages, ...)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Bounded-reservoir sample store (algorithm R past ``cap``, seeded):
    exact percentiles up to ``cap`` samples, an unbiased estimate after."""
    __slots__ = ("cap", "samples", "count", "_rng", "_seed")

    def __init__(self, cap: int = 8192, seed: int = 0):
        self.cap = int(cap)
        self.samples: List[float] = []
        self.count = 0
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def observe(self, v: float) -> None:
        self.count += 1
        if len(self.samples) < self.cap:
            self.samples.append(float(v))
            return
        j = int(self._rng.integers(0, self.count))
        if j < self.cap:
            self.samples[j] = float(v)

    @property
    def values(self) -> List[float]:
        return self.samples

    def summary(self, pcts: Tuple[int, ...] = (50, 95, 99)
                ) -> Dict[str, float]:
        out: Dict[str, float] = {"count": self.count}
        if self.samples:
            arr = np.asarray(self.samples, np.float64)
            out["mean"] = float(arr.mean())
            out["max"] = float(arr.max())
            for p in pcts:
                out[f"p{p}"] = float(np.percentile(arr, p))
        return out

    def reset(self) -> None:
        self.samples = []
        self.count = 0
        self._rng = np.random.default_rng(self._seed)


class Series:
    """Aligned append-only store of per-step records; ``values`` is the
    live list (the engine rewrites entries in place)."""
    __slots__ = ("values",)

    def __init__(self):
        self.values: List[Any] = []

    def append(self, v: Any) -> None:
        self.values.append(v)

    def reset(self) -> None:
        self.values.clear()


class MetricsRegistry:
    """Named metric store with get-or-create accessors. ``snapshot()``
    renders everything JSON-serializable; ``reset()`` clears every metric
    but the persistent counters."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.series: Dict[str, Series] = {}
        self._collectors: List[Callable[[], Dict[str, Any]]] = []

    def counter(self, name: str, persist: bool = False) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(persist=persist)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge()
        return self.gauges[name]

    def histogram(self, name: str, cap: int = 8192) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(cap=cap)
        return self.histograms[name]

    def get_series(self, name: str) -> Series:
        if name not in self.series:
            self.series[name] = Series()
        return self.series[name]

    def add_collector(self, fn: Callable[[], Dict[str, Any]]) -> None:
        """Attach a live stats source (``Faults.stats``,
        ``PagedKVState.stats``): called at every ``snapshot()`` and merged
        under ``collected``. Collectors own their counters: the registry
        never copies or resets them."""
        self._collectors.append(fn)

    def snapshot(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {
            "counters": {k: c.value for k, c in sorted(
                self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary() for k, h in sorted(
                self.histograms.items())},
            "series": {},
        }
        for k, s in sorted(self.series.items()):
            vals = s.values
            if vals and all(isinstance(v, (int, float)) for v in vals):
                arr = np.asarray(vals, np.float64)
                snap["series"][k] = {
                    "count": len(vals), "mean": float(arr.mean()),
                    "p50": float(np.percentile(arr, 50)),
                    "p99": float(np.percentile(arr, 99)),
                    "max": float(arr.max())}
            else:
                snap["series"][k] = {"count": len(vals),
                                     "values": list(vals[-64:])}
        collected: Dict[str, Any] = {}
        for fn in self._collectors:
            collected.update(fn())
        snap["collected"] = collected
        return snap

    def reset(self) -> None:
        for group in (self.counters, self.gauges, self.histograms,
                      self.series):
            for m in group.values():
                m.reset()


class Recorder:
    """Request-lifecycle event sink. This base class is the disabled
    path: every hook is a no-op and ``enabled`` is False, so the engine
    skips assembling the events' payloads. ``serving/tracing.Tracer``
    subclasses it to build Chrome-trace timelines. Timestamps are
    ``time.perf_counter()`` seconds."""
    enabled = False

    def on_submit(self, req) -> None:
        pass

    def on_admission(self, req, slot: int, base: int, kind: str) -> None:
        """Request leaves the queue: ``kind`` is "chunked" (the mixed
        step's path every admission takes) or "fallback" (never, in
        the port: counted by ``fallback_admissions``)."""

    def on_chunk(self, req, slot: int, lo: int, hi: int,
                 last: bool) -> None:
        """One admission chunk ``prompt[lo:hi)`` dispatched."""

    def on_first_token(self, req, ts: float) -> None:
        pass

    def on_emit(self, req, slot: int, n: int, ts: float) -> None:
        """``n`` tokens of ``req`` harvested at a poll."""

    def on_finish(self, req, reason: str, ts: float) -> None:
        pass

    def on_preempt(self, req, slot: int, ts: float) -> None:
        """``req`` evicted from ``slot`` and requeued (it resumes by
        replaying its generated prefix)."""

    def on_fault(self, site: str, step: int, ts: float) -> None:
        """A scheduled fault fired at ``site`` (``serving/faults.py``)."""

    def on_steps(self, spans: List[Tuple[float, float, str]]) -> None:
        """Finalised step timings for one burst: (start, end, kind)."""

    def on_poll(self, ts: float, active: int,
                stats: Dict[str, float]) -> None:
        """Periodic host sync: live occupancy and pool sample."""

    def on_compile(self, name: str, elapsed_s: float, steady: bool,
                   ts: float) -> None:
        pass


class RecompileWarning(UserWarning):
    """An engine step program was built (on the card: a CUDA graph
    captured) after the engine was marked steady: in serving, a latency
    cliff of an eager step plus a capture. Carries the program name, the
    build's wall time and the engine step."""

    def __init__(self, program: str, elapsed_s: float, step: int):
        self.program = program
        self.elapsed_s = elapsed_s
        self.step = step
        super().__init__(
            f"steady-state CUDA graph capture of {program!r} at engine "
            f"step {step} ({elapsed_s * 1e3:.1f} ms): a step program was "
            f"built after warm-up (a slot or a shape not seen before)")


class CompileWatchdog:
    """Records every step program the engine builds into the registry
    (``compiles_total`` / ``steady_compiles`` persistent counters and a
    ``compiles`` series of per-event dicts), hands each build to the
    recorder's ``on_compile`` and warns with :class:`RecompileWarning`
    for a build after ``arm()``.

    Warm-up builds are expected (the first call of every program); a
    steady-state build is a regression. Arming is explicit:
    ``Engine.reset_stats()`` or ``Engine.mark_steady()``."""

    def __init__(self, registry: MetricsRegistry,
                 recorder: Optional[Recorder] = None):
        self.registry = registry
        self.recorder = recorder or Recorder()
        self.steady = False
        self._total = registry.counter("compiles_total", persist=True)
        self._steady_c = registry.counter("steady_compiles", persist=True)
        self._log = registry.get_series("compiles")

    def arm(self) -> None:
        self.steady = True

    def record(self, name: str, elapsed_s: float, step: int,
               ts: float) -> None:
        """One program built: ``elapsed_s`` of wall time at engine step
        ``step``, ending at host time ``ts``."""
        self._total.inc()
        self._log.append({"program": name,
                          "elapsed_ms": round(elapsed_s * 1e3, 3),
                          "step": step, "steady": self.steady})
        self.recorder.on_compile(name, elapsed_s, self.steady, ts)
        if self.steady:
            self._steady_c.inc()
            warnings.warn(RecompileWarning(name, elapsed_s, step),
                          stacklevel=3)
