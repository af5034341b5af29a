"""Serving telemetry: the metrics registry, the percentile helper that
``Engine.latency_stats`` reads and the recompile watchdog.

The port's own copy of the parts of the JAX package's
``serving/telemetry.py`` that the engine uses: counters (persistent ones
survive a reset), bounded-reservoir histograms, aligned step series, and
the ``CompileWatchdog`` that records every step program the engine builds
(a CUDA graph capture on the card) and warns with ``RecompileWarning`` on
one built after the engine was marked steady. The recorder (request
lifecycle tracing) arrives with ROADMAP section 1, item 5. Host-side
only: no device work.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Tuple

import numpy as np


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
    """Named metric store with get-or-create accessors; ``reset()``
    clears every metric but the persistent counters."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.series: Dict[str, Series] = {}

    def counter(self, name: str, persist: bool = False) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(persist=persist)
        return self.counters[name]

    def histogram(self, name: str, cap: int = 8192) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(cap=cap)
        return self.histograms[name]

    def get_series(self, name: str) -> Series:
        if name not in self.series:
            self.series[name] = Series()
        return self.series[name]

    def reset(self) -> None:
        for group in (self.counters, self.histograms, self.series):
            for m in group.values():
                m.reset()


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
    ``compiles`` series of per-event dicts) and warns with
    :class:`RecompileWarning` for a build after ``arm()``.

    Warm-up builds are expected (the first call of every program); a
    steady-state build is a regression. Arming is explicit:
    ``Engine.reset_stats()`` or ``Engine.mark_steady()``."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.steady = False
        self._total = registry.counter("compiles_total", persist=True)
        self._steady_c = registry.counter("steady_compiles", persist=True)
        self._log = registry.get_series("compiles")

    def arm(self) -> None:
        self.steady = True

    def record(self, name: str, elapsed_s: float, step: int,
               ts: float) -> None:
        """One program built: ``elapsed_s`` of wall time at engine step
        ``step``; ``ts`` (the host clock at the end) is kept for the
        recorder's hook, which ROADMAP section 1, item 5 brings."""
        del ts
        self._total.inc()
        self._log.append({"program": name,
                          "elapsed_ms": round(elapsed_s * 1e3, 3),
                          "step": step, "steady": self.steady})
        if self.steady:
            self._steady_c.inc()
            warnings.warn(RecompileWarning(name, elapsed_s, step),
                          stacklevel=3)
