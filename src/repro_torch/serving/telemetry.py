"""Serving telemetry: the metrics registry and the percentile helper that
``Engine.latency_stats`` reads.

The port's own copy of the parts of the JAX package's
``serving/telemetry.py`` that ``latency_stats`` reads: counters,
bounded-reservoir histograms and aligned step series. The recorder (request
lifecycle tracing) and the recompile watchdog arrive with the tracing
item of the ROADMAP. Host-side only: no device work.
"""
from __future__ import annotations

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
    """Monotonic counter."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
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
    clears every metric."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.series: Dict[str, Series] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter()
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
