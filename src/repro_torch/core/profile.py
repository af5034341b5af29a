"""Per-stage instrumentation (the port's copy of the JAX package's
``core/profile.py``), the paper's Owl instrumentation feature
("collecting forward computation latency of each node ... took 50 LoC"):
given a composed service's stages, time each stage's compute and the
intermediate payload sizes, without changing the service itself.

Each stage runs through its own program (``Service.jitted()``, where
JAX calls ``jax.jit(s.fn)``): on the card its first call runs eagerly
(the warm-up, which builds the kernels with ``nvcc``) and captures a
CUDA graph, and later calls replay it. Times are host-clock times around
a call that ends in a synchronize on the devices its output lives on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Sequence

from repro_torch.core.deploy import block_until_ready
from repro_torch.core.netmodel import tree_nbytes
from repro_torch.core.service import Service


@dataclass
class StageProfile:
    stage: str
    compute_ms: float
    output_bytes: int
    n_params: int
    compile_ms: float = 0.0   # first call (warm-up + capture) minus
                              # the steady median


def _timed(fn, s: Service, x):
    t0 = time.perf_counter()
    y = block_until_ready(fn(s.params, x))
    return y, time.perf_counter() - t0


def profile_stages(stages: Sequence[Service], inputs: Any, *,
                   iters: int = 5) -> List[StageProfile]:
    """Run the pipeline stage by stage, timing each (median of iters).
    ``compile_ms`` is the first call's excess (warm-up plus capture)
    over the steady median: the one-off cost a cold service pays."""
    out: List[StageProfile] = []
    x = inputs
    for s in stages:
        fn = s.jitted()
        y, first = _timed(fn, s, x)
        times = sorted(_timed(fn, s, x)[1] for _ in range(iters))
        steady_ms = times[len(times) // 2] * 1e3
        out.append(StageProfile(
            stage=s.name,
            compute_ms=steady_ms,
            output_bytes=tree_nbytes(y),
            n_params=s.n_params,
            compile_ms=max(0.0, first * 1e3 - steady_ms)))
        x = y
    return out


def format_profile(profiles: List[StageProfile]) -> str:
    total = sum(p.compute_ms for p in profiles)
    lines = [f"{'stage':40s} {'ms':>10s} {'%':>6s} {'compile ms':>11s} "
             f"{'out bytes':>12s} {'params':>10s}"]
    for p in profiles:
        lines.append(
            f"{p.stage:40s} {p.compute_ms:10.2f} "
            f"{100 * p.compute_ms / max(total, 1e-9):5.1f}% "
            f"{p.compile_ms:11.1f} "
            f"{p.output_bytes:12,d} {p.n_params:10,d}")
    lines.append(f"{'TOTAL':40s} {total:10.2f}")
    return "\n".join(lines)
