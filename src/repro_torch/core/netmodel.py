"""Analytical network cost model for remote/hybrid deployment (the
port's copy of the JAX package's ``core/netmodel.py``).

There is no network to measure, so the paper's cloud-API comparison
(Fig. 3) is reproduced with a parameterised model: per-request RTT +
payload/bandwidth + server time, with jitter and a congestion term that
makes batch response time grow super-linearly, the behaviour the paper
measured against the Google Vision API over a 34 Mbps uplink. The jitter
comes from a numpy generator seeded as in JAX, so both packages model
the same latencies.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.pytree import tree_leaves


@dataclass
class NetworkModel:
    bandwidth_mbps: float = 34.0      # paper's measured uplink
    rtt_ms: float = 60.0
    server_ms: float = 350.0          # remote per-item service time
    jitter_frac: float = 0.35         # lognormal-ish multiplicative jitter
    congestion_per_item: float = 0.04 # queueing slowdown per in-flight item
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def transfer_s(self, nbytes: int) -> float:
        base = self.rtt_ms / 1e3 + nbytes * 8 / (self.bandwidth_mbps * 1e6)
        return base * self._jitter()

    def request_s(self, payload_bytes: int, response_bytes: int,
                  queue_position: int = 0) -> float:
        """Modelled latency of one remote request."""
        congestion = 1.0 + self.congestion_per_item * queue_position
        serve = (self.server_ms / 1e3) * congestion * self._jitter()
        return (self.transfer_s(payload_bytes) + serve
                + self.transfer_s(response_bytes))

    def _jitter(self) -> float:
        return float(np.exp(self._rng.normal(0.0, self.jitter_frac)))


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (QTensor leaves count their
    packed values and scales)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))
