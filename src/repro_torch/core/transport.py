"""Repository transports (the port's copy of the JAX package's
``core/transport.py``): the paper's step 2 ("pull from the remote
repository **or from peer devices** such as machine B") made concrete.

A ``Transport`` moves service directories (manifest + params files)
between a remote root and the local cache. Remote transports are
modelled: byte counts are real (the actual files are copied), latency is
charged through the :class:`NetworkModel`, and a ``PeerTransport``
differs from ``RepoTransport`` only in its network parameters (LAN-ish
vs WAN-ish), matching the paper's motivation that edge-to-edge pulls can
be cheaper than cloud pulls.

Resilience: transfers are **atomic** (copied into a hidden temp
directory, renamed into place only when complete, so a reader never
observes a half-copied service) and **retried** with bounded exponential
backoff and deterministic seeded jitter when an attempt drops or times
out. Failures surface as :class:`TransportError` after ``max_retries``
extra attempts; the attempt count rides along in ``PullReport.retries``.
The ``transport_drop`` / ``transport_latency`` sites of
:mod:`repro_torch.serving.faults` hook each attempt.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.registry import Registry
from repro_torch.serving.faults import NoFaults


class TransportError(IOError):
    """A transfer attempt failed (drop, timeout, or filesystem error)
    and retries were exhausted."""


@dataclass
class PullReport:
    name: str
    version: str
    nbytes: int
    seconds: float
    source: str
    cached: bool = False
    retries: int = 0        # extra attempts beyond the first


class Transport:
    """Copies <root>/<name>/<version>/* into the local cache root.

    ``timeout_s`` bounds one attempt's wall clock (modelled latency
    included); ``max_retries`` bounds extra attempts; ``backoff_s`` is
    the base of the exponential backoff schedule (attempt *k* sleeps
    ``backoff_s * 2**k``, scaled by deterministic jitter in [0.5, 1.0]
    from a generator seeded per transport instance)."""

    kind = "base"

    def __init__(self, remote_root, network: Optional[NetworkModel] = None,
                 *, timeout_s: float = 30.0, max_retries: int = 3,
                 backoff_s: float = 0.02, faults=None, jitter_seed: int = 0):
        self.remote_root = Path(remote_root)
        self.network = network
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.faults = NoFaults() if faults is None else faults
        self._jitter = np.random.default_rng(jitter_seed)

    def list_remote(self) -> List[Tuple[str, str]]:
        return sorted(
            (p.parent.parent.name, p.parent.name)
            for p in self.remote_root.glob("*/*/manifest.json"))

    # -- the retried, atomic copy ------------------------------------- #
    def _backoff(self, attempt: int) -> float:
        scale = 0.5 + 0.5 * float(self._jitter.random())
        return self.backoff_s * (2 ** attempt) * scale

    def _transfer(self, src: Path, dst: Path, op: str, what: str) -> int:
        """Copy ``src`` -> ``dst`` atomically (temp dir + rename), with
        per-attempt fault hooks, a timeout, and retried attempts.
        Returns the number of retries (extra attempts) consumed."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            tmp = dst.parent / f".{dst.name}.tmp-{os.getpid()}"
            t0 = time.perf_counter()
            try:
                injected = 0.0
                if self.faults.enabled:
                    spec = self.faults.fire("transport_latency",
                                            op=op, attempt=attempt)
                    if spec is not None:
                        injected = spec.delay_s
                    if self.faults.fire("transport_drop",
                                        op=op, attempt=attempt) is not None:
                        raise TransportError(
                            f"{self.kind} {op} {what}: connection dropped"
                            " (injected fault)")
                if tmp.exists():
                    shutil.rmtree(tmp)
                shutil.copytree(src, tmp)
                elapsed = time.perf_counter() - t0 + injected
                if elapsed > self.timeout_s:
                    raise TransportError(
                        f"{self.kind} {op} {what}: attempt took "
                        f"{elapsed:.3f}s > timeout_s={self.timeout_s}")
                tmp.rename(dst)
                return attempt
            except (TransportError, OSError) as e:
                shutil.rmtree(tmp, ignore_errors=True)
                last = e
                if attempt < self.max_retries:
                    time.sleep(self._backoff(attempt))
        raise TransportError(
            f"{self.kind} {op} {what} failed after "
            f"{self.max_retries + 1} attempts: {last}") from last

    def fetch(self, name: str, version: str, cache_root) -> PullReport:
        src = self.remote_root / name / version
        if not (src / "manifest.json").exists():
            raise FileNotFoundError(f"{name}@{version} not on {self.kind}")
        dst = Path(cache_root) / name / version
        if (dst / "manifest.json").exists():
            return PullReport(name, version, 0, 0.0, self.kind, cached=True)
        dst.parent.mkdir(parents=True, exist_ok=True)
        retries = self._transfer(src, dst, "fetch", f"{name}@{version}")
        nbytes = sum(f.stat().st_size for f in dst.rglob("*") if f.is_file())
        secs = self.network.transfer_s(nbytes) if self.network else 0.0
        return PullReport(name, version, nbytes, secs, self.kind,
                          retries=retries)

    def push(self, name: str, version: str, cache_root) -> PullReport:
        src = Path(cache_root) / name / version
        dst = self.remote_root / name / version
        if dst.exists():
            raise FileExistsError(f"{name}@{version} already on {self.kind}")
        dst.parent.mkdir(parents=True, exist_ok=True)
        retries = self._transfer(src, dst, "push", f"{name}@{version}")
        nbytes = sum(f.stat().st_size for f in dst.rglob("*") if f.is_file())
        secs = self.network.transfer_s(nbytes) if self.network else 0.0
        return PullReport(name, version, nbytes, secs, self.kind,
                          retries=retries)


class RepoTransport(Transport):
    """The central model repository (the paper's Gist server A):
    WAN-class link."""

    kind = "repo"

    def __init__(self, remote_root, network: Optional[NetworkModel] = None,
                 **kw):
        super().__init__(remote_root,
                         network or NetworkModel(bandwidth_mbps=34.0,
                                                 rtt_ms=60.0, seed=1), **kw)


class PeerTransport(Transport):
    """A peer edge device (the paper's machine B): LAN-class link."""

    kind = "peer"

    def __init__(self, remote_root, network: Optional[NetworkModel] = None,
                 **kw):
        super().__init__(remote_root,
                         network or NetworkModel(bandwidth_mbps=900.0,
                                                 rtt_ms=2.0, seed=2), **kw)


@dataclass
class SyncedRegistry:
    """A local registry backed by an ordered list of transports; pulls
    try the cache, then each transport in order (peers before the repo,
    the paper's edge-first pull). Pulled weights land on ``device``
    (CUDA unless named, as in :class:`Registry`)."""

    cache_root: Path
    transports: List[Transport] = field(default_factory=list)
    device: Optional[str] = None

    def __post_init__(self):
        self.cache_root = Path(self.cache_root)
        self.local = Registry(self.cache_root, device=self.device)

    def pull(self, name: str, version: Optional[str] = None,
             *, verify: bool = True):
        report = None
        versions = self.local.versions(name) \
            if (self.cache_root / name).exists() else []
        if not versions or (version and version not in versions):
            for t in self.transports:
                try:
                    remote_versions = [v for n, v in t.list_remote()
                                       if n == name]
                    if not remote_versions:
                        continue
                    v = version or sorted(remote_versions)[-1]
                    report = t.fetch(name, v, self.cache_root)
                    break
                except FileNotFoundError:
                    continue
            else:
                raise FileNotFoundError(
                    f"{name} not in cache or any transport")
            # composed services: fetch stage deps too
            man = json.loads((self.cache_root / name / report.version
                              / "manifest.json").read_text())
            for ref in man.get("stages", []) or []:
                self.pull(ref["name"], ref.get("version"), verify=verify)
        svc = self.local.pull(name, version, verify=verify)
        return svc, report

    def publish(self, service, *, builder, config=None, stage_refs=None,
                push_to: Optional[Transport] = None, overwrite=False):
        man = self.local.publish(service, builder=builder, config=config,
                                 stage_refs=stage_refs, overwrite=overwrite)
        report = None
        if push_to is not None:
            report = push_to.push(service.name, service.version,
                                  self.cache_root)
        return man, report
