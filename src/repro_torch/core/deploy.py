"""Deployment (the port's copy of the JAX package's ``core/deploy.py``):
the second half of the paper's service definition, kept strictly
separate from functionality. The same composed service can be placed
local, remote, or split across endpoints **without changing its
structure** (the paper's step-3 property).

Endpoints:
  * ``local``  - this process, on the device the stage's params live on.
  * ``remote`` - an endpoint behind a modelled network; compute runs here
    (one machine) but latency is accounted through the
    :class:`NetworkModel`, matching how the paper measured cloud calls.
  * ``mesh``   - a serving mesh (``launch.mesh.Mesh``): the group runs
    with that mesh current (``distribution.sharding.use_mesh``), so the
    model layers run rank-local and issue their collectives, every rank
    calling the deployed service (one process a rank). Each rank holds
    its block of the group's params, cut once by ``param_shardings``
    (a quantized endpoint stores the whole quantized tree and cuts the
    dequantized weights in its program). Without a mesh it runs as
    ``local``, as JAX's does.

Consecutive stages on the same endpoint are grouped and run as one
``seq`` through its program (``Service.jitted()``: one CUDA graph on the
card, replayed on every call after the first, where JAX compiles the
group into one XLA program; eager on the CPU). A quantized endpoint's
dequantize runs inside that program. Transfers between endpoints are
charged for the intermediate tree's bytes. A stage's compute time stops
after a synchronize on the device its output lives on.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.compose import seq
from repro_torch.core.netmodel import NetworkModel, tree_nbytes
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.service import Service
from repro_torch.distribution.sharding import (
    param_shardings, shard_tree, use_mesh)
from repro_torch.quant import dequantize_params, quantize_params


@dataclass(frozen=True)
class Endpoint:
    name: str
    kind: str = "local"                      # local | mesh | remote
    mesh: Optional[Any] = None               # for mesh: a launch.mesh.Mesh
    network: Optional[NetworkModel] = None   # for remote
    quantize: str = ""                       # "" | "int8" | "int4": stages
                                             # placed here hold weight-
                                             # quantized params (edge
                                             # memory profile); dequant
                                             # runs inside the stage's
                                             # call


@dataclass
class StageTelemetry:
    stage: str
    endpoint: str
    compute_s: float
    transfer_s: float
    precision: str = "fp"                    # endpoint's quantize profile
    param_bytes: int = 0                     # stage params as stored
    pool_bytes: int = 0                      # its program's graph pool
                                             # (device memory kept while
                                             # the program lives)


@dataclass
class Telemetry:
    stages: List[StageTelemetry] = field(default_factory=list)

    @property
    def total_s(self) -> float:
        return sum(s.compute_s + s.transfer_s for s in self.stages)

    @property
    def transfer_total_s(self) -> float:
        return sum(s.transfer_s for s in self.stages)


@dataclass(frozen=True)
class DeploymentPlan:
    """stage-name -> endpoint-name; endpoints by name."""

    endpoints: Dict[str, Endpoint]
    assignments: Dict[str, str]

    @classmethod
    def all_local(cls, service: Service) -> "DeploymentPlan":
        # map the composite's own name too: non-seq combinators
        # (ensemble/route/parallel) deploy as a single stage under it
        stages = service.metadata.get("stages", []) + [service.name]
        return cls(endpoints={"local": Endpoint("local")},
                   assignments={s: "local" for s in stages})

    @classmethod
    def all_remote(cls, service: Service,
                   network: Optional[NetworkModel] = None) -> "DeploymentPlan":
        stages = service.metadata.get("stages", []) + [service.name]
        ep = Endpoint("cloud", kind="remote",
                      network=network or NetworkModel())
        return cls(endpoints={"cloud": ep},
                   assignments={s: "cloud" for s in stages})

    @classmethod
    def split(cls, service: Service, split_at: int,
              network: Optional[NetworkModel] = None) -> "DeploymentPlan":
        """First ``split_at`` stages local, rest remote (Neurosurgeon-style
        hybrid the paper cites)."""
        stages = service.metadata.get("stages") or [service.name]
        eps = {"local": Endpoint("local"),
               "cloud": Endpoint("cloud", kind="remote",
                                 network=network or NetworkModel())}
        asg = {s: ("local" if i < split_at else "cloud")
               for i, s in enumerate(stages)}
        # a non-seq combinator deploys as ONE stage under its own name
        asg.setdefault(service.name, "local" if split_at > 0 else "cloud")
        return cls(endpoints=eps, assignments=asg)

    @classmethod
    def edge_split(cls, service: Service, split_at: int,
                   quantize: str = "int4",
                   network: Optional[NetworkModel] = None
                   ) -> "DeploymentPlan":
        """The paper's step-3 property under a memory budget: the first
        ``split_at`` stages run on a local *edge* endpoint with
        weight-quantized params (int4 by default), the rest run remote in
        full precision — placement and precision change, the composed
        service's structure doesn't."""
        stages = service.metadata.get("stages") or [service.name]
        eps = {"edge": Endpoint("edge", kind="local", quantize=quantize),
               "cloud": Endpoint("cloud", kind="remote",
                                 network=network or NetworkModel())}
        asg = {s: ("edge" if i < split_at else "cloud")
               for i, s in enumerate(stages)}
        asg.setdefault(service.name, "edge" if split_at > 0 else "cloud")
        return cls(endpoints=eps, assignments=asg)


class DeployedService:
    """A composed service bound to a deployment plan."""

    def __init__(self, service: Service, plan: DeploymentPlan,
                 stages: Optional[List[Service]] = None):
        self.service = service
        self.plan = plan
        # Recover the stage list: either supplied, or treat as one stage.
        if stages is None:
            names = service.metadata.get("stages")
            if names and service.metadata.get("combinator") == "seq":
                raise ValueError("pass the component stage services for a "
                                 "seq composition")
            stages = [service]
        self.stages = stages
        self._groups = self._group()
        self._compiled: Dict[int, Tuple[Service, Any, int]] = {}

    # -------------------------------------------------------------- #
    def _group(self) -> List[Tuple[Endpoint, List[Service]]]:
        groups: List[Tuple[Endpoint, List[Service]]] = []
        for s in self.stages:
            ep_name = self.plan.assignments.get(s.name)
            if ep_name is not None:
                # explicit assignment: a missing endpoint is a plan bug
                ep = self.plan.endpoints[ep_name]
            elif "local" in self.plan.endpoints:
                ep = self.plan.endpoints["local"]      # historical default
            elif len(self.plan.endpoints) == 1:
                # unassigned stage, sole endpoint: unambiguous
                ep = next(iter(self.plan.endpoints.values()))
            else:
                raise KeyError(
                    f"stage {s.name!r} has no endpoint assignment and the "
                    f"plan has no 'local' endpoint to default to "
                    f"(endpoints: {sorted(self.plan.endpoints)})")
            if groups and groups[-1][0].name == ep.name:
                groups[-1][1].append(s)
            else:
                groups.append((ep, [s]))
        return groups

    def _fn_for(self, gi: int) -> Tuple[Service, Any, int]:
        """Group ``gi`` as one service (quantized for its endpoint), its
        program and the bytes of its params as stored."""
        if gi not in self._compiled:
            ep, stages = self._groups[gi]
            svc = stages[0] if len(stages) == 1 else seq(*stages)
            mesh = ep.mesh if ep.kind == "mesh" else None
            if mesh is not None and svc.params is not None \
                    and not ep.quantize:
                # the rank's block, once (the parts would see it whole)
                svc = dataclasses.replace(
                    svc, params=shard_tree(
                        svc.params, param_shardings(svc.params, mesh), mesh),
                    parts=())
            if ep.quantize and svc.params is not None:
                # store the stage's params quantized (the endpoint's
                # memory budget is what the profile models) and
                # dequantize (to f32, as JAX does) inside the program:
                # generic over any service fn. The parts go: they would
                # see the quantized tree
                bits = {"int8": 8, "int4": 4}[ep.quantize]
                raw_fn = svc.fn
                svc = dataclasses.replace(
                    svc, params=quantize_params(svc.params, bits=bits),
                    fn=lambda p, x, _f=raw_fn, _m=mesh: _f(
                        _blocks(dequantize_params(p), _m), x),
                    parts=())
            nbytes = tree_nbytes(svc.params) if svc.params is not None \
                else 0
            self._compiled[gi] = (svc, svc.jitted(), nbytes)
        return self._compiled[gi]

    # -------------------------------------------------------------- #
    def call(self, inputs, *, queue_position: int = 0
             ) -> Tuple[Any, Telemetry]:
        telemetry = Telemetry()
        x = inputs
        for gi, (ep, stages) in enumerate(self._groups):
            svc, fn, param_bytes = self._fn_for(gi)
            payload = tree_nbytes(x)

            t0 = time.perf_counter()
            mesh = ep.mesh if ep.kind == "mesh" else None
            with use_mesh(mesh):
                y = block_until_ready(fn(svc.params, x))
            compute_s = time.perf_counter() - t0
            transfer_s = 0.0
            if ep.kind == "remote":
                # remote latency is fully modelled (RTT + payload/bw +
                # modelled server time); the local wall time merely
                # produced the result and is not charged
                transfer_s = ep.network.request_s(
                    payload, tree_nbytes(y),
                    queue_position=queue_position)
                compute_s = 0.0
            telemetry.stages.append(StageTelemetry(
                stage="+".join(s.name for s in stages), endpoint=ep.name,
                compute_s=compute_s, transfer_s=transfer_s,
                precision=ep.quantize or "fp",
                param_bytes=param_bytes, pool_bytes=fn.pool_bytes))
            x = y
        return x, telemetry


def _blocks(params, mesh):
    """The rank's block of each leaf of ``params`` as views (the tree
    itself without a mesh)."""
    if mesh is None:
        return params
    return shard_tree(params, param_shardings(params, mesh), mesh,
                      copy=False)


def block_until_ready(tree):
    """Wait for the devices the tensors of ``tree`` live on (the port's
    ``jax.block_until_ready``); returns ``tree``."""
    for dev in {t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def deploy(service: Service, plan: Optional[DeploymentPlan] = None,
           stages: Optional[List[Service]] = None) -> DeployedService:
    plan = plan or DeploymentPlan.all_local(service)
    return DeployedService(service, plan, stages=stages)
