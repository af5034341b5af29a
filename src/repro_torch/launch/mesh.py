"""The serving mesh over ``torch.distributed``: the port of the JAX
package's ``launch/mesh.py``.

JAX runs one controller over every device of a mesh and lets GSPMD
infer the collectives. PyTorch has no partitioner, so the port runs one
process a rank: each holds its shard of every leaf (``distribution/
sharding.py``) and issues the collectives itself, through the
:class:`Mesh` it serves on. The layout is always ``("data", "model")``
as in JAX: rank ``r`` sits at ``(r // mp, r % mp)``, its model group is
the ``mp`` ranks of its row (tensor parallelism: weights and KV heads
split), its data group the ``dp`` ranks of its column (batch slots
split).

A mesh needs an initialised default process group: gloo for CPU tensors,
NCCL on the card, one process a rank (``torchrun`` starts them and sets
the environment ``init_process_group`` reads). Every rank builds the
same meshes in the same order, since making a group is collective.

Every collective the mesh issues adds one to ``collective_counts()``
under its kind, at the call (an eager step or a CUDA graph's capture);
the engine's step programs add their capture's count at every replay,
as the kernel counters do.

``make_production_mesh`` and the TPU ``HW`` table wait for ROADMAP
section 1, item 13c, with the dry-run.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")

_COUNTS: collections.Counter = collections.Counter()


def collective_counts() -> Dict[str, int]:
    """Collectives issued so far, by kind (``all_reduce``, ``all_gather``,
    ``broadcast``)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def add_collectives(delta: Dict[str, int]) -> None:
    _COUNTS.update(delta)


@contextlib.contextmanager
def recorded_collectives() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit, the
    collectives issued inside the block, and takes them back off the
    counts (a capture runs none of them), also when the block raises."""
    before = collections.Counter(_COUNTS)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for kind, n in _COUNTS.items():
            if n != before[kind]:
                delta[kind] = n - before[kind]
        _COUNTS.subtract(delta)


def _gather_fn():
    # ``all_gather_single`` where this torch has it (it deprecates
    # ``all_gather_into_tensor``, which older releases alone have)
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


class Mesh:
    """A ``("data", "model")`` mesh of ``shape == (dp, mp)`` ranks: this
    rank's coordinates and, for a live mesh, the process group of each
    axis it belongs to. A mesh without groups (``Mesh((16, 16))``) is a
    shape only: the sharding rules read it, its collectives raise."""

    axis_names = AXES

    def __init__(self, shape: Tuple[int, int], rank: int = 0,
                 groups: Optional[Dict[str, "dist.ProcessGroup"]] = None,
                 group_ranks: Optional[Dict[str, List[int]]] = None):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != 2 or min(self.shape) < 1:
            raise ValueError(f"a mesh has two axes of size >= 1, got "
                             f"{shape}")
        self.rank = int(rank)
        mp = self.shape[1]
        self.coords = (self.rank // mp, self.rank % mp)
        self.groups = groups
        self.group_ranks = group_ranks or {}

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(AXES, self.shape))

    def axis_size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[0]}, model={self.shape[1]}, "
                f"rank={self.rank}, coords={self.coords})")

    # ---------------------------------------------------------------- #
    # collectives over one axis
    # ---------------------------------------------------------------- #
    def _group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(f"{self!r} is a shape only: it has no "
                               f"process groups to communicate over")
        return self.groups[axis]

    def all_reduce(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, in place (and returned). The
        ranks' blocks are gathered and summed in rank order, so the bits
        depend neither on the buffer's size nor on the algorithm a
        library picks for it (a ring reduction sums each element in an
        order set by the chunk it falls in: a prompt admitted in chunks
        of 8 and of 16 would leave different caches), and every rank
        gets the same bits."""
        _COUNTS["all_reduce"] += 1
        n = self.axis_size(axis)
        flat = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        _gather_fn()(flat, x.contiguous().view(-1),
                     group=self._group(axis))
        parts = flat.view((n,) + tuple(x.shape))
        total = parts[0]
        for i in range(1, n):
            total = total + parts[i]
        return x.copy_(total)

    def all_gather(self, x: torch.Tensor, axis: str = "model",
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in axis order."""
        _COUNTS["all_gather"] += 1
        n = self.axis_size(axis)
        x = x.contiguous()
        flat = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)
        _gather_fn()(flat, x, group=self._group(axis))
        dim = dim % x.dim()
        if dim == 0:
            return flat
        out = flat.view((n,) + tuple(x.shape)).movedim(0, dim)
        shape = list(x.shape)
        shape[dim] *= n
        return out.reshape(shape)

    def warm(self, device, stream=None) -> None:
        """One eager ``all_reduce`` on each axis's group on ``device``
        (on ``stream`` when given), waited for: NCCL makes a
        communicator at its first collective, which must not fall inside
        a CUDA graph capture. Not counted."""
        x = torch.zeros((1,), dtype=torch.float32, device=device)
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            for axis in AXES:
                dist.all_reduce(x, group=self._group(axis))
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def broadcast(self, x: torch.Tensor, axis: str, src: int
                  ) -> torch.Tensor:
        """``x`` of the rank at index ``src`` along ``axis``, in place on
        every rank of the group."""
        _COUNTS["broadcast"] += 1
        dist.broadcast(x, src=self.group_ranks[axis][src],
                       group=self._group(axis))
        return x


# --------------------------------------------------------------------- #
# constructors
# --------------------------------------------------------------------- #
#: live meshes by shape, for the default group they were made under:
#: making a group is collective, so every rank reuses the same ones
_MESHES: Dict[Tuple[int, int], Mesh] = {}
_MESHES_OF: List[object] = [None]


def _world() -> Tuple[int, int]:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a serving mesh needs an initialised default process group: "
            "start one process a rank with torchrun (python -m "
            "torch.distributed.run --nproc-per-node N ...) and call "
            "torch.distributed.init_process_group (gloo for CPU tensors, "
            "nccl on the card) before building the mesh")
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: Tuple[int, int]) -> Mesh:
    """The live ``("data", "model")`` mesh of ``shape`` over the default
    process group, whose size it must equal (``ValueError`` otherwise,
    as ``jax.make_mesh`` raises). The groups are made once a shape."""
    rank, world = _world()
    dp, mp = (int(s) for s in shape)
    if dp * mp != world:
        raise ValueError(f"mesh shape {(dp, mp)} needs {dp * mp} ranks; "
                         f"the process group has {world}")
    default = dist.group.WORLD
    if _MESHES_OF[0] is not default:
        _MESHES.clear()
        _MESHES_OF[0] = default
    if (dp, mp) not in _MESHES:
        d, m = divmod(rank, mp)
        groups, ranks = {}, {}
        # every rank makes every group, in the same order
        for row in range(dp):
            members = [row * mp + c for c in range(mp)]
            g = dist.new_group(members)
            if row == d:
                groups["model"], ranks["model"] = g, members
        for col in range(mp):
            members = [r * mp + col for r in range(dp)]
            g = dist.new_group(members)
            if col == m:
                groups["data"], ranks["data"] = g, members
        _MESHES[(dp, mp)] = Mesh((dp, mp), rank, groups, ranks)
    return _MESHES[(dp, mp)]


def parse_mesh_spec(spec: str, world: int) -> Tuple[int, int]:
    """``(dp, mp)`` of a spec string: ``"auto"`` (or ``""``) is ``(1,
    world)``, pure tensor parallelism; ``"dp,mp"`` (``"2x4"`` too) names
    the axis sizes."""
    if spec in ("", "auto"):
        return (1, world)
    try:
        parts = [int(x) for x in spec.replace("x", ",").split(",")]
    except ValueError:
        parts = []
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise ValueError(f"mesh spec {spec!r}: want 'dp,mp', e.g. '2,4', "
                         f"or 'auto'")
    return tuple(parts)


def make_serving_mesh(spec: str = "auto") -> Mesh:
    """Serving mesh from a spec string, always ``("data", "model")``, as
    in JAX: ``"auto"`` (or ``""``) puts every rank on the model axis,
    ``(1, world)``; ``"dp,mp"`` (``"2,4"``; ``"2x4"`` too) sets the axis
    sizes, whose product must be the world size."""
    _, world = _world()
    return make_mesh(parse_mesh_spec(spec, world))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
