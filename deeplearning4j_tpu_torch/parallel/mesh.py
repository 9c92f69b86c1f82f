"""Device mesh over the process group, and its placement descriptors.

Counterpart of the JAX package's `parallel/mesh.py`. The reference builds
a `jax.sharding.Mesh` over the local devices of one process; the port has
one rank per process and builds its mesh over the world of the process
group, with the reference's four axes in the reference's order, (data,
stage, seq, model). `MeshConfig.resolve` is the reference's, so the same
extents fail with the same errors.

Rank r has the coordinates of r in ``np.arange(world).reshape(d, p, s,
m)``, the reference's device layout: rank = ((data * p + stage) * s +
seq) * m + model. Every axis has its process group, formed when the mesh
is built (every rank builds it, at the same point of the program); a
group over several axes (``mesh.group(("data", "seq"))``) is formed on
its first request, which every rank must make at the same point too.
`data_sharding`/`replicated_sharding` describe placements (a mesh and a
partition spec), the port's stand-in for `NamedSharding`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
#: the reference's axis order (`build_mesh`'s reshape(d, p, s, m))
AXES = (DATA_AXIS, STAGE_AXIS, SEQ_AXIS, MODEL_AXIS)


class PartitionSpec(tuple):
    """Per-dimension mesh axis (or None) of a tensor's layout; trailing
    dimensions not named are whole. Written as the reference's
    `jax.sharding.PartitionSpec` prints."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + \
            ("," if len(self) == 1 else "") + ")"

    __str__ = __repr__


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How many ranks along each logical axis. ``data=-1`` means "all
    remaining ranks" (ParallelWrapper's `workers(n)`)."""
    data: int = -1
    model: int = 1
    seq: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        d, m, s, p = self.data, self.model, self.seq, self.stage
        if d == -1:
            if n_devices % (m * s * p):
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"model*seq*stage={m * s * p}")
            d = n_devices // (m * s * p)
        if d * m * s * p != n_devices:
            raise ValueError(
                f"mesh {d}x{p}x{s}x{m} != available devices {n_devices}")
        return d, m, s, p


class Mesh:
    """A (data, stage, seq, model) mesh over the ranks of the process
    group.

    `shape` maps axis names to degrees in the reference's axis order, as
    the reference's `mesh.shape`. `group(axis)` is the process group of
    the ranks that share this rank's place on every other axis; `axis`
    may be a tuple of axes (the group spans all of them). It is None when
    there is no process group: a one-rank mesh, whose collectives are
    identities. `index(axis)` is this rank's coordinate on `axis`."""

    def __init__(self, data: int, model: int = 1, device_type: str = "cpu",
                 seq: int = 1, stage: int = 1):
        self.shape = {DATA_AXIS: int(data), STAGE_AXIS: int(stage),
                      SEQ_AXIS: int(seq), MODEL_AXIS: int(model)}
        self.device_type = device_type
        self.grouped = dist.is_initialized()
        self._rank = dist.get_rank() if self.grouped else 0
        dims = tuple(self.shape[a] for a in AXES)
        self._coords = tuple(int(c) for c in np.unravel_index(
            self._rank, dims))
        self._groups: dict = {}
        if self.grouped:
            for axis in AXES:
                self._groups[(axis,)] = self._new_group((axis,))

    def _new_group(self, axes: Tuple[str, ...]):
        """Form the groups of `axes` (one for each place on the other
        axes: every rank takes part in forming each) and return this
        rank's."""
        dims = tuple(self.shape[a] for a in AXES)
        grid = np.arange(int(np.prod(dims))).reshape(dims)
        keep = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in keep]
        blocks = np.transpose(grid, rest + keep).reshape(
            -1, int(np.prod([dims[i] for i in keep])))
        mine = None
        for ranks in blocks:
            g = dist.new_group([int(r) for r in ranks])
            if self._rank in ranks:
                mine = g
        return mine

    def group(self, axis):
        if not self.grouped:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        key = tuple(a for a in AXES if a in axes)
        if key not in self._groups:
            self._groups[key] = self._new_group(key)
        return self._groups[key]

    def index(self, axis: str) -> int:
        return self._coords[AXES.index(axis)]

    def __repr__(self):
        return ("Mesh(" + ", ".join(f"{a}={n}" for a, n in self.shape.items())
                + f", device_type={self.device_type!r})")


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None,
               device_type: Optional[str] = None) -> Mesh:
    """A (data, stage, seq, model) mesh over the world of the process
    group (one rank without a group). `devices`, when given, must number
    the world's ranks: the port has one device per rank. Collective:
    every rank of the group builds it."""
    config = config or MeshConfig()
    world = _world_size()
    if devices is not None and len(list(devices)) != world:
        raise ValueError(f"{len(list(devices))} devices named for a "
                         f"process group of {world} ranks (one device "
                         "per rank)")
    d, m, s, p = config.resolve(world)
    if device_type is None:
        device_type = "cuda" if dist.is_initialized() \
            and dist.get_backend() == "nccl" else "cpu"
    return Mesh(d, m, device_type, seq=s, stage=p)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and a partition spec: where a tensor's pieces live (the
    port's `NamedSharding`)."""
    mesh: Mesh
    spec: PartitionSpec


def data_sharding(mesh: Mesh) -> Placement:
    """Batch dim over ``data``, for inputs and labels."""
    return Placement(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> Placement:
    """Whole on every rank (parameters in pure data parallelism)."""
    return Placement(mesh, P())


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The `n` ranks' pieces of `t` along `dim`, joined in rank order."""
    if n == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def shard_dim(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    """Piece `index` of `n` of `t` along `dim` (a view)."""
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def all_reduce_flat(tensors: List[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """SUM of each tensor over `group`: one flat buffer per dtype,
    reduced in place, split back into views of it."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        ofs = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[ofs:ofs + n].view(tensors[i].shape)
            ofs += n
    return out
