"""Device mesh over the process group, and its placement descriptors.

Counterpart of the JAX package's `parallel/mesh.py`. The reference builds
a `jax.sharding.Mesh` over the local devices of one process; the port has
one rank per process and builds its mesh over the world of the process
group (`torch.distributed.device_mesh.init_device_mesh`), with the
reference's axis names. `MeshConfig.resolve` is the reference's, so the
same extents fail with the same errors. The ``seq`` and ``stage`` axes are
resolved and validated; a degree above 1 on them comes with the sequence
and pipeline slice (ROADMAP A.15b).

A rank's place in the mesh is row-major over (data, model), as the
reference's ``reshape(d, p, s, m)``: rank = data_index * model + model_index.
`data_sharding`/`replicated_sharding` describe placements (a mesh and a
partition spec), the port's stand-in for `NamedSharding`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"


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
    """A (data, model) mesh over the ranks of the process group.

    `shape` maps axis names to degrees, as the reference's `mesh.shape`.
    `group(axis)` is the process group of the ranks that share this
    rank's place on the other axis (None when there is no process group:
    a one-rank mesh, whose collectives are identities). `index(axis)` is
    this rank's coordinate on `axis`."""

    def __init__(self, data: int, model: int, device_type: str = "cpu"):
        self.shape = {DATA_AXIS: int(data), MODEL_AXIS: int(model)}
        self.device_type = device_type
        self.device_mesh = None
        self._coords = (0, 0)
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                device_type, (data, model),
                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
            rank = dist.get_rank()
            self._coords = (rank // model, rank % model)

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self._coords[0 if axis == DATA_AXIS else 1]

    def __repr__(self):
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, "
                f"device_type={self.device_type!r})")


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None,
               device_type: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the world of the process group (one
    rank without a group). `devices`, when given, must number the world's
    ranks: the port has one device per rank."""
    config = config or MeshConfig()
    world = _world_size()
    if devices is not None and len(list(devices)) != world:
        raise ValueError(f"{len(list(devices))} devices named for a "
                         f"process group of {world} ranks (one device "
                         "per rank)")
    d, m, s, p = config.resolve(world)
    if s != 1 or p != 1:
        raise NotImplementedError(
            f"seq={s}, stage={p}: sequence and pipeline parallelism come "
            "with the next slice of the port (ROADMAP A.15b)")
    if device_type is None:
        device_type = "cuda" if dist.is_initialized() \
            and dist.get_backend() == "nccl" else "cpu"
    return Mesh(d, m, device_type)


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
