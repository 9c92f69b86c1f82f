"""Parameter sharding rules: tensor parallelism over the mesh.

Counterpart of the JAX package's `parallel/sharding.py` (no DL4J
analog). The rule table is the reference's: ordered (path regex,
PartitionSpec) pairs matched against parameter paths ("3/W" in a
MultiLayerNetwork, "res2a_a_conv/W" in a graph); the first match whose
spec fits the leaf's rank wins, and no match is replicated.

Where the reference hands the specs to XLA's partitioner, the port places
each leaf's piece on its rank itself (`shard_params`) and the fit path
gathers the pieces where the whole tensor is used (`parallel/plan.py`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, P, PartitionSpec, Placement, shard_dim,
)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (path_regex, PartitionSpec) table. First match wins; no
    match -> replicated."""
    rules: Tuple[Tuple[str, PartitionSpec], ...] = ()

    @staticmethod
    def data_parallel() -> "ShardingRules":
        """Pure DP: all params replicated."""
        return ShardingRules(())

    @staticmethod
    def megatron(dense_pattern: str = r".*/W$") -> "ShardingRules":
        """Every kernel named W sharded on its output dim over "model"
        (column-parallel), the reference's default for wide MLP stacks."""
        return ShardingRules(((dense_pattern, P(None, MODEL_AXIS)),))

    def spec_for(self, path: str, ndim: int) -> PartitionSpec:
        for pattern, spec in self.rules:
            if re.match(pattern, path):
                if len(spec) <= ndim:
                    return spec
        return P()


def logical_to_mesh(mesh: Mesh, spec: PartitionSpec) -> Placement:
    return Placement(mesh, spec)


def local_piece(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh
                ) -> torch.Tensor:
    """This rank's piece of `t` under `spec` (a copy; whole along every
    dim the spec leaves free or whose axis has degree 1)."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        out = shard_dim(out, dim, mesh.shape[axis], mesh.index(axis))
    return out.clone() if out is not t else t


def shard_params(params, mesh: Mesh, rules: Optional[ShardingRules] = None):
    """This rank's pieces of a parameter tree under the rules; unmatched
    leaves stay whole. Structure-preserving: empty dicts (paramless
    layers) survive."""
    rules = rules or ShardingRules.data_parallel()

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        spec = rules.spec_for(prefix[:-1], getattr(node, "ndim", 0))
        return local_piece(node, spec, mesh)

    return walk(params)
