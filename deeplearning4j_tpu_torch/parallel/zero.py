"""ZeRO-style optimizer-state and parameter sharding.

Counterpart of the JAX package's `parallel/zero.py` (no DL4J analog: the
reference's workers each keep a whole parameter and updater copy). A
data-parallel group of N ranks needs only 1/N of the optimizer state
resident per rank (stage 1) and of the parameters too (stage 3). As in
the reference since its plan landed, this module is a thin shim over
`parallel/plan.py`: the one sharding rule is `overlay_data_spec`
(the ``data`` axis on the first evenly-divisible dim; leaves with none
stay whole), and the fit path (`plan.PlanRuntime`) does the placement:

  stage 1 — optimizer state in pieces, parameters whole: each rank
      updates its piece of the reduced gradient and the updated pieces
      are all-gathered into the parameters.
  stage 3 — parameters in pieces too, gathered whole for the forward.
"""
from __future__ import annotations

from typing import List, Tuple

from deeplearning4j_tpu_torch.nn.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, P, PartitionSpec,
)
from deeplearning4j_tpu_torch.parallel.sharding import local_piece

VALID_STAGES = (0, 1, 3)


def overlay_data_spec(spec: PartitionSpec, shape: Tuple[int, ...],
                      n_data: int) -> PartitionSpec:
    """THE ZeRO sharding rule: overlay the ``data`` axis onto the first
    dimension the base `spec` leaves free and that splits evenly over
    `n_data`. Returns `spec` unchanged when nothing qualifies."""
    if n_data <= 1:
        return spec
    dims: List = list(spec) + [None] * (len(shape) - len(spec))
    for i, d in enumerate(dims):
        if d is None and shape[i] >= n_data and shape[i] % n_data == 0:
            dims[i] = DATA_AXIS
            break
    else:
        return spec
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


def zero_spec(leaf, n_shards: int):
    """PartitionSpec for one state leaf: the FIRST evenly-divisible dim
    sharded over "data", replicated when none divides."""
    return overlay_data_spec(P(), tuple(getattr(leaf, "shape", ())),
                             n_shards)


def zero_place(tree, mesh: Mesh):
    """This rank's pieces of a params/opt-state tree in the ZeRO layout."""
    n = mesh.shape[DATA_AXIS]
    return tree_map(lambda a: local_piece(a, zero_spec(a, n), mesh), tree)


def sharded_fraction(tree, mesh: Mesh) -> float:
    """Fraction of the tree's bytes that live sharded (diagnostic; 1.0
    means every byte is split N ways, 0.0 means fully replicated)."""
    n = mesh.shape[DATA_AXIS]
    total = 0
    sharded = 0
    for leaf in tree_leaves(tree):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        if zero_spec(leaf, n) != P():
            sharded += nbytes
    return sharded / total if total else 0.0
