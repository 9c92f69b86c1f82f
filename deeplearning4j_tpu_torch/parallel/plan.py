"""One mesh, one step: the sharding plan of both containers' fit.

Counterpart of the JAX package's `parallel/plan.py`. A `ShardingPlan`
names a (data, model) mesh, a per-leaf rule table (`ShardingRules`), a
ZeRO stage, and the batch split, and the containers' own fit runs it:
``net.fit(..., plan=plan)``, or process-wide under `use_mesh`. The
dataclass, its spec derivation (`param_spec`, `state_spec`, the ``data``
overlay rule), `use_mesh`, `active_plan` and `parse_plan` are the
reference's.

Where the reference hands the specs to XLA's SPMD partitioner, the port
runs one process per rank and does the partitioner's work itself, in
`PlanRuntime`, engaged on a network for the length of a fit:

- The batch: every rank reads the global batch and keeps its contiguous
  block of rows (rank order over ``data``). A batch whose size the data
  degree does not divide runs whole on every rank, with a one-time
  warning (the reference stages it unsharded); its gradient, loss and
  layer state are still meaned over ``data``, so ranks that drew
  different dropout masks apply one update.
- Data parallelism: each rank's loss is scaled by its share of the global
  loss's normalizer (its rows, or its labels-mask count, over the global
  batch's), so the SUM over ``data`` of the ranks' gradients is the
  global batch's gradient, ragged masks included. The sum is one
  hand-written all-reduce of a flat buffer per dtype between backward and
  the updater (the loss rides in it). DDP is not used: it needs an
  `nn.Module`, which the containers' parameter dicts are not, and the
  step takes its gradients in one `autograd.grad`, so there is no
  backward for DDP's buckets to overlap.
- ZeRO-1: optimizer state lives in pieces (the ``data`` overlay dim);
  each rank runs the updater on its piece of the reduced gradient and of
  the parameters, and the updated pieces are all-gathered into the whole
  parameters.
- ZeRO-3 and rule-sharded (Megatron) parameters: parameters are stored
  in pieces too, and the fit gathers the whole tensor where it is used
  (before the forward), so the forward and backward run the plain
  layers; the gradient of a piece is the piece of the whole gradient.
  Tensor-parallel compute (split matmuls) is not done here: every
  ``model`` rank runs the whole forward and backward, so a plan with
  ``model > 1`` splits storage and pays the gathers but splits no work
  (ROADMAP A.15c). Engaging one logs a one-time warning saying so.
- A global-norm clip inside the updater measures the whole gradient, and
  Lars's trust ratio each whole leaf: the pieces' squares meet in one
  all-reduce (`nn/updaters.global_norm`, `leaf_norms`).

At the fit's end the network holds whole tensors again (`release`).
Collectives are issued on the stream of the step, so a CUDA graph of the
step (`fit(scan_steps=K)`) captures them under NCCL; under gloo a captured
step raises before it starts (`check_capturable`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, MeshConfig, P, PartitionSpec, Placement,
    all_gather_dim, all_reduce_flat, build_mesh, shard_dim,
)
from deeplearning4j_tpu_torch.parallel.sharding import (
    ShardingRules, local_piece,
)
from deeplearning4j_tpu_torch.parallel.zero import (
    VALID_STAGES, overlay_data_spec,
)

log = logging.getLogger("deeplearning4j_tpu_torch")

def _pad_spec(spec: PartitionSpec, ndim: int) -> PartitionSpec:
    """A rule spec longer than the leaf's rank degrades to replicated."""
    if len(spec) > ndim:
        return P()
    return spec


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Declarative parallelism: mesh extents + per-leaf specs + ZeRO.

    ``data=-1`` means "all remaining ranks". ``rules=None`` is pure data
    parallelism. Frozen and comparable: a changed plan drops the
    network's captured steps."""

    data: int = -1
    model: int = 1
    rules: Optional[ShardingRules] = None
    zero_stage: int = 0
    #: prebuilt mesh (ParallelWrapper hands in its own); None -> built
    #: from the data/model extents over the process group's world
    mesh_override: Optional[Mesh] = None

    def __post_init__(self):
        if self.zero_stage not in VALID_STAGES:
            raise ValueError(
                f"zero_stage must be one of {VALID_STAGES} (got "
                f"{self.zero_stage}); stage 2 is subsumed by stage 1 — "
                "the reduce-scattered gradient never materializes whole")

    @classmethod
    def for_mesh(cls, mesh: Mesh, rules: Optional[ShardingRules] = None,
                 zero_stage: int = 0) -> "ShardingPlan":
        return cls(data=int(mesh.shape.get(DATA_AXIS, 1)),
                   model=int(mesh.shape.get(MODEL_AXIS, 1)),
                   rules=rules, zero_stage=zero_stage, mesh_override=mesh)

    # ----------------------------------------------------------- topology
    def mesh(self) -> Mesh:
        if self.mesh_override is not None:
            return self.mesh_override
        pg = dist.group.WORLD if dist.is_initialized() else None
        key = (self.data, self.model)
        cached = _MESH_CACHE.get(key)
        if cached is None or cached[0] is not pg:
            cached = (pg, build_mesh(MeshConfig(data=self.data,
                                                model=self.model)))
            _MESH_CACHE[key] = cached
        return cached[1]

    @property
    def data_degree(self) -> int:
        return int(self.mesh().shape[DATA_AXIS])

    @property
    def model_degree(self) -> int:
        return int(self.mesh().shape.get(MODEL_AXIS, 1))

    def describe(self) -> dict:
        """JSON-able summary (checkpoint extras, logs)."""
        return {"data": self.data_degree, "model": self.model_degree,
                "zero_stage": self.zero_stage,
                "rules": None if self.rules is None
                else [[pat, str(spec)] for pat, spec in self.rules.rules]}

    # ------------------------------------------------------------- specs
    def _rule_spec(self, path: str, ndim: int) -> PartitionSpec:
        if self.rules is None:
            return P()
        return _pad_spec(self.rules.spec_for(path, ndim), ndim)

    def param_spec(self, path: str, leaf) -> PartitionSpec:
        """Stored-parameter layout: the rules, plus the ``data`` overlay
        at stage 3."""
        shape = tuple(getattr(leaf, "shape", ()))
        spec = self._rule_spec(path, len(shape))
        if self.zero_stage == 3:
            spec = overlay_data_spec(spec, shape, self.data_degree)
        return spec

    def state_spec(self, path: str, leaf) -> PartitionSpec:
        """Gradient/update/optimizer-moment layout: the rules, plus the
        ``data`` overlay at any ZeRO stage."""
        shape = tuple(getattr(leaf, "shape", ()))
        spec = self._rule_spec(path, len(shape))
        if self.zero_stage >= 1:
            spec = overlay_data_spec(spec, shape, self.data_degree)
        return spec

    def batch_sharding(self) -> Placement:
        return Placement(self.mesh(), P(DATA_AXIS))

    def shard_batch(self, a, stacked: bool = False):
        """This rank's block of one batch array: dim 0 (dim 1 for a
        stacked (K, B, ...) array) split over ``data`` in rank order. A
        batch dim the data degree does not divide stays whole, with a
        one-time warning."""
        if a is None:
            return None
        dim = 1 if stacked else 0
        shape = tuple(np.shape(a))
        n = self.data_degree
        if len(shape) <= dim or shape[dim] % n:
            _warn_ragged(shape, n)
            return a
        b = shape[dim] // n
        i = self.mesh().index(DATA_AXIS)
        idx = (slice(None),) * dim + (slice(i * b, (i + 1) * b),)
        return a[idx]


#: (data, model) -> (process group, Mesh): equal plans share a mesh
#: while the process group that built it lives
_MESH_CACHE: dict = {}
_warned_ragged_batch: list = []
_warned_model_compute: list = []


def _warn_ragged(shape, n_data):
    if not _warned_ragged_batch:
        _warned_ragged_batch.append(True)
        log.warning(
            "ShardingPlan: batch shape %s not divisible by data degree "
            "%d — staging unsharded (correct but slower; use drop_last "
            "for uniform shapes)", tuple(shape), n_data)


# -------------------------------------------------------- process context
_ACTIVE: List[ShardingPlan] = []


def active_plan() -> Optional[ShardingPlan]:
    """The innermost `use_mesh` plan, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(plan: ShardingPlan):
    """Process-wide plan activation::

        with parallel.use_mesh(ShardingPlan(data=8)):
            net.fit(iterator)      # existing call, now data-parallel
    """
    if not isinstance(plan, ShardingPlan):
        raise TypeError(f"use_mesh expects a ShardingPlan, got "
                        f"{type(plan).__name__}")
    _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        _ACTIVE.pop()


def parse_plan(spec: str) -> ShardingPlan:
    """CLI surface: ``"data=4,model=2,zero=1,rules=megatron"`` ->
    ShardingPlan. Unknown keys fail loudly."""
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--mesh entry {part!r} is not key=value")
        k, v = (s.strip() for s in part.split("=", 1))
        if k in ("data", "dp"):
            kw["data"] = int(v)
        elif k in ("model", "tp"):
            kw["model"] = int(v)
        elif k in ("zero", "zero_stage"):
            kw["zero_stage"] = int(v)
        elif k == "rules":
            if v != "megatron":
                raise ValueError(f"unknown rules preset {v!r} "
                                 "(known: megatron)")
            kw["rules"] = ShardingRules.megatron()
        else:
            raise ValueError(f"unknown --mesh key {k!r} "
                             "(known: data, model, zero, rules)")
    return ShardingPlan(**kw)


def leaf_shard_shape(leaf) -> Tuple[int, ...]:
    """Shape of a leaf as this rank stores it."""
    return tuple(np.shape(leaf))


# ================================================================ runtime
def _walk(tree, fn, prefix=""):
    """`fn(path, leaf)` over the tensor leaves of nested dicts, keeping
    the structure (empty dicts survive)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _congruent(node, params) -> bool:
    """Whether `node` has the parameter tree's structure (optimizer
    moments, whole or in pieces; a masked leaf of multi_transform is an
    empty dict)."""
    if isinstance(params, dict):
        return isinstance(node, dict) and set(node) == set(params) \
            and all(_congruent(node[k], params[k]) for k in params)
    if isinstance(node, dict):
        return node == {}
    return isinstance(node, torch.Tensor) and node.ndim == params.ndim


class PlanRuntime:
    """A plan engaged on one network for a fit (see the module doc)."""

    def __init__(self, plan: ShardingPlan, net):
        self.plan = plan
        self.mesh = plan.mesh()
        self.n_data = self.mesh.shape[DATA_AXIS]
        self.n_model = self.mesh.shape[MODEL_AXIS]
        self.data_index = self.mesh.index(DATA_AXIS)
        self.grouped = self.mesh.grouped
        if self.n_model > 1 and not _warned_model_compute:
            _warned_model_compute.append(True)
            log.warning(
                "ShardingPlan: model=%d splits the parameters' storage "
                "only; every model rank gathers the whole tensors and "
                "computes the whole forward and backward (tensor-parallel "
                "compute is ROADMAP A.15c)", self.n_model)
        #: collectives issued (a host counter: a captured step counts
        #: its collectives once, when it is captured)
        self.syncs = 0
        whole = net.params
        #: (shape, dtype) of each whole parameter, in tree_leaves order
        self.whole_shapes = [(t.shape, t.dtype) for _, t in _paths(whole)]
        self.param_specs = {p: self._effective(plan.param_spec(p, leaf))
                            for p, leaf in _paths(whole)}
        self.state_specs = {p: self._effective(plan.state_spec(p, leaf))
                            for p, leaf in _paths(whole)}
        self.sharded_params = any(self.param_specs.values())
        self.sharded_state = any(self.state_specs.values())
        net.params = self._pieces(whole, self.param_specs)
        if self.sharded_state:
            net.opt_state = self._opt_pieces(net.opt_state, whole)

    # -------------------------------------------------------------- specs
    def _effective(self, spec: PartitionSpec) -> PartitionSpec:
        """The spec with axes of degree 1 dropped (P() when nothing is
        split on this mesh)."""
        dims = [a if a is not None and self.mesh.shape[a] > 1 else None
                for a in spec]
        while dims and dims[-1] is None:
            dims.pop()
        return P(*dims)

    def _pieces(self, tree, specs):
        return _walk(tree, lambda p, t: local_piece(t, specs[p], self.mesh)
                     if specs[p] else t)

    def _opt_walk(self, node, params, fn):
        """`fn(path, leaf)` over each params-congruent subtree's leaves;
        other leaves (step counters) stay as they are: no dim of theirs
        splits."""
        if _congruent(node, params) and isinstance(node, dict) and node:
            return _walk(node, lambda p, t: t if isinstance(t, dict)
                         else fn(p, t))
        if isinstance(node, dict):
            return {k: self._opt_walk(v, params, fn) for k, v in node.items()}
        return node

    def _opt_pieces(self, opt_state, whole):
        return self._opt_walk(
            opt_state, whole,
            lambda p, t: local_piece(t, self.state_specs[p], self.mesh)
            if self.state_specs[p] else t)

    def _gather(self, t: torch.Tensor, spec: PartitionSpec,
                base: PartitionSpec = P()) -> torch.Tensor:
        """The whole of piece `t` along every dim `spec` splits and `base`
        does not."""
        for dim, axis in enumerate(spec):
            if axis is None or (dim < len(base) and base[dim] == axis):
                continue
            t = all_gather_dim(t, dim, self.mesh.group(axis),
                               self.mesh.shape[axis])
            self.syncs += 1
        return t

    # ------------------------------------------------------ whole tensors
    def full_params(self, params):
        """The whole parameters from this rank's pieces (the forward's
        gather-at-use)."""
        if not self.sharded_params:
            return params
        with torch.no_grad():
            return _walk(params, lambda p, t: self._gather(
                t, self.param_specs[p]) if self.param_specs[p] else t)

    def full_opt_state(self, opt_state, params_whole):
        if not self.sharded_state:
            return opt_state
        with torch.no_grad():
            return self._opt_walk(
                opt_state, params_whole,
                lambda p, t: self._gather(t, self.state_specs[p])
                if self.state_specs[p] else t)

    def release(self, net):
        """Whole tensors back on the network (the fit's end)."""
        if self.sharded_params or self.sharded_state:
            whole = self.full_params(net.params)
            net.opt_state = self.full_opt_state(net.opt_state, whole)
            net.params = whole

    @contextlib.contextmanager
    def whole_view(self, net):
        """The network holds whole tensors inside the block (a checkpoint
        save), its pieces again after it. Collective: every rank
        enters."""
        if not (self.sharded_params or self.sharded_state):
            yield
            return
        pieces = (net.params, net.opt_state)
        whole = self.full_params(net.params)
        net.opt_state = self.full_opt_state(net.opt_state, whole)
        net.params = whole
        try:
            yield
        finally:
            net.params, net.opt_state = pieces

    # -------------------------------------------------------------- batch
    def local_batch(self, struct, loss_mask):
        """(this rank's block of the batch struct, its loss scale). The
        scale is its share of the global loss's normalizer; a batch that
        does not split runs whole on every rank at scale 1 / n_data, so
        the reduced gradient is the ranks' mean (their dropout masks
        differ)."""
        from deeplearning4j_tpu_torch.nn import step_graph
        leaves = step_graph.flatten(struct)
        B = int(np.shape(leaves[0])[0])
        if B % self.n_data:
            _warn_ragged(np.shape(leaves[0]), self.n_data)
            return struct, 1.0 / self.n_data
        if self.n_data == 1:
            return struct, 1.0
        local = step_graph.unflatten(struct, [
            self.plan.shard_batch(a) if a is not None and np.ndim(a) >= 1
            else a for a in leaves])
        if loss_mask is None:
            return local, 1.0 / self.n_data
        mine = self.plan.shard_batch(loss_mask)
        if isinstance(loss_mask, torch.Tensor):
            total = loss_mask.float().sum().clamp_min(1.0)
            return local, mine.float().sum() / total
        total = max(float(np.sum(loss_mask, dtype=np.float64)), 1.0)
        return local, float(np.sum(mine, dtype=np.float64)) / total

    def generator_offset(self) -> int:
        """Each data rank draws its own dropout noise: its generator's
        seed is offset by 1000003 x its data index (0 on rank 0)."""
        return 1000003 * self.data_index

    # -------------------------------------------------------- collectives
    def _all_reduce(self, tensors: List[torch.Tensor], group
                    ) -> List[torch.Tensor]:
        """SUM of each tensor over `group` (one collective per dtype)."""
        self.syncs += len({t.dtype for t in tensors})
        return all_reduce_flat(tensors, group)

    def reduce_grads(self, grads, loss):
        """The data group's sum of the (already share-scaled) gradients
        and loss."""
        if not self.grouped:
            return grads, loss
        from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
        paths = [p for p, _ in _paths(grads)]
        leaves = tree_leaves(grads)
        extra = [] if loss is None else [loss.reshape(1)]
        summed = self._all_reduce(leaves + extra,
                                  self.mesh.group(DATA_AXIS))
        by_path = dict(zip(paths, summed))
        grads = _walk(grads, lambda p, t: by_path[p])
        if loss is not None:
            loss = summed[-1].reshape(())
        return grads, loss

    def reduce_state(self, new_state):
        """The data group's mean of the floating layer state (batch-norm
        statistics): replicas keep one state."""
        if not self.grouped or self.n_data == 1:
            return new_state
        items = [(p, t) for p, t in _paths(new_state)
                 if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if not items:
            return new_state
        summed = self._all_reduce([t for _, t in items],
                                  self.mesh.group(DATA_AXIS))
        by_path = {p: s / self.n_data for (p, _), s in zip(items, summed)}
        return _walk(new_state, lambda p, t: by_path.get(p, t))

    def _held(self, path: str) -> int:
        """How many ranks hold the same piece of leaf `path` (its state
        spec's)."""
        held = self.n_data * self.n_model
        for axis in self.state_specs.get(path, P()):
            if axis is not None:
                held //= self.mesh.shape[axis]
        return held

    def _summed_squares(self, trees) -> List[torch.Tensor]:
        """For each tree of state-spec pieces, each leaf's squares summed
        over the whole leaf: every distinct piece counted once over the
        world, all leaves in one all-reduce. Flat, trees in order."""
        sqs = [(t * t).sum() / self._held(p)
               for tree in trees for p, t in _paths(tree)
               if not isinstance(t, dict)]
        if not sqs:
            return []
        dtype = sqs[0].dtype
        for t in sqs[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        total = torch.stack([t.to(dtype) for t in sqs])
        if self.grouped:
            dist.all_reduce(total)
            self.syncs += 1
        return list(total.unbind())

    def global_norm(self, updates) -> torch.Tensor:
        """||g|| of a tree of state-spec pieces."""
        sqs = self._summed_squares([updates])
        if not sqs:
            return torch.zeros(())
        return torch.sqrt(torch.stack(sqs).sum())

    def leaf_norms(self, *trees) -> List[List[torch.Tensor]]:
        """Per tree, each whole leaf's norm from this rank's pieces (Lars's
        trust ratio), the trees' squares in one all-reduce."""
        flat = [torch.sqrt(t) for t in self._summed_squares(trees)]
        out, ofs = [], 0
        for tree in trees:
            n = sum(1 for _, t in _paths(tree) if not isinstance(t, dict))
            out.append(flat[ofs:ofs + n])
            ofs += n
        return out

    # --------------------------------------------------------------- step
    def apply(self, net, grads, loss):
        """Reduce, update and write back; returns the global loss."""
        grads, loss = self.reduce_grads(grads, loss)
        if not self.sharded_state:
            net._update(grads)
            return loss
        from deeplearning4j_tpu_torch.nn import step_graph, updaters
        from deeplearning4j_tpu_torch.nn.regularization import (
            apply_constraints,
        )
        with torch.no_grad():
            # the state-spec pieces of the gradient and of the stored
            # parameters (views: an update lands in the stored tensor)
            g_s = _walk(grads, lambda p, t: local_piece_view(
                t, self.state_specs[p], P(), self.mesh))
            p_s = _walk(net.params, lambda p, t: local_piece_view(
                t, self.state_specs[p], self.param_specs[p], self.mesh))
            with updaters.global_norm_hook(self.global_norm,
                                          self.leaf_norms):
                updates, new_opt = net._tx.update(g_s, net.opt_state, p_s)
            updaters.apply_updates(p_s, updates)
            # pieces finer than the stored layout (ZeRO-1) gathered back
            for (p, stored), (_, piece) in zip(_paths(net.params),
                                               _paths(p_s)):
                if self.state_specs[p] != self.param_specs[p]:
                    stored.copy_(self._gather(piece, self.state_specs[p],
                                              self.param_specs[p]))
            if net._constraints:
                whole = self.full_params(net.params)
                apply_constraints(net._constraints, whole)
                for (p, stored), (_, w) in zip(_paths(net.params),
                                               _paths(whole)):
                    if w is not stored:
                        stored.copy_(local_piece_view(
                            w, self.param_specs[p], P(), self.mesh))
            step_graph.commit(net.opt_state, new_opt)
        return loss


def local_piece_view(t: torch.Tensor, spec: PartitionSpec,
                     base: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The piece of `t` (stored under `base`) that `spec` gives this
    rank, as a view: narrowed along every dim `spec` splits and `base`
    does not."""
    for dim, axis in enumerate(spec):
        if axis is None or (dim < len(base) and base[dim] == axis):
            continue
        t = shard_dim(t, dim, mesh.shape[axis], mesh.index(axis))
    return t


def check_capturable(device: torch.device):
    """A captured train step (scan or accumulate on CUDA) under a plan
    needs collectives a CUDA graph can hold: NCCL's. Gloo's cannot be
    captured, so the fit refuses before it starts."""
    if device.type != "cuda" or not dist.is_initialized():
        return
    backend = str(dist.get_backend())
    if backend != "nccl":
        raise RuntimeError(
            f"fit(scan_steps>1 or accumulate_steps>1) under a sharding "
            f"plan captures the step's collectives in a CUDA graph, which "
            f"the {backend!r} backend cannot; use NCCL, or scan_steps=1")
