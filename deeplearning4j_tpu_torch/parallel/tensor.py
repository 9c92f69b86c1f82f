"""Tensor- and expert-parallel compute over the mesh's ``model`` axis.

The port's own module (the reference leaves the split to XLA's SPMD
partitioner). Under an engaged `ShardingPlan` with ``model > 1``
(`parallel/plan.PlanRuntime`), the layers that compute split receive
their rule-split kernels as this rank's pieces and run with the model
group's collectives below, Megatron's four conjugate pairs, each a
`torch.autograd.Function`:

- `copy_to_model`: identity forward, all-reduce of the cotangent backward
  (the input of a column-parallel product);
- `reduce_from_model`: all-reduce forward, identity backward (the output
  of a row-parallel product);
- `gather_from_model`: all-gather along a dim forward, this rank's slice
  of the cotangent backward (a column-parallel output the next layer
  needs whole);
- `model_slice`: this rank's slice forward, all-gather of the cotangent
  pieces backward (a replicated leaf a split layer uses only in part: a
  column-parallel layer's bias, the MoE's per-expert biases and gates;
  every rank ends with the whole gradient of the leaf, the pieces' sum).

They use only all_reduce and all_gather_into_tensor, which gloo carries on
CUDA tensors as on CPU ones. Each is reported to its `ModelGroup`'s
`on_sync` hook with its bytes and host seconds (a gloo collective returns
when it is done, an NCCL one when it is queued), which the plan runtime
counts (``PlanRuntime.syncs`` and ``PlanRuntime.model_collectives``).

The layers find the group with `active()`, inside the `engaged` block that
the containers' forward enters under a plan that splits compute, and
decide what to split from the shapes they are handed: a kernel narrower
than the layer's configuration is this rank's piece. The layers that
compute split, and the leaf specs under which they do, are declared on
each layer class (``TP_GROUPS``; `split_leaves` reads them).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

MODEL = "model"


class ModelGroup:
    """This rank's place on the ``model`` axis: the process group (None on
    a one-rank mesh), its size and this rank's index; `on_sync(nbytes,
    seconds)` is called once for each collective it runs."""

    def __init__(self, group, size: int, index: int, on_sync=None):
        self.group, self.size, self.index = group, int(size), int(index)
        self.on_sync = on_sync

    def _collective(self, op, t: torch.Tensor):
        if self.on_sync is None:
            op()
            return
        t0 = time.perf_counter()
        op()
        self.on_sync(t.numel() * t.element_size(), time.perf_counter() - t0)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the group, into a new tensor."""
        out = t.contiguous().clone()
        if self.size > 1:
            self._collective(
                lambda: dist.all_reduce(out, group=self.group), out)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's pieces of `t` along `dim`, joined in rank order."""
        if self.size == 1:
            return t
        dim = dim % t.dim()
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * moved.shape[0],)
                          + tuple(moved.shape[1:]), dtype=t.dtype,
                          device=t.device)
        self._collective(lambda: dist.all_gather_into_tensor(
            out, moved, group=self.group), out)
        return out.movedim(0, dim)

    def piece(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of `t` along `dim` (a view)."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


# ----------------------------------------------------------- the functions
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return mg.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return mg.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.piece(g, ctx.dim).contiguous(), None, None


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return mg.piece(x, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.all_gather(g, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _CopyToModel.apply(x, mg) if mg.size > 1 else x


def reduce_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mg) if mg.size > 1 else x


def gather_from_model(x: torch.Tensor, mg: ModelGroup,
                      dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, mg, dim) if mg.size > 1 else x


def model_slice(x: torch.Tensor, mg: ModelGroup,
                dim: int = -1) -> torch.Tensor:
    return _ModelSlice.apply(x, mg, dim) if mg.size > 1 else x


# ------------------------------------------------------ the layers' context
_ACTIVE: list = []


def active() -> Optional[ModelGroup]:
    """The model group of the forward running now, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def engaged(mg: Optional[ModelGroup]):
    """The split layers compute over `mg` inside the block (None: no
    change)."""
    if mg is None:
        yield
        return
    _ACTIVE.append(mg)
    try:
        yield
    finally:
        _ACTIVE.pop()


def require(layer) -> ModelGroup:
    """The active model group for a layer handed pieces; raises outside
    one (a piece can only come from an engaged plan)."""
    mg = active()
    if mg is None:
        raise RuntimeError(
            f"{type(layer).__name__} was handed a split kernel outside a "
            "tensor-parallel forward (engage the plan through fit(plan=) "
            "or ParallelInference(plan=))")
    return mg


# --------------------------------------------------------- the split layers
def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           n_out: int, layer=None) -> torch.Tensor:
    """``x @ w + b`` for a (n_in, n_out) kernel `w`; when `w` is this
    rank's column piece, the column-parallel product: this rank's columns
    (and its slice of the replicated bias), gathered whole."""
    if w.shape[-1] == n_out:
        y = x @ w
        return y if b is None else y + b
    mg = require(layer)
    y = copy_to_model(x, mg) @ w
    if b is not None:
        y = y + model_slice(b, mg)
    return gather_from_model(y, mg)


def split_leaves(layer, specs: dict) -> Optional[set]:
    """Of a layer's rule-split leaves (`specs`: path within the layer ->
    effective spec, split leaves only), the set it computes with as
    pieces: every split leaf must lie in one of the layer class's
    ``TP_GROUPS`` ({leaf path: spec} dicts) whose leaves all carry the
    group's specs. None when some split leaf is in no such group, or the
    layer draws weight noise (its masks would differ by rank): the layer
    then gathers them all at use."""
    if getattr(layer, "weight_noise", None) is not None:
        return None
    covered = set()
    for group in getattr(layer, "TP_GROUPS", ()):
        if all(specs.get(k) == s for k, s in group.items()):
            covered |= set(group)
    return set(specs) if covered >= set(specs) and specs else None
