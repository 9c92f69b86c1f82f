"""Pipeline parallelism: the transformer torso split over the mesh's
``stage`` axis.

Counterpart of the JAX package's `parallel/pipeline.py`, a GPipe
schedule. The homogeneous torso (a contiguous run of identical
`TransformerBlock`s) is split over the ``stage`` group: stage s runs
blocks [s * L/S, (s + 1) * L/S). The batch splits into M microbatches
(each split over ``data`` as well); at each of the M + S - 1 ticks every
stage runs its blocks on what it holds and hands its activation, with
the microbatch's mask, to the next stage (`parallel/ring.rotate`: the
ring's autograd-aware shift, so the backward pipeline is autograd's
own). Bubble ticks carry an all-ones mask: their outputs are discarded,
and an all-zero mask would give NaNs in the softmax. Every stage's input
is `where(first stage, feed, received)`, uniform on every rank as in the
reference, so every rank's graph holds every shift and the backward
shifts pair up across the ring.

After the last tick the last stage holds every microbatch's output; it
is broadcast over ``stage`` (and gathered over ``data``) so the head runs
replicated on the whole batch and every rank computes the same loss. The
broadcast's backward passes the last stage its own cotangent, not the
stages' sum, so each block's gradient is the one a single device gives.
The embedding and the blocks get their gradient on one stage and one data
rank each: their gradients are summed over data x stage in one flat
all-reduce; the head's are already whole on every rank. Every rank then
applies the same update to its whole copy of the parameters.

Restrictions (checked at construction, the reference's): a contiguous
run of identical blocks whose count the stage degree divides, a final
output layer, no mixed precision, no layer state, no dropout.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, STAGE_AXIS, Mesh, MeshConfig, all_gather_dim, all_reduce_flat,
    build_mesh,
)


class _FromLastStage(torch.autograd.Function):
    """Forward: the last stage's tensor on every stage (a broadcast).
    Backward: the last stage keeps its own cotangent (every stage computes
    the same loss from it), the other stages' inputs get none."""

    @staticmethod
    def forward(ctx, x, group, src, is_last):
        ctx.is_last = is_last
        out = x.detach().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: the data ranks' rows joined along `dim`. Backward: this
    rank's rows of the cotangent (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        return all_gather_dim(x.contiguous(), dim, group, n)

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[ctx.dim] // ctx.n
        return (g.narrow(ctx.dim, ctx.index * rows, rows).contiguous(),
                None, None, None, None)


class PipelineParallelTrainer:
    """data x pipeline trainer for TransformerLM-shape MultiLayerNetworks.

    Usage (every rank of the process group)::

        mesh = build_mesh(MeshConfig(data=2, stage=4))
        trainer = PipelineParallelTrainer(net, mesh, n_microbatches=8)
        trainer.fit((X, Y), epochs=1, batch_size=32)
    """

    def __init__(self, model, mesh: Optional[Mesh] = None,
                 n_microbatches: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise ValueError("pipeline parallelism drives a "
                             "MultiLayerNetwork (TransformerLM shape)")
        if model.params is None:
            model.init()
        if mesh is None:
            from deeplearning4j_tpu_torch.parallel.distributed import (
                process_count,
            )
            mesh = build_mesh(MeshConfig(data=1, stage=process_count()))
        self.mesh = mesh
        self.stages = mesh.shape[STAGE_AXIS]
        self.data_degree = mesh.shape[DATA_AXIS]
        if self.stages < 2:
            raise ValueError("mesh needs a 'stage' axis of >= 2 for "
                             "pipeline parallelism")
        # the homogeneous block torso
        names = [type(layer).__name__ for layer in model.layers]
        block_idx = [i for i, n in enumerate(names)
                     if n == "TransformerBlock"]
        if not block_idx:
            raise ValueError("no TransformerBlock run to pipeline; "
                             "pipeline parallelism needs a homogeneous "
                             "block stack (TransformerLM shape)")
        if block_idx != list(range(block_idx[0], block_idx[-1] + 1)):
            raise ValueError("TransformerBlock run must be contiguous")
        confs = {model.layers[i] for i in block_idx}
        if len(confs) != 1:
            raise ValueError("pipelined blocks must share one identical "
                             f"conf; found {len(confs)} distinct")
        if len(block_idx) % self.stages:
            raise ValueError(
                f"{len(block_idx)} blocks not divisible by "
                f"{self.stages} stages")
        self.block_idx = block_idx
        self.block_conf = model.layers[block_idx[0]]
        self.pre_idx = list(range(0, block_idx[0]))
        self.post_idx = list(range(block_idx[-1] + 1, len(model.layers)))
        if not self.post_idx or \
                not hasattr(model.layers[self.post_idx[-1]], "score"):
            raise ValueError("last layer must be an output layer")
        if model._compute_dtype != model._param_dtype:
            raise ValueError(
                "pipeline path runs layers on uncast parameters; "
                "compute_dtype must equal the param dtype here (mixed "
                "precision pp is not implemented)")
        # the pipelined step threads no layer state: refuse stateful
        # layers rather than leave their statistics at their init values
        for i, layer in enumerate(model.layers):
            if model.state.get(str(i)):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) carries state; "
                    "the pp step does not thread state updates — use "
                    "stateless stacks (LN-based transformers)")
        dcfg = self.block_conf
        if getattr(dcfg, "attention_dropout", 0.0) or \
                getattr(dcfg, "residual_dropout", 0.0) or \
                getattr(dcfg, "dropout", 0.0):
            raise ValueError("pipelined TransformerBlocks must have "
                             "dropout 0 (the pp path applies no dropout)")
        for i in self.pre_idx + self.post_idx:
            if getattr(model.layers[i], "dropout", 0.0):
                raise ValueError("pre/post layers must have dropout 0 on "
                                 "the pipeline path")
        self.model = model
        self.n_microbatches = n_microbatches or 2 * self.stages
        self.stage = mesh.index(STAGE_AXIS)
        per = len(block_idx) // self.stages
        self.my_blocks = block_idx[self.stage * per:(self.stage + 1) * per]
        # formed now, on every rank at once (a group is collective)
        from deeplearning4j_tpu_torch.parallel.ring import Ring
        self._ring = Ring.of(mesh, STAGE_AXIS)
        self._stage_group = mesh.group(STAGE_AXIS)
        self._data_group = mesh.group(DATA_AXIS)
        self._group = mesh.group((DATA_AXIS, STAGE_AXIS))
        self._last = dist.get_global_rank(self._stage_group,
                                          self.stages - 1)
        #: collectives of the gradient exchange made so far
        self.syncs = 0

    # ---------------------------------------------------------------- step
    def _check_batch(self, b):
        mb = b // self.n_microbatches
        if b % self.n_microbatches or mb % self.data_degree:
            raise ValueError(
                f"batch {b} must split into {self.n_microbatches} "
                f"microbatches whose size is divisible by the data "
                f"degree {self.data_degree} (got microbatch {mb})")

    def _torso(self, params, hm, fm):
        """The GPipe schedule on this rank: hm (M, mb, T, D) and fm (M,
        mb, T) or None, this data rank's rows of each microbatch. Returns
        the last stage's outputs (M, mb, T, D) on every stage."""
        from deeplearning4j_tpu_torch.parallel.ring import rotate
        S, M = self.stages, self.n_microbatches
        block = self.block_conf
        first = torch.tensor(self.stage == 0, device=hm.device)
        zeros = torch.zeros_like(hm[0])
        ones = None if fm is None else torch.ones_like(fm[0])
        state, mstate = zeros, ones
        outs = []
        for t in range(M + S - 1):
            inp = torch.where(first, hm[t] if t < M else zeros, state)
            m = None if fm is None else \
                torch.where(first, fm[t] if t < M else ones, mstate)
            out = inp
            for i in self.my_blocks:
                out, _ = block.apply(params[str(i)], {}, out, train=True,
                                     mask=m, generator=None)
            if t >= S - 1:
                outs.append(out)
            if t + 1 < M + S - 1:
                (state,), mstate = rotate(self._ring, (out,), m)
        stacked = torch.stack(outs)
        return _FromLastStage.apply(stacked, self._stage_group, self._last,
                                    self.stage == S - 1)

    def _loss(self, params, x, y, fmask, lmask):
        net = self.model
        M = self.n_microbatches
        h = x
        for i in self.pre_idx:
            h, _ = net.layers[i].apply(params[str(i)], net.state.get(
                str(i), {}), h, train=True, mask=fmask, generator=None)
        B, T, D = h.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        nd, di = self.data_degree, self.mesh.index(DATA_AXIS)
        rows = mb // nd
        hm = h.reshape(M, mb, T, D)[:, di * rows:(di + 1) * rows]
        fm = None if fmask is None else \
            fmask.reshape(M, mb, T)[:, di * rows:(di + 1) * rows]
        outs = self._torso(params, hm, fm)
        if nd > 1:
            outs = _GatherRows.apply(outs, 1, self._data_group, nd, di)
        h = outs.reshape(B, T, D)
        for i in self.post_idx[:-1]:
            h, _ = net.layers[i].apply(params[str(i)], net.state.get(
                str(i), {}), h, train=True, mask=fmask, generator=None)
        out_mask = lmask if lmask is not None else fmask
        head = self.post_idx[-1]
        loss = net.layers[head].score(params[str(head)], h, y, train=True,
                                      generator=None, mask=out_mask)
        loss = loss.to(torch.promote_types(torch.float32, loss.dtype))
        # the regularization of the layers summed over data x stage is
        # taken at that share, so the sum is counted once
        share = 1.0 / (nd * self.stages)
        reg = torch.zeros((), dtype=loss.dtype, device=loss.device)
        reg_shared = torch.zeros_like(reg)
        for i, layer in enumerate(net.layers):
            r = layer.regularization_score(params[str(i)])
            if i in self.post_idx:
                reg = reg + r
            else:
                reg_shared = reg_shared + r
        return loss + reg + share * reg_shared, \
            (loss + reg + reg_shared).detach()

    def _step(self, x, y, fm, lm) -> torch.Tensor:
        net = self.model
        xs = net._stage_x(x)
        ys = net._as_labels(y)
        fms, lms = net._as_mask(fm), net._as_mask(lm)
        _, grads, score = net._gradients(
            lambda live: self._loss(live, xs, ys, fms, lms))
        from deeplearning4j_tpu_torch.nn.updaters import (
            tree_leaves, tree_map,
        )
        part = {str(i): grads[str(i)] for i in self.pre_idx + self.block_idx}
        leaves = tree_leaves(part)
        summed = iter(all_reduce_flat(leaves, self._group))
        self.syncs += len({g.dtype for g in leaves})
        grads = dict(grads)
        grads.update(tree_map(lambda _: next(summed), part))
        net._update(grads)
        return score

    # ----------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        net = self.model
        source = net._as_iterator(data, batch_size)
        for _ in range(epochs):
            for lst in net.listeners:
                lst.on_epoch_start(net, net.epoch_count)
            for ds in source:
                b = int(np.shape(ds.features)[0])
                self._check_batch(b)
                score = self._step(ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask)
                net._score = float(score)      # the step's one loss fetch
                for lst in net.listeners:
                    lst.iteration_done(net, net.iteration_count,
                                       net.epoch_count, net._score, 0.0, b)
                net.iteration_count += 1
            for lst in net.listeners:
                lst.on_epoch_end(net, net.epoch_count)
            net.epoch_count += 1
            source.reset()
        return net

