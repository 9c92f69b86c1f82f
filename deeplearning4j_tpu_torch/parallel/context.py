"""Context-parallel training: the time axis sharded over the mesh's
``seq`` axis.

Counterpart of the JAX package's `parallel/context.py`. Each rank of a
(data, seq) mesh takes its (data, seq) block of every batch (rows by its
data index, time steps by its seq index) and runs the whole training step
on it with the network's own score function inside
`nn.layers.attention.context_parallel`:

- pointwise layers (embeddings, layer norm, MLP, MoE) run unchanged on
  their local shard;
- `MultiHeadAttention` runs ring attention over the ``seq`` group
  (`parallel/ring.py`): the flash kernels per shard pair merged by their
  LSEs where its flash path would run, else the online-softmax ring;
- RoPE and learned positions are offset by the shard's global start.

The loss is the reference's psum(loss * count) / psum(count) over data x
seq (count: the shard's valid steps under the loss mask, or a uniform
share without one): each rank's loss is scaled by its count over the
global count, which every rank reads from the global batch, and the SUM
over data x seq of the ranks' gradients is the global batch's gradient,
the ring's cross-rank terms included (its rotations carry cotangents
back). That sum is one flat all-reduce (the loss rides in it), then one
updater step on every rank, so every rank applies the same update to its
whole copy of the parameters. The step runs per call: gloo collectives
cannot be captured in a CUDA graph, and the reference has no scan here.

Restrictions (checked at construction, as the reference checks them):
standard backprop only, every layer sequence-local (recurrent layers and
the vertices that read the global time axis are not), and a single-input,
single-output ComputationGraph.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.attention import context_parallel
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, Mesh, MeshConfig, all_reduce_flat, build_mesh,
)

# layers/vertices whose state or computation crosses sequence shards
_SEQ_CROSSING = {"LSTM", "GravesLSTM", "SimpleRnn", "GRU", "Bidirectional",
                 "GravesBidirectionalLSTM", "Convolution1DLayer",
                 "Subsampling1DLayer", "LastTimeStep",
                 # graph vertices that read or reorder the global time
                 # axis: wrong on a local chunk of it
                 "LastTimeStepVertex", "ReverseTimeSeriesVertex",
                 "DuplicateToTimeSeriesVertex"}


class ContextParallelTrainer:
    """Data x sequence parallel trainer for attention networks.

    Usage (every rank of the process group)::

        mesh = build_mesh(MeshConfig(data=2, seq=4))
        trainer = ContextParallelTrainer(net, mesh)
        trainer.fit(iterator, epochs=1)
    """

    def __init__(self, model, mesh: Optional[Mesh] = None):
        if model.params is None:
            model.init()
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        self._is_graph = isinstance(model, ComputationGraph)
        if self._is_graph:
            if len(model.conf.network_inputs) != 1 or \
                    len(model.conf.network_outputs) != 1:
                raise ValueError(
                    "context parallelism supports single-input/"
                    "single-output ComputationGraphs (one sequence axis "
                    "to shard)")
            units = [vd.vertex for vd in model.conf.vertices.values()]
        else:
            units = list(model.layers)
        for layer in units:
            # every level of a wrapper chain: a crossing wrapper and a
            # crossing wrapped layer are both refused
            inner = layer
            while inner is not None:
                if type(inner).__name__ in _SEQ_CROSSING:
                    raise ValueError(
                        f"{type(inner).__name__} carries state across "
                        "sequence shards and cannot run context-parallel; "
                        "use attention/transformer layers")
                inner = getattr(inner, "layer", None)
        if model.conf.backprop_type != "standard":
            raise ValueError("context parallelism requires standard backprop")
        self.model = model
        if mesh is None:
            # default: every rank on the sequence axis (pure CP)
            from deeplearning4j_tpu_torch.parallel.distributed import (
                process_count,
            )
            mesh = build_mesh(MeshConfig(data=1, model=1,
                                         seq=process_count()))
        self.mesh = mesh
        self.seq_degree = mesh.shape[SEQ_AXIS]
        self.data_degree = mesh.shape[DATA_AXIS]
        # formed now, on every rank at once (a group is collective)
        self._group = mesh.group((DATA_AXIS, SEQ_AXIS))
        self._cp = context_parallel(mesh.group(SEQ_AXIS),
                                    mesh.index(SEQ_AXIS), self.seq_degree)
        #: collectives of the gradient exchange made so far
        self.syncs = 0

    # ---------------------------------------------------------------- data
    def _iter_batches(self, data, batch_size):
        """(x, y, fmask, lmask) of each batch, for either container."""
        net = self.model
        if self._is_graph:
            for mds in net._iter_data(data):
                fm = lm = None
                if mds.features_masks is not None:
                    fm = mds.features_masks[0]
                if mds.labels_masks is not None:
                    lm = mds.labels_masks[0]
                yield mds.features[0], mds.labels[0], fm, lm
            if hasattr(data, "reset"):
                data.reset()
        else:
            source = net._as_iterator(data, batch_size)
            for ds in source:
                yield (ds.features, ds.labels, ds.features_mask,
                       ds.labels_mask)
            source.reset()

    def _check_divisible(self, x):
        if x.shape[0] % self.data_degree:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by data degree "
                f"{self.data_degree}")
        if x.shape[1] % self.seq_degree:
            raise ValueError(
                f"sequence length {x.shape[1]} not divisible by seq degree "
                f"{self.seq_degree}")

    def _block(self, a, b, t):
        """This rank's (data, seq) block of a (B, T, ...) batch array."""
        if a is None:
            return None
        bl, tl = b // self.data_degree, t // self.seq_degree
        i, j = self.mesh.index(DATA_AXIS), self.mesh.index(SEQ_AXIS)
        return a[i * bl:(i + 1) * bl, j * tl:(j + 1) * tl]

    @staticmethod
    def _count(m) -> float:
        if isinstance(m, torch.Tensor):
            return float(m.double().sum())
        return float(np.sum(m, dtype=np.float64))

    # ---------------------------------------------------------------- step
    def _step(self, x, y, fm, lm, generator) -> torch.Tensor:
        """One optimizer step on this rank's block of the batch: the
        global loss (on the device)."""
        net = self.model
        b, t = int(x.shape[0]), int(x.shape[1])
        xb, yb, fb, lb = (self._block(a, b, t) for a in (x, y, fm, lm))
        # the reference's weighting mask: the labels mask, else the
        # features mask
        wmask, wlocal = (lm, lb) if lm is not None else (fm, fb)
        if wmask is None:
            scale = 1.0 / (self.data_degree * self.seq_degree)
        else:
            scale = self._count(wlocal) / max(self._count(wmask), 1.0)

        def score(live):
            with self._cp:
                if self._is_graph:
                    loss, (new_state, _) = net._score_fn(
                        live, net.state, net._stage_inputs((xb,)),
                        net._as_labels((yb,)),
                        None if fb is None else net._as_masks((fb,)),
                        None if lb is None else net._as_masks((lb,)),
                        True, generator)
                else:
                    loss, (new_state, _) = net._score_fn(
                        live, net.state, net._stage_x(xb),
                        net._as_labels(yb), net._as_mask(fb),
                        net._as_mask(lb), True, generator)
            return loss * scale, new_state

        loss, grads, new_state = net._gradients(score)
        from deeplearning4j_tpu_torch.nn.updaters import (
            tree_leaves, tree_map,
        )
        leaves = tree_leaves(grads)
        if self.mesh.grouped:
            summed = all_reduce_flat(leaves + [loss.reshape(1)],
                                     self._group)
            self.syncs += len({g.dtype for g in leaves + [loss]})
            it = iter(summed[:-1])
            grads = tree_map(lambda _: next(it), grads)
            loss = summed[-1].reshape(())
        net._update(grads)
        self._commit_state(new_state)
        return loss

    def _commit_state(self, new_state):
        """The floating layer state (batch-norm statistics) meaned over
        data x seq: every rank keeps one state."""
        from deeplearning4j_tpu_torch.nn import step_graph
        from deeplearning4j_tpu_torch.nn.updaters import (
            tree_leaves, tree_map,
        )
        floating = [s for s in tree_leaves(new_state)
                    if s.is_floating_point()]
        if floating and self.mesh.grouped:
            n = self.data_degree * self.seq_degree
            summed = iter(all_reduce_flat(floating, self._group))
            new_state = tree_map(lambda s: next(summed) / n
                                 if s.is_floating_point() else s, new_state)
        with torch.no_grad():
            step_graph.commit(self.model.state, new_state)

    # ----------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        net = self.model
        offset = 8191 * self.mesh.index(DATA_AXIS) \
            + self.mesh.index(SEQ_AXIS)
        # each (data, seq) shard draws its own dropout noise; repeated
        # fits draw fresh masks (keyed by the epoch count)
        generator = torch.Generator(device=net.device).manual_seed(
            net.conf.seed + 524287 + 1000003 * net.epoch_count + offset)
        for _ in range(epochs):
            for lst in net.listeners:
                lst.on_epoch_start(net, net.epoch_count)
            for x, y, fm, lm in self._iter_batches(data, batch_size):
                self._check_divisible(x)
                loss = self._step(x, y, fm, lm, generator)
                # graftlint: disable=host-sync-in-hot-path -- the step's ONE budgeted loss fetch (the deliberate per-iteration sync)
                net._score = float(loss)
                for lst in net.listeners:
                    lst.iteration_done(net, net.iteration_count,
                                       net.epoch_count, net._score, 0.0,
                                       int(x.shape[0]))
                net.iteration_count += 1
            for lst in net.listeners:
                lst.on_epoch_end(net, net.epoch_count)
            net.epoch_count += 1
        return net
