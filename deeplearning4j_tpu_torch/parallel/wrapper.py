"""ParallelWrapper — data-parallel training over the process group.

Counterpart of the JAX package's `parallel/wrapper.py` (DL4J
`ParallelWrapper.java`: modes :59-74, fit loop :467-579, averaging :338).
Each rank runs this wrapper around its own copy of the network, reads the
same global batches, and keeps its contiguous block of each (rank order
over the mesh's ``data`` axis, the reference's shard order).

- SYNC_GRADIENTS (default): a thin shim over the sharding plan, as in the
  reference. The wrapper runs the container's own fit with
  ``plan=self.plan`` (`parallel/plan.py`): one set of parameters, the
  gradients summed over ``data`` between backward and the updater, ZeRO
  and rule sharding as the plan says. Over one rank it is bitwise the
  plain fit.
- AVERAGING: exact DL4J TrainingMode.AVERAGING. Each rank keeps its own
  parameters and optimizer state and takes `averaging_frequency` local
  steps (the container's per-call step on its block) between averages of
  the parameters, the layer state (batch-norm statistics) and, with
  `average_updaters`, the floating optimizer state. Each average is a
  mean in f32 cast back to the leaf's dtype, as the reference's; integer
  step counters stay per rank. A final average ends every fit. Each
  rank's dropout generator is seeded ``conf.seed + 131071 + 1000003 x
  rank``.

A batch the ranks do not divide is made exact as in the reference: its
rows are wrap-padded to a multiple of the ranks, and a labels mask
(synthesized when absent) is zero on the padded rows, so they are left
out of the loss and the gradient (batch norm still sees them, as in the
reference).
"""
from __future__ import annotations

import enum
import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, MeshConfig, build_mesh,
)
from deeplearning4j_tpu_torch.parallel.plan import ShardingPlan, active_plan

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingMode(str, enum.Enum):
    """DL4J ParallelWrapper.TrainingMode. SHARED_GRADIENTS and
    AVERAGING(freq=1) both map to SYNC_GRADIENTS."""
    SYNC_GRADIENTS = "sync_gradients"
    AVERAGING = "averaging"


def _map_entry(v, fn):
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        return tuple(None if a is None else fn(a) for a in v)
    return fn(v)


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _PaddedSource(DataSetIterator):
    """The wrapper's view of a source: every batch made divisible by the
    ranks (`ParallelWrapper._pad_batch`)."""

    def __init__(self, wrapper, source):
        self.wrapper = wrapper
        self.source = source

    def __iter__(self):
        w = self.wrapper
        for struct in w._batches(self.source):
            yield w._rebuild(w._pad_batch(*struct))

    def reset(self):
        if hasattr(self.source, "reset"):
            self.source.reset()


class ParallelWrapper:
    """Data-parallel trainer for a MultiLayerNetwork or ComputationGraph.

    Usage (mirrors DL4J; every rank of the process group runs it):
        wrapper = ParallelWrapper(net, mode=TrainingMode.AVERAGING,
                                  averaging_frequency=5)
        wrapper.fit(iterator, epochs=2)
    After fit() the wrapped network holds the trained parameters.
    """

    def __init__(self, model, mesh: Optional[Mesh] = None,
                 mode: TrainingMode = TrainingMode.SYNC_GRADIENTS,
                 averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 report_score_after_averaging: bool = False,
                 zero_stage: int = 0,
                 plan: Optional[ShardingPlan] = None):
        if model.params is None:
            model.init()
        self.model = model
        self.mode = TrainingMode(mode)
        # an explicit plan (or, with no explicit mesh/zero args, the
        # use_mesh plan) supplies mesh extents, rules and ZeRO stage;
        # AVERAGING adopts only its mesh
        if plan is None and mesh is None and zero_stage == 0:
            plan = active_plan()
        if plan is not None:
            if mesh is None:
                mesh = plan.mesh()
            if zero_stage == 0 and self.mode == TrainingMode.SYNC_GRADIENTS:
                zero_stage = plan.zero_stage
        self.mesh = mesh if mesh is not None else build_mesh(MeshConfig())
        # the plan validates the stage (ShardingPlan.__post_init__)
        self.plan = ShardingPlan.for_mesh(
            self.mesh,
            rules=(plan.rules if plan is not None
                   and self.mode == TrainingMode.SYNC_GRADIENTS else None),
            zero_stage=zero_stage)
        if zero_stage and self.mode != TrainingMode.SYNC_GRADIENTS:
            raise ValueError("zero_stage requires SYNC_GRADIENTS mode "
                             "(AVERAGING keeps per-worker full copies by "
                             "definition)")
        self.zero_stage = zero_stage
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updaters = average_updaters
        self.report_score_after_averaging = report_score_after_averaging
        self.n_workers = self.mesh.shape[DATA_AXIS]
        self.rank = self.mesh.index(DATA_AXIS)
        self._local_steps = 0
        self._warned_ragged = False
        #: collectives the AVERAGING loop issued (averages, score sums)
        self.syncs = 0

    # ------------------------------------------------------------- plumbing
    @property
    def _is_graph(self):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return isinstance(self.model, ComputationGraph)

    def _source(self, data, batch_size):
        """What the container's fit reads: a graph takes `data` as it is,
        a network an iterator over it."""
        if self._is_graph:
            return data
        return self.model._as_iterator(data, batch_size)

    def _batches(self, source):
        """Batch structs (x, y, fmask, lmask); tuples per entry for
        graphs."""
        if self._is_graph:
            for mds in self.model._iter_data(source):
                yield self.model._batch_struct(mds)
        else:
            for ds in source:
                yield self.model._batch_struct(ds)

    def _rebuild(self, padded):
        """A batch object of the container's kind from a padded struct."""
        from deeplearning4j_tpu_torch.data.dataset import (
            DataSet, MultiDataSet,
        )
        x, y, fm, lm = padded
        if self._is_graph:
            return MultiDataSet(x, y, fm, lm)
        return DataSet(x, y, fm, lm)

    # ------------------------------------------------------------------ fit
    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        source = self._source(data, batch_size)
        if self.mode == TrainingMode.AVERAGING:
            self._fit_averaging(source, epochs)
            return self.model
        padded = _PaddedSource(self, source)
        if self._is_graph:
            self.model.fit(padded, epochs=epochs, plan=self.plan)
        else:
            self.model.fit(padded, epochs=epochs, batch_size=batch_size,
                           plan=self.plan)
        return self.model

    # --- AVERAGING --------------------------------------------------------
    def _average(self, net):
        """Mean over the data ranks, in f32, of the parameters, the layer
        state and (with average_updaters) the floating optimizer state;
        written back in place."""
        from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
        leaves = tree_leaves(net.params) + [
            t for t in tree_leaves(net.state)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if self.average_updaters:
            leaves += [t for t in tree_leaves(net.opt_state)
                       if isinstance(t, torch.Tensor)
                       and t.is_floating_point()]
        group = self.mesh.group(DATA_AXIS)
        if group is None or not leaves:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        dist.all_reduce(flat, group=group)
        self.syncs += 1
        flat = flat / self.n_workers
        ofs = 0
        with torch.no_grad():
            for t in leaves:
                n = t.numel()
                t.copy_(flat[ofs:ofs + n].view(t.shape).to(t.dtype))
                ofs += n

    def _mean_loss(self, loss) -> float:
        group = self.mesh.group(DATA_AXIS)
        if group is None:
            return float(loss)
        buf = loss.detach().reshape(1).double()
        dist.all_reduce(buf, group=group)
        self.syncs += 1
        return float(buf) / self.n_workers

    def _fit_averaging(self, source, epochs):
        from deeplearning4j_tpu_torch.nn import step_graph
        net = self.model
        gen = torch.Generator(device=net.device).manual_seed(
            net.conf.seed + 131071 + 1000003 * self.rank)
        try:
            for _ in range(epochs):
                for lst in net.listeners:
                    lst.on_epoch_start(net, net.epoch_count)
                for struct in self._batches(source):
                    bs = self._batch_count(struct[0])
                    local = self._split_batch(*struct)
                    loss = net._step_struct(local, gen)
                    self._local_steps += 1
                    at_avg = self._local_steps % self.averaging_frequency \
                        == 0
                    if at_avg:
                        self._average(net)
                    if at_avg or (net.listeners and
                                  not self.report_score_after_averaging):
                        net._score = self._mean_loss(loss)
                        step_graph.record_iteration(net._score, bs)
                    for lst in net.listeners:
                        lst.iteration_done(net, net.iteration_count,
                                           net.epoch_count, net._score, 0.0,
                                           bs)
                    net.iteration_count += 1
                for lst in net.listeners:
                    lst.on_epoch_end(net, net.epoch_count)
                net.epoch_count += 1
                if hasattr(source, "reset"):
                    source.reset()
        finally:
            # the final average: every rank leaves with the same network
            self._average(net)

    # ------------------------------------------------------------- batching
    def _pad_to_workers(self, a, zero: bool = False):
        """Pad a ragged batch up to a multiple of n_workers: wrap-pad with
        leading examples (zero=False) or zero rows (zero=True, the labels
        mask, so padded examples are EXCLUDED from the loss)."""
        a = _host(a)
        n = self.n_workers
        b = a.shape[0]
        if b % n == 0:
            return a
        pad = n - b % n
        if zero:
            extra = np.zeros((pad,) + a.shape[1:], a.dtype)
        else:
            reps = int(np.ceil(pad / b))
            extra = np.concatenate([a] * reps)[:pad]
        return np.concatenate([a, extra])

    def _pad_batch(self, x, y, fm, lm):
        """The batch made evenly divisible, exactly: wrap-padded features
        and labels, and a zero-padded (synthesized if absent) labels mask
        so the loss's masked mean renormalizes by the true count."""
        b = self._batch_count(x)
        if b % self.n_workers == 0:
            return x, y, fm, lm
        if not self._warned_ragged:
            log.info(
                "batch of %d not divisible by %d workers; padding with "
                "mask-excluded rows (exact loss renormalization)", b,
                self.n_workers)
            self._warned_ragged = True

        def synth(yy, mm):
            if mm is not None:
                return _host(mm)
            yy = _host(yy)
            # validity per example (FF, rank-2 labels), per step (RNN,
            # rank-3) or per pixel (CNN loss, rank-4 -> (B, H, W))
            shape = ((yy.shape[0],) if yy.ndim < 3
                     else yy.shape[:2] if yy.ndim == 3
                     else yy.shape[:-1])
            return np.ones(shape, np.float32)

        if isinstance(y, (list, tuple)):
            lm = tuple(synth(yy, None if lm is None else lm[i])
                       for i, yy in enumerate(y))
        else:
            lm = synth(y, lm)
        wrap = lambda a: self._pad_to_workers(a)        # noqa: E731
        zero = lambda a: self._pad_to_workers(a, zero=True)  # noqa: E731
        return (_map_entry(x, wrap), _map_entry(y, wrap),
                _map_entry(fm, wrap), _map_entry(lm, zero))

    def _split_batch(self, x, y, fm, lm):
        """This rank's contiguous block of the padded batch."""
        x, y, fm, lm = self._pad_batch(x, y, fm, lm)
        n, i = self.n_workers, self.rank

        def block(a):
            b = a.shape[0] // n
            return a[i * b:(i + 1) * b]

        return (_map_entry(x, block), _map_entry(y, block),
                _map_entry(fm, block), _map_entry(lm, block))

    @staticmethod
    def _batch_count(x):
        if isinstance(x, (list, tuple)):
            x = x[0]
        return int(np.shape(x)[0])
