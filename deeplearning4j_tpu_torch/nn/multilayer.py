"""MultiLayerNetwork — the sequential network container.

Counterpart of the JAX package's `nn/multilayer.py`: `init()` builds the
per-layer parameter dicts along the InputType chain and the optimizer
state, `output()` runs the forward with the automatic preprocessors, and
`fit()` trains with the reference's per-call step: forward and backward
(autograd in place of `jax.value_and_grad`), the updater chain, one
loss fetch per step, then the listeners. Parameters are a dict
``{"0": {...}, "1": {...}}`` of tensors with the reference's key paths
and (in, out) layouts, so a checkpoint moves between the packages with no
transposes; the optimizer state keeps optax's state-dict layout
(`nn/updaters.py`).

The network lives on one device, CUDA unless the caller asks for the CPU
(`util.platform.resolve_device`); without CUDA the default raises.

Dropout objects and weight noise act in the training forward, and
constraints are projected after each update (`nn/regularization.py`).
Per-layer updaters and frozen layers label the parameters for the
updaters' multi_transform, as the reference's optax.multi_transform.

`fit` also runs the reference's other paths: scan-of-K
(`scan_steps > 1`, a replayed CUDA graph of the train step on CUDA,
`nn/step_graph.py`), gradient accumulation (`accumulate_steps > 1`),
prefetch (`data/async_iterator.py`) with device-side normalization
(`data/normalization.py`), gradient checkpointing, and truncated BPTT
(`backprop_type="tbptt"`: chunks of `tbptt_fwd_length` along time, the
recurrent layers' state carried across chunks and detached at each
boundary, one optimizer step a chunk, run per call as the reference
does). Every fit path records the reference's telemetry
(`step_graph.record_iteration`, the `train/*` spans, the goodput session
and the program ledger, `monitor/`): host scalars only, outside any
captured graph. `rnn_time_step` streams through the recurrent layers with their
state kept between calls. A sharding plan (`fit(plan=)`, or the
process-wide `parallel.use_mesh` plan) makes every fit path
data-parallel over the ranks of the process group, with ZeRO and rule
sharding (`parallel/plan.PlanRuntime`, engaged for the fit's length).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.async_iterator import (
    AsyncDataSetIterator, pinned, fit_prefetch_enabled,
)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator, DataSetIterator, ExistingDataSetIterator,
)
from deeplearning4j_tpu_torch.data.normalization import (
    apply_device_affine, engaged_device_affine,
)
from deeplearning4j_tpu_torch.data.pipeline import (
    mark_copy_for_stacking, restore_view_batches,
)
from deeplearning4j_tpu_torch.monitor import goodput
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
from deeplearning4j_tpu_torch.nn import step_graph
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, RandomTape, preprocess_forward,
    preprocessed_type,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.regularization import (
    apply_constraints, apply_weight_noise, constraint_map, has_constraints,
)
from deeplearning4j_tpu_torch.nn.updaters import (
    NoOp, apply_updates, build_optimizer, multi_transform, tree_leaves,
    tree_map,
)
from deeplearning4j_tpu_torch.util import params as param_util
from deeplearning4j_tpu_torch.util.platform import (
    DeviceLike, resolve_device, set_f32_matmul_exact,
)

# layer-kind requirements for automatic preprocessor insertion; a class
# not listed accepts any kind (elementwise layers)
_KIND_BY_CLASS = {
    "DenseLayer": Kind.FF, "EmbeddingLayer": Kind.FF, "OutputLayer": Kind.FF,
    "AutoEncoder": Kind.FF, "VariationalAutoencoder": Kind.FF,
    "ConvolutionLayer": Kind.CNN, "Deconvolution2D": Kind.CNN,
    "SeparableConvolution2D": Kind.CNN, "DepthwiseConvolution2D": Kind.CNN,
    "SubsamplingLayer": Kind.CNN, "Upsampling2D": Kind.CNN,
    "ZeroPaddingLayer": Kind.CNN, "Cropping2D": Kind.CNN,
    "SpaceToDepthLayer": Kind.CNN, "SpaceToBatchLayer": Kind.CNN,
    "Yolo2OutputLayer": Kind.CNN,
    "MultiHeadAttention": Kind.RNN, "TransformerBlock": Kind.RNN,
    "MoEFeedForward": Kind.RNN,
    "PositionalEmbeddingLayer": Kind.RNN, "EmbeddingSequenceLayer": Kind.RNN,
    "LocalResponseNormalization": Kind.CNN, "CnnLossLayer": Kind.CNN,
    "LSTM": Kind.RNN, "GravesLSTM": Kind.RNN, "SimpleRnn": Kind.RNN,
    "GRU": Kind.RNN,
    "Bidirectional": Kind.RNN, "GravesBidirectionalLSTM": Kind.RNN,
    "RnnOutputLayer": Kind.RNN, "RnnLossLayer": Kind.RNN,
    "LastTimeStep": Kind.RNN, "MaskZeroLayer": Kind.RNN,
    "Convolution1DLayer": Kind.RNN, "Subsampling1DLayer": Kind.RNN,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


_RECURRENT_CLASSES = {"LSTM", "GravesLSTM", "SimpleRnn", "GRU"}


def unwrap_frozen(layer):
    """The layer a FrozenLayerWrapper wraps, else the layer itself."""
    if type(layer).__name__ == "FrozenLayerWrapper":
        return layer.layer
    return layer


def is_frozen(layer) -> bool:
    """Frozen layers take the NoOp updater: `frozen=True` or wrapped."""
    return bool(getattr(layer, "frozen", False)) \
        or type(layer).__name__ == "FrozenLayerWrapper"


def _is_stateful_recurrent(layer) -> bool:
    """Recurrent layers carry state through `apply_seq` (tbptt,
    rnn_time_step); a frozen one keeps its state semantics."""
    return type(unwrap_frozen(layer)).__name__ in _RECURRENT_CLASSES


def _required_kind(layer: LayerConf) -> Optional[Kind]:
    return _KIND_BY_CLASS.get(type(unwrap_frozen(layer)).__name__)


def validate_layer_conf(layer: LayerConf):
    """Fail fast on unresolvable activation / weight_init / loss names."""
    from deeplearning4j_tpu_torch.nn.activations import get_activation
    from deeplearning4j_tpu_torch.nn.initializers import get_initializer
    from deeplearning4j_tpu_torch.nn.losses import get_loss
    for field, resolver in (("activation", get_activation),
                            ("weight_init", get_initializer),
                            ("loss", get_loss)):
        v = getattr(layer, field, None)
        if v is not None:
            resolver(v)


def tree_to(tree, device: torch.device, dtype: Optional[torch.dtype] = None):
    """Move a nested dict of tensors to `device` (floats cast to dtype)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def as_input(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Features -> a tensor on `device`; floats and raw uint8 pixels in
    the compute dtype (the reference's `_as_jnp`), wider integer ids stay
    integer."""
    x = _tensor(x)
    if x.is_floating_point() or x.dtype == torch.uint8:
        return x.to(device=device, dtype=dtype)
    return x.to(device=device)


def as_labels(y, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Labels -> `device`; floats and uint8 (a one-hot .npz) in the compute
    dtype, as the reference's `_as_jnp(y, compute_dtype)`; wider ints
    (class ids) stay integer."""
    y = _tensor(y).to(device)
    if y.is_floating_point() or y.dtype == torch.uint8:
        return y.to(dtype)
    return y


def as_mask(m, device: torch.device) -> Optional[torch.Tensor]:
    return None if m is None else _tensor(m).to(device)


def layer_call(layer, params, state, x, *, train: bool, mask, generator,
               remat: bool, seq: bool = False, carry=None):
    """layer.apply -> (y, new_state), or with `seq` layer.apply_seq from
    `carry` -> (y, final_carry); under torch.utils.checkpoint when
    `remat` (gradient checkpointing: the backward recomputes the layer's
    activations), with the carry a checkpoint argument. The recompute must
    draw the forward's dropout masks: a RandomTape records them in the
    forward and replays them. Shared by both containers."""
    def run(p, s, xx, m, g, c):
        if seq:
            return layer.apply_seq(p, xx, c, train=train, mask=m,
                                   generator=g)
        return layer.apply(p, s, xx, train=train, mask=m, generator=g)

    if not remat:
        return run(params, state, x, mask, generator, carry)
    tape = None if generator is None else RandomTape(generator)

    def fn(p, s, xx, m, c):
        if tape is not None:
            tape.begin()
        out = run(p, s, xx, m, tape, c)
        if tape is not None:
            tape.end()
        return out
    return torch.utils.checkpoint.checkpoint(
        fn, params, state, x, mask, carry, use_reentrant=False,
        preserve_rng_state=False)


def detach_tree(tree):
    """Detach every tensor of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(detach_tree(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def host_array(a):
    """A network output or a label as a numpy array (16-bit floats as
    f32) for the evaluation accumulators."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def masked_eval_pair(labels, preds, labels_mask):
    """(labels, preds) for the eval accumulators: mask-padded entries
    dropped (the mask reshaped to the labels' leading dims), rank >= 3
    sequences flattened to (N, C). The reference's _masked_eval_pair."""
    if labels_mask is not None:
        m = host_array(labels_mask).astype(bool).reshape(labels.shape[:-1])
        labels, preds = labels[m], preds[m]
    if labels.ndim >= 3:
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
    return labels, preds


class TrainableNet:
    """What both containers share of the fit machinery: the optimizer with
    per-layer labels, the epoch's dropout generator, the device affine,
    the in-place step helpers `nn/step_graph.ChunkedFit` drives, and the
    evaluation entry points."""

    #: program-name prefix in the ledger ("mln/train_step", "graph/...")
    _LEDGER_PREFIX = "mln"

    def _reset_fit_state(self):
        self._ledger_cache = {}         # monitor.xla programs by step key
        self._tx = None
        self.opt_state = None
        self._step_graphs = {}
        self._accum_buffers = None
        self._input_affine = None
        self._affine_held = None
        self._dropout_gen = None
        self._plan_rt = None            # parallel/plan.PlanRuntime
        self._plan_syncs = 0            # collectives of released plans

    def _own_held_batches(self, source, staging_device, staged: bool,
                          scan_steps: int, accumulate_steps: int) -> list:
        """Flip the view-batch sources of `source` (`data/pipeline.py`,
        copy=False) to copies when this fit holds a batch past its next
        pull (`step_graph.holds_batches`); returns them for
        `restore_view_batches`."""
        chunked = accumulate_steps > 1 or (
            scan_steps > 1 and self.conf.backprop_type != "tbptt"
            and not step_graph.scan_incompatible_listeners(self.listeners))
        if not step_graph.holds_batches(staging_device, staged, chunked):
            return []
        return mark_copy_for_stacking(source)

    def _drop_graphs(self):
        """Captured steps read the tensors they were captured with: a
        rebind of params or optimizer state ends them."""
        self._step_graphs = {}
        self._accum_buffers = None

    def _label_tree(self):
        """(key, label prefix, layer conf) of every parameter group, in
        order."""
        raise NotImplementedError

    def _build_optimizer(self):
        """The global updater chain, or optax.multi_transform's
        counterpart when a layer has its own updater or is frozen (NoOp),
        labelled as the reference labels (`_label_params`)."""
        transforms = {"__global__": build_optimizer(
            self.conf.updater, self.conf.grad_clip_norm,
            self.conf.grad_clip_value)}
        labels = {}
        any_override = False
        for key, prefix, layer in self._label_tree():
            lab = "__global__"
            if is_frozen(layer):
                lab = "__noop__"
                transforms.setdefault("__noop__", NoOp().transform())
                any_override = True
            elif getattr(layer, "updater", None) is not None:
                lab = prefix + key
                transforms[lab] = build_optimizer(
                    layer.updater, self.conf.grad_clip_norm,
                    self.conf.grad_clip_value)
                any_override = True
            labels[key] = tree_map(lambda _, lab=lab: lab, self.params[key])
        self._tx = multi_transform(transforms, labels) if any_override \
            else transforms["__global__"]
        self.opt_state = self._tx.init(self.params)
        self._drop_graphs()

    def optimizer_state_template(self) -> dict:
        """A fresh optimizer state: the structure, shapes and dtypes a
        loaded updaterState.bin must have."""
        return self._tx.init(self.params)

    def _epoch_generator(self, stride: int) -> torch.Generator:
        """The dropout generator of this epoch: one generator on the
        device for the network's life (captured steps register it),
        reseeded each epoch as the reference seeds its epoch key (the
        streams themselves differ)."""
        if self._dropout_gen is None:
            self._dropout_gen = torch.Generator(device=self.device)
        offset = 0 if self._plan_rt is None \
            else self._plan_rt.generator_offset()
        self._dropout_gen.manual_seed(self.conf.seed + offset
                                      + stride * (self.epoch_count + 1))
        return self._dropout_gen

    def _set_input_affine(self, aff):
        """Engage (shift, scale) for this fit, in tensors that persist
        across fits of one shape, so captured steps stay valid."""
        if aff is None:
            self._input_affine = None
            return
        vals = [np.asarray(v, np.float32) for v in aff]
        held = self._affine_held
        if held is None or [tuple(h.shape) for h in held] != [v.shape
                                                               for v in vals]:
            held = self._affine_held = [
                torch.empty(v.shape, device=self.device) for v in vals]
        for h, v in zip(held, vals):       # stream-ordered, no host sync
            h.copy_(pinned(v) if h.is_cuda else torch.from_numpy(v),
                    non_blocking=True)
        self._input_affine = tuple(held)

    def _affine_key(self):
        aff = self._input_affine
        return None if aff is None else tuple(tuple(a.shape) for a in aff)

    def _stage_x(self, x) -> torch.Tensor:
        """Features -> the compute dtype on the device; with a device
        affine engaged, raw features are normalized there first."""
        if self._input_affine is None:
            return as_input(x, self.device, self._compute_dtype)
        shift, scale = self._input_affine
        return apply_device_affine(_tensor(x).to(self.device), shift, scale,
                                   self._compute_dtype)

    def _grad_shapes(self) -> list:
        """(shape, dtype) of each gradient leaf: the whole parameters'
        (a sharded plan stores pieces)."""
        if self._plan_rt is not None:
            return self._plan_rt.whole_shapes
        return [(p.shape, p.dtype) for p in tree_leaves(self.params)]

    def _bound_tensors(self) -> list:
        return step_graph.tree_tensors(self.params, self.opt_state,
                                       self.state) \
            + list(self._input_affine or ())

    def _apply_grads(self, grads, loss=None):
        """`_update(grads)`; under a sharding plan the data group's
        reduction first and the plan's sharded update. Returns the loss
        (the global one under a plan)."""
        if self._plan_rt is not None:
            return self._plan_rt.apply(self, grads, loss)
        self._update(grads)
        return loss

    def _update(self, grads):
        """The updater chain (clipping included), the in-place update, the
        constraints' projection, the new optimizer state written into the
        old one's tensors."""
        with torch.no_grad():
            updates, new_opt = self._tx.update(grads, self.opt_state,
                                               self.params)
            apply_updates(self.params, updates)
            if self._constraints:
                apply_constraints(self._constraints, self.params)
            step_graph.commit(self.opt_state, new_opt)

    def _commit_state(self, new_state):
        with torch.no_grad():
            if self._plan_rt is not None:
                new_state = self._plan_rt.reduce_state(new_state)
            step_graph.commit(self.state, new_state)

    def _step_struct(self, struct, generator) -> torch.Tensor:
        """One optimizer step on a batch struct; the loss stays on the
        device."""
        return self._carry_step(struct, generator, None)[0]

    def _carry_step(self, struct, generator, carries):
        """One optimizer step from the recurrent `carries` (None: the
        standard forward; {}: zero state): (loss on the device, the final
        carries, detached)."""
        loss, grads, new_state, new_carries = self._grad_struct(
            struct, generator, carries)
        loss = self._apply_grads(grads, loss)
        self._commit_state(new_state)
        return loss, new_carries

    def _gradients(self, score, params=None):
        """(loss, grads, aux) of `score(live_params)` -> (loss, aux),
        gradients with respect to the parameters as stored (`params`, by
        default the network's), `aux` (the new layer state and carries)
        detached."""
        if params is None:
            params = self.params if self._plan_rt is None \
                else self._plan_rt.full_params(self.params)
        live = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), params)
        leaves = [t for t in tree_leaves(live) if t.requires_grad]
        with torch.enable_grad():
            loss, aux = score(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads) if g is not None}
        grad_tree = tree_map(lambda t: by_leaf[id(t)] if id(t) in by_leaf
                             else torch.zeros_like(t), live)
        return loss.detach(), grad_tree, detach_tree(aux)

    def _check_ids(self, batch):
        """Range-check the ids of the features that feed an embedding, on
        the host for a host array (the prefetch thread runs this before
        its copy, the chunked fit before a chunk's first step)."""
        leaves = step_graph.flatten(self._batch_struct(batch))
        for i, layer, (n, message) in self._id_inputs():
            a = leaves[i]
            if isinstance(a, torch.Tensor) and a.is_cuda:
                step_graph.check_ids(layer, a.to(torch.int64), n, message)
            else:
                step_graph.check_host_ids(host_array(a), n, message)

    def _run_epochs(self, epochs, batches_of, scan_steps, accumulate_steps,
                    stride, reset):
        """fit()'s epoch loop, shared by both containers: the listeners'
        epoch calls, a `train/epoch` span per epoch, and one goodput
        session over the whole loop (closed even when the fit raises)."""
        gp_session = goodput.fit_begin(f"{self._LEDGER_PREFIX}/fit")
        try:
            for _ in range(epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self, self.epoch_count)
                with monitor.span("train/epoch", epoch=self.epoch_count):
                    self._run_epoch(batches_of(), scan_steps,
                                    accumulate_steps, stride)
                for lst in self.listeners:
                    lst.on_epoch_end(self, self.epoch_count)
                self.epoch_count += 1
                reset()
        finally:
            goodput.fit_end(gp_session)

    def _run_epoch(self, batches, scan_steps, accumulate_steps, stride):
        generator = self._epoch_generator(stride)
        lockstep = step_graph.scan_incompatible_listeners(self.listeners)
        if self.conf.backprop_type == "tbptt":
            # as in the reference, tbptt never scans
            self._fit_epoch_tbptt(batches, generator)
        elif accumulate_steps > 1:
            # accumulation cannot fall back to per-call steps (that would
            # change the optimization): it drops the one-chunk deferral
            step_graph.ChunkedFit(self, generator).accumulate(
                batches, accumulate_steps, defer=not lockstep)
        elif scan_steps > 1 and not lockstep:
            step_graph.ChunkedFit(self, generator).scan(batches, scan_steps)
        else:
            self._fit_epoch(batches, generator)

    def _fit_epoch(self, batches, generator):
        """The per-call path: each step ends in its loss fetch, then the
        listeners. With the program ledger on, a signature's first step is
        the counted one (`monitor/xla.py`) and later steps feed the MFU
        accountant."""
        etl_start = time.perf_counter()
        for b in batches:
            step_start = time.perf_counter()
            etl_ms = (step_start - etl_start) * 1e3
            monitor.add_span("train/etl", etl_start, step_start,
                             iteration=self.iteration_count)
            struct = self._batch_struct(b)
            bs = int(np.shape(step_graph.flatten(struct)[0])[0])
            loss, rec, fresh = self._dispatch_step(struct, generator, bs)
            sync_start = time.perf_counter()
            # wait for the device FIRST (goodput: step_compute), so the
            # host_sync span below covers only the narrow D2H fetch
            goodput.device_wait(loss)
            fetch_start = time.perf_counter()
            monitor.add_span("train/device_wait", sync_start, fetch_start)
            self._score = float(loss)          # the step's one loss fetch
            step_end = time.perf_counter()
            monitor.add_span("train/host_sync", fetch_start, step_end)
            monitor.add_span("train/step", step_start, step_end,
                             iteration=self.iteration_count,
                             score=self._score, batch_size=bs)
            if rec is not None and not fresh:
                # the counted step ran under the counters: only later
                # steps feed the MFU gauge
                xla_ledger.observe_step(rec, step_end - step_start)
            step_graph.record_iteration(self._score, bs,
                                        step_seconds=step_end - step_start,
                                        sync_seconds=step_end - fetch_start)
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.epoch_count, self._score, etl_ms, bs)
            self.iteration_count += 1
            etl_start = time.perf_counter()

    def _dispatch_step(self, struct, generator, bs: int):
        """One per-call step on a batch struct, as the program ledger sees
        it: (the loss on the device, the step program's ledger record or
        None while the ledger is off, whether this step was the record's
        counted one)."""
        if not xla_ledger.enabled():
            return self._step_struct(struct, generator), None, False
        key = ("train_step", step_graph.signature(struct), self._affine_key())
        if key not in self._ledger_cache:
            loss, rec = self._counted(
                key, "train_step", struct, bs, 1,
                lambda: self._step_struct(struct, generator))
            return loss, rec, True
        return (self._step_struct(struct, generator),
                self._ledger_cache[key], False)

    def _counted(self, key, program: str, struct, examples: int, steps: int,
                 run, finish=None):
        """Run one step as the ledger's counted step (`monitor/xla.py`)
        and book its record under `key`: (run()'s output, the record).
        `finish`, if given, runs after the counters close and before the
        record is booked (a graph capture, whose time is booked too)."""
        cap = xla_ledger.begin_capture(
            f"{self._LEDGER_PREFIX}/{program}",
            (self.params, self.opt_state, self.state, struct),
            examples_per_call=examples, steps_per_call=steps,
            variant=f"compute={self._compute_dtype}")
        with cap:
            out = cap.output = run()
        if finish is not None:
            finish()
        rec = self._ledger_cache[key] = cap.finish()
        return out, rec

    def _fit_epoch_tbptt(self, batches, generator):
        """Truncated BPTT (doTruncatedBPTT): each batch's time axis in
        chunks of `tbptt_fwd_length` (`_tbptt_chunks`), the recurrent
        state carried from chunk to chunk and detached at each boundary,
        zero at each batch's start. Each chunk is one optimizer step, one
        iteration, one loss fetch and one `iteration_done`."""
        etl_start = time.perf_counter()
        for b in batches:
            step_start = time.perf_counter()
            etl_ms = (step_start - etl_start) * 1e3
            monitor.add_span("train/etl", etl_start, step_start,
                             iteration=self.iteration_count)
            struct = self._batch_struct(b)
            bs = int(np.shape(step_graph.flatten(struct)[0])[0])
            carries = {}
            for chunk in self._tbptt_chunks(struct):
                loss, carries = self._carry_step(chunk, generator, carries)
                self._score = float(loss)      # the chunk's one loss fetch
                step_graph.record_iteration(self._score, bs)
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count,
                                       self.epoch_count, self._score,
                                       etl_ms, bs)
                self.iteration_count += 1
                etl_ms = 0.0
            etl_start = time.perf_counter()

    def _plan_local(self, struct):
        """(this rank's block of the batch struct, its loss scale) under
        an engaged plan; (struct, None) without one."""
        if self._plan_rt is None:
            return struct, None
        return self._plan_rt.local_batch(struct, self._loss_mask(struct))

    @staticmethod
    def _scaled(result, scale):
        """A score function's (loss, aux) with the loss times `scale`."""
        if scale is None:
            return result
        loss, aux = result
        return loss * scale, aux

    def _engage_plan(self, plan):
        """Engage `plan` on the network (None: whole tensors, no plan).
        Engaging or releasing a plan drops the captured steps and ledger
        records: they hold (or lack) the plan's collectives."""
        rt = self._plan_rt
        if rt is not None and rt.plan != plan:
            self._plan_rt = None
            rt.release(self)
            self._plan_syncs += rt.syncs
            self._drop_graphs()
            self._ledger_cache = {}
        if plan is not None and self._plan_rt is None:
            from deeplearning4j_tpu_torch.parallel.plan import PlanRuntime
            self._plan_rt = PlanRuntime(plan, self)
            self._drop_graphs()
            self._ledger_cache = {}

    def _fit_modes(self, scan_steps, accumulate_steps, plan):
        """Validate fit's options as the reference does: (the resolved
        scan_steps, the plan: `plan`, else the `use_mesh` one)."""
        from deeplearning4j_tpu_torch.parallel.plan import (
            ShardingPlan, active_plan, check_capturable,
        )
        if plan is None:
            plan = active_plan()
        if plan is not None and not isinstance(plan, ShardingPlan):
            raise TypeError(f"plan must be a parallel.ShardingPlan, got "
                            f"{type(plan).__name__}")
        scan_steps = self._resolve_scan(scan_steps, accumulate_steps)
        if plan is not None and (scan_steps > 1 or accumulate_steps > 1):
            check_capturable(self.device)
        return scan_steps, plan

    def _resolve_scan(self, scan_steps, accumulate_steps):
        if accumulate_steps > 1:
            if self.conf.backprop_type == "tbptt":
                raise ValueError("accumulate_steps does not apply to "
                                 "tbptt (chunked-time) training")
            if scan_steps is not None and scan_steps > 1:
                raise ValueError("accumulate_steps and scan_steps are "
                                 "mutually exclusive (one fuses K optimizer "
                                 "steps, the other folds K micro-batches "
                                 "into one step)")
            return 1
        return step_graph.default_scan_steps() if scan_steps is None \
            else scan_steps

    # ---------------------------------------------------------- evaluation
    def evaluate(self, data, batch_size: int = 32):
        """Classification evaluation (DL4J evaluate(DataSetIterator))."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate_with(Evaluation(), data, batch_size)

    def evaluate_roc(self, data, batch_size: int = 32):
        """Binary ROC evaluation (DL4J evaluateROC)."""
        from deeplearning4j_tpu_torch.eval.roc import ROC
        return self._evaluate_with(ROC(), data, batch_size)

    def evaluate_roc_multi_class(self, data, batch_size: int = 32):
        """One-vs-all per-class ROC (DL4J evaluateROCMultiClass)."""
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
        return self._evaluate_with(ROCMultiClass(), data, batch_size)

    def evaluate_regression(self, data, batch_size: int = 32):
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation,
        )
        return self._evaluate_with(RegressionEvaluation(), data, batch_size)


class MultiLayerNetwork(TrainableNet):
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_matmul_exact()
        self.params: Optional[Dict[str, dict]] = None
        self.state: Optional[Dict[str, dict]] = None
        self.opt_state: Optional[dict] = None
        self.listeners: List = []
        self.iteration_count = 0
        self.epoch_count = 0
        self._score: Optional[float] = None
        self._reset_fit_state()
        self._param_dtype = torch_dtype(conf.dtype)
        self._compute_dtype = torch_dtype(conf.compute_dtype or conf.dtype)
        self._input_types: Optional[List[InputType]] = None
        self._constraints = constraint_map(self) \
            if has_constraints(self.layers) else {}
        self._rnn_carries: dict = {}

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def _resolve_types(self) -> List[InputType]:
        """Per-layer input InputTypes (pre-preprocessor)."""
        if self.conf.input_type is None:
            raise ValueError("MultiLayerConfiguration.input_type must be set "
                             "(InputType.feed_forward/convolutional/recurrent)")
        types = []
        cur = self.conf.input_type
        for layer in self.layers:
            need = _required_kind(layer)
            if need is not None and cur.kind != need:
                cur = preprocessed_type(cur, need)
            types.append(cur)
            cur = layer.output_type(cur)
        self._output_type = cur
        return types

    def init(self, seed: Optional[int] = None):
        """Initialize parameters from `seed` (default: the config's) on a
        CPU `torch.Generator`, move them to the device, and build the
        optimizer state there."""
        seed = self.conf.seed if seed is None else seed
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        for layer in self.layers:
            validate_layer_conf(layer)
        self._input_types = self._resolve_types()
        params, state = {}, {}
        for i, layer in enumerate(self.layers):
            p, s = layer.init(gen, self._input_types[i], self._param_dtype)
            params[str(i)] = tree_to(p, self.device)
            state[str(i)] = tree_to(s, self.device)
        self.params, self.state = params, state
        self._build_optimizer()
        return self

    def _label_tree(self):
        return [(str(i), "layer_", layer)
                for i, layer in enumerate(self.layers)]

    def _cast_params(self, params):
        if self._compute_dtype == self._param_dtype:
            return params
        return tree_to(params, self.device, self._compute_dtype)

    def _as_input(self, x) -> torch.Tensor:
        return as_input(x, self.device, self._compute_dtype)

    def _as_labels(self, y) -> torch.Tensor:
        return as_labels(y, self.device, self._compute_dtype)

    def _as_mask(self, m) -> Optional[torch.Tensor]:
        return as_mask(m, self.device)

    def _forward(self, params, state, x, train: bool, generator=None,
                 fmask=None, upto: Optional[int] = None, carries=None,
                 collect: bool = False):
        """Forward through layers [0, upto) (all by default) with the auto
        preprocessors; RNN-kind layers get the features mask. When `upto`
        stops before the head, the activation is preprocessed into the
        head's kind, ready for head.score(). With `carries` (a dict by
        layer key; {} is the zero state), the recurrent layers run
        `apply_seq` from their carry. Returns (activation, or every
        layer's activation in order with `collect`, new state, new
        carries)."""
        if self._input_types is None:
            self._input_types = self._resolve_types()
        params = self._cast_params(params)
        cur_type = self.conf.input_type
        n = len(self.layers) if upto is None else upto
        new_state = dict(state)
        new_carries = {}
        acts = []
        for i, layer in enumerate(self.layers[:n]):
            key = str(i)
            need = _required_kind(layer)
            if need is not None and cur_type.kind != need:
                x = preprocess_forward(cur_type, need, x)
                cur_type = preprocessed_type(cur_type, need)
            mask = fmask if cur_type.kind == Kind.RNN else None
            layer_params = apply_weight_noise(layer, params[key], train,
                                              generator)
            remat = train and self.conf.gradient_checkpointing
            if carries is not None and _is_stateful_recurrent(layer):
                x, new_carries[key] = layer_call(
                    layer, layer_params, state[key], x, train=train,
                    mask=mask, generator=generator, remat=remat, seq=True,
                    carry=carries.get(key))
            else:
                x, new_state[key] = layer_call(
                    layer, layer_params, state[key], x, train=train,
                    mask=mask, generator=generator, remat=remat)
            cur_type = layer.output_type(cur_type)
            if collect:
                acts.append(x)
        if upto is not None and upto < len(self.layers):
            need = _required_kind(self.layers[upto])
            if need is not None and cur_type.kind != need:
                x = preprocess_forward(cur_type, need, x)
        return (acts if collect else x), new_state, new_carries

    def _score_fn(self, params, state, x, y, fmask, lmask, train: bool,
                  generator=None, carries=None):
        """Loss on a batch: the head's score plus regularization
        (computeGradientAndScore), in f32 or wider; and (new state, new
        carries)."""
        if not self.layers or not hasattr(self.layers[-1], "score"):
            raise ValueError("Last layer must be an output/loss layer with a "
                             "score() method to compute training loss")
        head_i = len(self.layers) - 1
        params_c = self._cast_params(params)
        feat, new_state, new_carries = self._forward(
            params_c, state, x, train, generator, fmask, upto=head_i,
            carries=carries)
        out_mask = lmask if lmask is not None else (
            fmask if _required_kind(self.layers[head_i]) == Kind.RNN
            else None)
        # the reference scores the head with no dropout key
        loss = self.layers[head_i].score(params_c[str(head_i)], feat, y,
                                         train=train, generator=None,
                                         mask=out_mask)
        reg = torch.zeros((), dtype=torch.float32, device=loss.device)
        for i, layer in enumerate(self.layers):
            reg = reg + layer.regularization_score(params[str(i)])
        score_dtype = torch.promote_types(torch.float32, loss.dtype)
        return loss.to(score_dtype) + reg, (new_state, new_carries)

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference (DL4J output()): a tensor on the network's device.
        As in the reference, `train` is accepted and the forward is the
        inference one."""
        if self.params is None:
            raise RuntimeError("Network is not initialized — call init() first")
        with torch.inference_mode():
            y, _, _ = self._forward(self.params, self.state,
                                    self._as_input(x), False)
        return y

    def feed_forward(self, x, train: bool = False, rng=None):
        """Every layer's activation, in order (DL4J feedForward()). With
        train=True the dropout noise comes from `rng`, a torch.Generator
        on the network's device; without one, each call draws from a
        fresh generator (seeded from the config's seed and a call
        counter), so repeated calls do not reuse one mask."""
        if self.params is None:
            raise RuntimeError("Network is not initialized — call init() first")
        if train and rng is None:
            self._ff_counter = getattr(self, "_ff_counter", 0) + 1
            rng = torch.Generator(device=self.device).manual_seed(
                self.conf.seed + 15485863 * self._ff_counter)
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.state,
                                       self._as_input(x), train,
                                       rng if train else None, collect=True)
        return acts

    # ----------------------------------------------------------------- fit
    @staticmethod
    def _batch_struct(ds: DataSet) -> tuple:
        return (ds.features, ds.labels, ds.features_mask, ds.labels_mask)

    def _grad_struct(self, struct, generator, carries=None):
        """(loss, grads, new state, new carries) of one batch struct;
        under a plan, of this rank's block, scaled by its share."""
        struct, scale = self._plan_local(struct)
        x, y, fm, lm = struct
        loss, grads, (new_state, new_carries) = self._gradients(
            lambda live: self._scaled(self._score_fn(
                live, self.state, self._stage_x(x), self._as_labels(y),
                self._as_mask(fm), self._as_mask(lm), True, generator,
                carries), scale))
        return loss, grads, new_state, new_carries

    def _loss_mask(self, struct):
        """The mask the loss normalizes by: the labels mask, else the
        features mask under a sequence head."""
        _, _, fm, lm = struct
        if lm is not None:
            return lm
        if self.layers and _required_kind(self.layers[-1]) == Kind.RNN:
            return fm
        return None

    def _tbptt_chunks(self, struct):
        """The batch in chunks of tbptt_fwd_length along time: features,
        (B, T) masks and rank-3 labels are sliced; rank-2 labels (one per
        sequence) are not."""
        x, y, fm, lm = struct
        fwd = self.conf.tbptt_fwd_length
        for t0 in range(0, x.shape[1], fwd):
            t1 = t0 + fwd
            yield (x[:, t0:t1],
                   y[:, t0:t1] if y is not None and y.ndim >= 3 else y,
                   None if fm is None else fm[:, t0:t1],
                   None if lm is None else lm[:, t0:t1])

    def _id_inputs(self):
        """The features feed an embedding when the first layer is one."""
        first = unwrap_frozen(self.layers[0]) if self.layers else None
        if hasattr(first, "id_range"):
            return [(0, first, first.id_range(self.params["0"]))]
        return []

    def compute_gradient_and_score(self, dataset: DataSet,
                                   generator=None):
        """DL4J computeGradientAndScore on one batch, in training mode:
        (score tensor, gradient tree shaped like `params`, new layer
        state). Gradients are taken with respect to the parameters as
        stored (f32 master weights under bf16 compute)."""
        return self._grad_struct(self._batch_struct(dataset), generator)[:3]

    def _train_step(self, ds: DataSet, generator) -> torch.Tensor:
        """One optimizer step: forward and backward, the updater chain
        (clipping included), the in-place update; the new optimizer and
        layer state are written into the old tensors. The loss is
        returned on the device; the caller fetches it."""
        return self._step_struct(self._batch_struct(ds), generator)

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            scan_steps: Optional[int] = None,
            prefetch: Optional[bool] = None,
            accumulate_steps: int = 1,
            plan=None):
        """Train (DL4J fit(DataSetIterator)) on a DataSetIterator, a
        DataSet, or (features, labels) arrays, with the reference's
        signature and semantics.

        - Per-call (the default, scan_steps=1): each step ends in one
          `float(loss)` fetch, then the listeners' `iteration_done`.
        - scan_steps > 1: consecutive same-shape batches in chunks of K;
          on CUDA each step replays a captured graph of the train step
          (`nn/step_graph.py`), the K losses are fetched once per chunk,
          one chunk late. The update math, the dropout stream and the
          listener calls are the per-call path's. Model-reading listeners
          force the per-call path; a ragged tail runs per-call steps.
          Default: DL4J_CUDA_SCAN_STEPS, else 1.
        - accumulate_steps > 1: K micro-batch gradients averaged into one
          optimizer step (a short group at a shape change or the epoch's
          end takes the mean of what it holds); batch-norm statistics
          stay per micro-batch. Exclusive with scan_steps > 1.
        - prefetch (default on; DL4J_CUDA_FIT_PREFETCH=0 or
          DL4J_CUDA_PREFETCH_DEPTH=0 turn it off): a worker thread
          stages the next batches onto the device (AsyncDataSetIterator).
        - A pre-processor with a `device_affine()` (e.g.
          ImagePreProcessingScaler) is detached for the fit and applied
          on the device: raw uint8 pixels cross the link.
        - backprop_type "tbptt": per-call chunk steps whatever scan_steps
          says (`_fit_epoch_tbptt`); accumulate_steps > 1 raises.

        - plan (a `parallel.ShardingPlan`; default: the `use_mesh`
          plan): data parallelism over the process group's ranks, each
          reading the global batch and keeping its block of rows, with
          the plan's ZeRO stage and rules (`parallel/plan.py`). Every
          path above runs under it; on CUDA the scan and accumulate
          paths need NCCL. At the end the network holds whole tensors."""
        if self.params is None:
            self.init()
        scan_steps, plan = self._fit_modes(scan_steps, accumulate_steps,
                                           plan)
        iterator = self._as_iterator(data, batch_size)
        if prefetch is None:
            prefetch = fit_prefetch_enabled()
        with engaged_device_affine(iterator, self.listeners) as aff:
            self._set_input_affine(aff)
            if prefetch and not isinstance(iterator, AsyncDataSetIterator) \
                    and getattr(iterator, "async_supported", True):
                iterator = AsyncDataSetIterator(iterator, device=self.device,
                                                check=self._check_ids)
            staged = isinstance(iterator, AsyncDataSetIterator) \
                and not iterator._passthrough
            copy_marked = self._own_held_batches(
                iterator, iterator._device if staged else self.device,
                staged, scan_steps, accumulate_steps)
            try:
                self._engage_plan(plan)
                self._run_epochs(epochs, lambda: iterator, scan_steps,
                                 accumulate_steps, 7919, iterator.reset)
            finally:
                self._engage_plan(None)
                self._input_affine = None
                restore_view_batches(copy_marked)
        return self

    def fit_pretrain(self, data, epochs: int = 1, batch_size: int = 32):
        """Greedy layerwise unsupervised pretraining (the `pretrain` branch
        of DL4J MultiLayerNetwork.fit). For each layer with a
        `pretrain_score` (AutoEncoder, VariationalAutoencoder), in order:
        its features come from the layers below in inference mode, and
        only its parameters move, on its unsupervised objective, with an
        optimizer built from its own updater (else the network's) and the
        network's clipping. The noise comes from one generator on the
        network's device seeded with ``conf.seed + 52711`` (the
        reference's seed; the streams differ). Supervised layers are
        skipped; `fit()` then fine-tunes with a fresh optimizer state."""
        if self.params is None:
            self.init()
        iterator = self._as_iterator(data, batch_size)
        generator = torch.Generator(device=self.device).manual_seed(
            self.conf.seed + 52711)
        for i, layer in enumerate(self.layers):
            if not hasattr(layer, "pretrain_score"):
                continue
            tx = build_optimizer(layer.updater or self.conf.updater,
                                 self.conf.grad_clip_norm,
                                 self.conf.grad_clip_value)
            lp = self.params[str(i)]
            opt_state = tx.init(lp)
            loss = None
            for _ in range(epochs):
                for ds in iterator:
                    with torch.no_grad():
                        feats, _, _ = self._forward(
                            self.params, self.state,
                            self._as_input(ds.features), False, upto=i)
                    # the reference's promotion: f32 parameters lift
                    # 16-bit features
                    feats = feats.to(torch.promote_types(feats.dtype,
                                                         self._param_dtype))
                    loss, grads, _ = self._gradients(
                        lambda live: (layer.pretrain_score(
                            live, feats, generator), ()), lp)
                    with torch.no_grad():
                        updates, opt_state = tx.update(grads, opt_state, lp)
                        apply_updates(lp, updates)
                iterator.reset()
            if loss is not None:
                self._score = float(loss)
        self._build_optimizer()     # a fresh optimizer state for fit()
        return self

    def _as_iterator(self, data, batch_size) -> DataSetIterator:
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, DataSet):
            return ExistingDataSetIterator([data])
        if isinstance(data, (tuple, list)) and len(data) == 2:
            return ArrayDataSetIterator(data[0], data[1], batch_size=batch_size)
        raise ValueError(f"Cannot interpret training data: {type(data)}")

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The last training score, with no forward; or the score on
        `dataset` (inference mode) (DL4J score())."""
        if dataset is None:
            return self._score if self._score is not None else float("nan")
        with torch.no_grad():
            loss, _ = self._score_fn(
                self.params, self.state, self._as_input(dataset.features),
                self._as_labels(dataset.labels),
                self._as_mask(dataset.features_mask),
                self._as_mask(dataset.labels_mask), False)
        return float(loss)

    def _evaluate_with(self, ev, data, batch_size: int = 32):
        iterator = self._as_iterator(data, batch_size)
        for ds in iterator:
            ev.eval(*masked_eval_pair(host_array(ds.labels),
                                      host_array(self.output(ds.features)),
                                      ds.labels_mask))
        iterator.reset()
        return ev

    # ------------------------------------------------------ recurrent state
    def rnn_time_step(self, x):
        """Stateful streaming inference (DL4J rnnTimeStep): x is (B, F),
        one step, which returns (B, n_out); or (B, T, F), which returns
        (B, T, n_out). The recurrent layers' state persists across calls
        until `rnn_clear_previous_state()`. Runs under no_grad, so the
        state it keeps can enter a later training forward."""
        x = self._as_input(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        with torch.no_grad():
            y, _, self._rnn_carries = self._forward(
                self.params, self.state, x, False,
                carries=self._rnn_carries)
        return y[:, -1, :] if single and y.ndim == 3 else y

    def rnn_clear_previous_state(self):
        self._rnn_carries = {}

    def summary(self) -> str:
        """Layer table: index, type, input and output shapes, parameter
        count, and the total (MultiLayerNetwork.summary())."""
        if self.params is None:
            raise RuntimeError("init() the network before summary()")
        types = self._input_types or self._resolve_types()
        rows = [("idx", "type", "in", "out", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            in_t = types[i]
            out_t = layer.output_type(in_t)
            n = param_util.num_params(self.params[str(i)])
            total += n
            rows.append((str(i), type(layer).__name__,
                         "x".join(map(str, in_t.shape)),
                         "x".join(map(str, out_t.shape)), f"{n:,}"))
        return param_util.format_param_table(rows, total)

    def num_params(self) -> int:
        return param_util.num_params(self.params or {})

    def params_flat(self) -> torch.Tensor:
        """Canonical flat parameter vector (DL4J's flattenedParams view),
        in the reference's leaf order."""
        return param_util.params_to_flat(self.params)

    def set_params_flat(self, flat):
        """Load a flat vector in `params_flat`'s order."""
        self.params = param_util.flat_to_params(flat, self.params)
        self._drop_graphs()

    def memory_report(self, batch_size: int = 32, with_compiled: bool = True):
        """Per-layer analytic memory estimate and, on CUDA, the measured
        peak of one training step (DL4J NetworkMemoryReport analog — see
        util/memory.py)."""
        from deeplearning4j_tpu_torch.util.memory import build_memory_report
        return build_memory_report(self, batch_size, with_compiled)

    def copy(self) -> "MultiLayerNetwork":
        """A network of the same configuration on the same device, with
        copies of the parameters and layer state and a fresh optimizer."""
        clone = MultiLayerNetwork(self.conf, device=self.device)
        if self.params is not None:
            clone._input_types = self._resolve_types()
            clone.params = tree_map(torch.clone, self.params)
            clone.state = tree_map(torch.clone, self.state)
            clone._build_optimizer()
        return clone
