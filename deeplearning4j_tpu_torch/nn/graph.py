"""ComputationGraph — the DAG network container.

Counterpart of the JAX package's `nn/graph.py`: `init()` resolves every
vertex's InputType and builds the parameter dicts in topological order
(the order of the parameter dict, and so of `params_flat` and the
optimizer state, is the reference's), `output()` runs the DAG with the
automatic preprocessors and per-path mask routing, and `fit()` trains
with the reference's per-call step: forward and backward (autograd in
place of `jax.value_and_grad`), the global updater chain, the
constraints' projection, one loss fetch per step, then the listeners.
The score is each output's loss on the activation that enters it (the
reference's `__pre__` features) plus the l1/l2 penalty summed over the
layer vertices, in f32 or wider.

Parameters are a dict ``{vertex name: {...}}`` of tensors with the
reference's key paths and layouts (HWIO kernels, (in, out) weights), so a
checkpoint moves between the packages with no transposes. Under a bf16
`compute_dtype` the parameters are cast inside the step and the master
weights and optimizer state stay f32.

The graph lives on one device, CUDA unless the caller asks for the CPU
(`util.platform.resolve_device`); without CUDA the default raises.

Not yet ported, each raising NotImplementedError that names ROADMAP A.6:
the scan and accumulate fit paths, tbptt, sharding plans, gradient
checkpointing, `evaluate*`, `rnn_time_step`, per-vertex updaters and
frozen vertices.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, preprocess_forward, preprocessed_type,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertexConf
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _required_kind, as_input, as_labels, as_mask, torch_dtype, tree_to,
    validate_layer_conf,
)
from deeplearning4j_tpu_torch.nn.regularization import (
    apply_constraints, apply_weight_noise, constraint_map, has_constraints,
)
from deeplearning4j_tpu_torch.nn.updaters import (
    apply_updates, build_optimizer, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.util import params as param_util
from deeplearning4j_tpu_torch.util.platform import (
    DeviceLike, resolve_device, set_f32_matmul_exact,
)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to the PyTorch "
                               "port (ROADMAP A.6)")


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
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
        self._tx = None
        self._param_dtype = torch_dtype(conf.dtype)
        self._compute_dtype = torch_dtype(conf.compute_dtype or conf.dtype)
        self._topo = conf.topological_order()
        self._vertex_types: Optional[Dict[str, InputType]] = None
        self._pre_kind: Dict[str, Optional[Kind]] = {}
        layers = [vd.vertex for vd in conf.vertices.values()]
        self._constraints = constraint_map(self) \
            if has_constraints(layers) else {}
        # output vertices no other vertex reads: the score needs only
        # their input (the reference's XLA program drops their forward)
        consumed = {i for vd in conf.vertices.values() for i in vd.inputs}
        self._unread_outputs = set(conf.network_outputs) - consumed

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    # ----------------------------------------------------------- init/types
    def _resolve_types(self) -> Dict[str, InputType]:
        """InputType of every vertex output (DL4J getLayerActivationTypes)."""
        if len(self.conf.input_types) != len(self.conf.network_inputs):
            raise ValueError("ComputationGraphConfiguration.input_types must "
                             "match network_inputs")
        types: Dict[str, InputType] = dict(zip(self.conf.network_inputs,
                                               self.conf.input_types))
        self._pre_kind = {}
        for name in self._topo:
            vd = self.conf.vertices[name]
            in_types = [types[i] for i in vd.inputs]
            if isinstance(vd.vertex, GraphVertexConf):
                self._pre_kind[name] = None
                types[name] = vd.vertex.output_type(*in_types)
                continue
            need = _required_kind(vd.vertex)
            self._pre_kind[name] = need
            t = in_types[0]
            if need is not None and t.kind != need:
                t = preprocessed_type(t, need)
            types[name] = vd.vertex.output_type(t)
        return types

    def init(self, seed: Optional[int] = None):
        """Initialize parameters from `seed` (default: the config's) on a
        CPU `torch.Generator`, vertex by vertex in topological order, move
        them to the device, and build the optimizer state there."""
        seed = self.conf.seed if seed is None else seed
        for name in self.conf.network_outputs:
            if name not in self.conf.vertices:
                raise ValueError(f"Unknown output vertex '{name}'")
            v = self.conf.vertices[name].vertex
            if not hasattr(v, "score"):
                raise ValueError(
                    f"Output vertex '{name}' ({type(v).__name__}) must be an "
                    "output/loss layer with a score() method")
        for vd in self.conf.vertices.values():
            if isinstance(vd.vertex, LayerConf):
                validate_layer_conf(vd.vertex)
        self._vertex_types = self._resolve_types()
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        params: Dict[str, dict] = {}
        state: Dict[str, dict] = {}
        for name in self._topo:
            vd = self.conf.vertices[name]
            if isinstance(vd.vertex, GraphVertexConf):
                continue
            p, s = vd.vertex.init(gen, self._layer_input_type(name),
                                  self._param_dtype)
            params[name] = tree_to(p, self.device)
            state[name] = tree_to(s, self.device)
        self.params, self.state = params, state
        self._build_optimizer()
        return self

    def _layer_input_type(self, name: str) -> InputType:
        t = self._vertex_types[self.conf.vertices[name].inputs[0]]
        need = self._pre_kind[name]
        return preprocessed_type(t, need) if need is not None \
            and t.kind != need else t

    def _unported_optimizer(self) -> Optional[str]:
        for name, vd in self.conf.vertices.items():
            if getattr(vd.vertex, "frozen", False) or \
                    getattr(vd.vertex, "updater", None) is not None:
                return (f"vertex {name!r}: per-vertex updaters and frozen "
                        "vertices (optax.multi_transform)")
        return None

    def _build_optimizer(self):
        """The global updater chain and a fresh state. A config the port
        cannot train yet gets no optimizer; fit() then raises."""
        self._tx = None
        self.opt_state = None
        if self._unported_optimizer() is None:
            self._tx = build_optimizer(self.conf.updater,
                                       self.conf.grad_clip_norm,
                                       self.conf.grad_clip_value)
            self.opt_state = self._tx.init(self.params)

    def optimizer_state_template(self) -> dict:
        """A fresh optimizer state: the structure, shapes and dtypes a
        loaded updaterState.bin must have."""
        if self._tx is None:
            raise _not_ported(self._unported_optimizer())
        return self._tx.init(self.params)

    # -------------------------------------------------------------- forward
    def _cast_params(self, params):
        if self._compute_dtype == self._param_dtype:
            return params
        return tree_to(params, self.device, self._compute_dtype)

    @staticmethod
    def _vertex_out_mask(vertex, in_masks, xs, out_type):
        """Mask propagation through a graph vertex (DL4J
        GraphVertex.feedForwardMaskArrays): time-collapsing vertices drop
        the mask, DuplicateToTimeSeries adopts its reference input's,
        Reverse flips it, Stack/Unstack concatenate/slice it along the
        batch, every other vertex forwards the first mask it has."""
        if out_type.kind != Kind.RNN:
            return None
        vname = type(vertex).__name__
        if vname == "DuplicateToTimeSeriesVertex":
            return in_masks[1]
        if vname == "ReverseTimeSeriesVertex":
            m = in_masks[0]
            return None if m is None else torch.flip(m, dims=(1,))
        if vname == "StackVertex":
            if all(m is None for m in in_masks):
                return None
            return torch.cat(
                [torch.ones(x.shape[:2], dtype=torch.float32,
                            device=x.device) if m is None else m
                 for m, x in zip(in_masks, xs)], dim=0)
        if vname == "UnstackVertex":
            m = in_masks[0]
            if m is None:
                return None
            n = m.shape[0] // vertex.stack_size
            return m[vertex.from_idx * n:(vertex.from_idx + 1) * n]
        return next((m for m in in_masks if m is not None), None)

    def _forward(self, params, state, inputs: Sequence, train: bool,
                 generator=None, fmasks: Optional[Sequence] = None,
                 stash_pre: bool = False):
        """Run the DAG. Returns (activations by name, new state, masks by
        name). Each vertex sees the mask propagated along its own inputs.
        With `stash_pre`, the input of each output vertex is kept under
        ``"__pre__" + name`` for its score, and an output vertex that no
        other vertex reads is not run."""
        if self._vertex_types is None:
            self._vertex_types = self._resolve_types()
        params = self._cast_params(params)
        acts: Dict[str, Any] = {}
        masks: Dict[str, Any] = {}
        for i, name in enumerate(self.conf.network_inputs):
            acts[name] = inputs[i]
            masks[name] = (None if fmasks is None or i >= len(fmasks)
                           else fmasks[i])
        new_state = {}
        for name in self._topo:
            vd = self.conf.vertices[name]
            xs = [acts[i] for i in vd.inputs]
            in_masks = [masks[i] for i in vd.inputs]
            if isinstance(vd.vertex, GraphVertexConf):
                acts[name] = vd.vertex.apply(*xs)
                masks[name] = self._vertex_out_mask(
                    vd.vertex, in_masks, xs, self._vertex_types[name])
                continue
            x = xs[0]
            need = self._pre_kind[name]
            src_t = self._vertex_types[vd.inputs[0]]
            if need is not None and src_t.kind != need:
                x = preprocess_forward(src_t, need, x)
            m = in_masks[0] if need == Kind.RNN else None
            if stash_pre and name in self.conf.network_outputs:
                acts["__pre__" + name] = x
                if name in self._unread_outputs:
                    new_state[name] = state.get(name, {})
                    continue
            layer_params = apply_weight_noise(
                vd.vertex, params.get(name, {}), train, generator)
            acts[name], new_state[name] = vd.vertex.apply(
                layer_params, state.get(name, {}), x, train=train, mask=m,
                generator=generator)
            masks[name] = (in_masks[0]
                           if self._vertex_types[name].kind == Kind.RNN
                           else None)
        return acts, new_state, masks

    def _as_inputs(self, features) -> tuple:
        return tuple(as_input(f, self.device, self._compute_dtype)
                     for f in features)

    def _as_labels(self, labels) -> tuple:
        return tuple(as_labels(l, self.device, self._compute_dtype)
                     for l in labels)

    def _as_masks(self, masks) -> Optional[tuple]:
        return None if masks is None else tuple(as_mask(m, self.device)
                                                for m in masks)

    # --------------------------------------------------------------- output
    def output(self, *inputs, train: bool = False):
        """Inference (ComputationGraph.output): one tensor on the graph's
        device per network output (a bare tensor for one output). As in
        the reference, `train` is accepted and the forward is the
        inference one."""
        if self.params is None:
            raise RuntimeError("Network is not initialized — call init() "
                               "first")
        with torch.inference_mode():
            acts, _, _ = self._forward(self.params, self.state,
                                       self._as_inputs(inputs), False)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs, train: bool = False):
        """Every vertex's activation, by name (DL4J feedForward)."""
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.state,
                                       self._as_inputs(inputs), train)
        return acts

    # ------------------------------------------------------------------ fit
    def _score_fn(self, params, state, inputs, labels, fmasks, lmasks,
                  train: bool, generator=None):
        """Loss on a batch: every output's score on its `__pre__` features,
        plus the l1/l2 penalty over the layer vertices, in f32 or wider."""
        params_c = self._cast_params(params)
        acts, new_state, masks = self._forward(
            params_c, state, inputs, train, generator, fmasks,
            stash_pre=True)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, out_name in enumerate(self.conf.network_outputs):
            vd = self.conf.vertices[out_name]
            lmask = None
            if lmasks is not None and lmasks[i] is not None:
                lmask = lmasks[i]
            elif self._vertex_types[out_name].kind == Kind.RNN:
                lmask = masks[vd.inputs[0]]
            # the reference scores the head with no dropout key
            s = vd.vertex.score(params_c.get(out_name, {}),
                                acts["__pre__" + out_name], labels[i],
                                train=train, generator=None, mask=lmask)
            total = total + s.to(torch.promote_types(torch.float32, s.dtype))
        for name, p in params.items():
            vertex = self.conf.vertices[name].vertex
            if isinstance(vertex, LayerConf):
                total = total + vertex.regularization_score(p)
        return total, new_state

    def compute_gradient_and_score(self, mds: MultiDataSet, generator=None):
        """DL4J computeGradientAndScore on one batch, in training mode:
        (score tensor, gradient tree shaped like `params`, new vertex
        state). Gradients are taken with respect to the parameters as
        stored (f32 master weights under bf16 compute)."""
        live = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), self.params)
        leaves = [t for t in tree_leaves(live) if t.requires_grad]
        with torch.enable_grad():
            loss, new_state = self._score_fn(
                live, self.state, self._as_inputs(mds.features),
                self._as_labels(mds.labels),
                self._as_masks(mds.features_masks),
                self._as_masks(mds.labels_masks), True, generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads) if g is not None}
        grad_tree = tree_map(lambda t: by_leaf[id(t)] if id(t) in by_leaf
                             else torch.zeros_like(t), live)
        new_state = tree_map(lambda t: t.detach(), new_state)
        return loss.detach(), grad_tree, new_state

    def _train_step(self, mds: MultiDataSet, generator) -> torch.Tensor:
        """One optimizer step: forward and backward, the updater chain,
        the in-place update, the constraints' projection. The loss is
        returned on the device; the caller fetches it."""
        loss, grads, new_state = self.compute_gradient_and_score(mds,
                                                                 generator)
        with torch.no_grad():
            updates, self.opt_state = self._tx.update(grads, self.opt_state,
                                                      self.params)
            apply_updates(self.params, updates)
            if self._constraints:
                apply_constraints(self._constraints, self.params)
        self.state = new_state
        return loss

    def _check_trainable(self, scan_steps, accumulate_steps, plan):
        if scan_steps is not None and scan_steps > 1:
            raise _not_ported("fit(scan_steps > 1)")
        if accumulate_steps > 1:
            raise _not_ported("fit(accumulate_steps > 1)")
        if plan is not None:
            raise _not_ported("fit(plan=...)")
        if self.conf.backprop_type == "tbptt":
            raise _not_ported("tbptt training")
        if self.conf.gradient_checkpointing:
            raise _not_ported("gradient checkpointing")
        if self._tx is None:
            raise _not_ported(self._unported_optimizer())

    def fit(self, data, epochs: int = 1, scan_steps: Optional[int] = None,
            accumulate_steps: int = 1, plan=None):
        """Train (ComputationGraph.fit) on a MultiDataSet, a DataSet, a
        (features, labels) pair of arrays, or an iterable of these, with
        the reference's signature. Each step: forward and backward, update
        in place, one `float(loss)` fetch, then the listeners. The
        reference's scan, accumulate and plan options raise (scan_steps=1
        is the plain per-call path and is accepted)."""
        if self.params is None:
            self.init()
        self._check_trainable(scan_steps, accumulate_steps, plan)
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch_count)
            self._fit_epoch(data)
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
            if hasattr(data, "reset"):
                data.reset()
        return self

    def _fit_epoch(self, data):
        # dropout masks: one generator per epoch on the device, seeded as
        # the reference seeds its epoch key (the streams themselves differ)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.conf.seed + 331 * (self.epoch_count + 1))
        etl_start = time.perf_counter()
        for mds in self._iter_data(data):
            etl_ms = (time.perf_counter() - etl_start) * 1e3
            loss = self._train_step(mds, generator)
            self._score = float(loss)         # the step's one loss fetch
            bs = int(np.shape(mds.features[0])[0])
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.epoch_count, self._score, etl_ms, bs)
            self.iteration_count += 1
            etl_start = time.perf_counter()

    def _iter_data(self, data):
        if isinstance(data, (tuple, list)) and len(data) == 2 \
                and all(hasattr(d, "shape") for d in data):
            data = MultiDataSet((data[0],), (data[1],), None, None)
        if isinstance(data, MultiDataSet):
            yield data
        elif isinstance(data, DataSet):
            yield MultiDataSet(
                (data.features,), (data.labels,),
                None if data.features_mask is None else (data.features_mask,),
                None if data.labels_mask is None else (data.labels_mask,))
        else:
            for item in data:
                yield from self._iter_data(item)

    # -------------------------------------------------------------- scoring
    def score(self, mds: Optional[MultiDataSet] = None) -> float:
        """The last training score, with no forward; or the score on `mds`
        (inference mode)."""
        if mds is None:
            return self._score if self._score is not None else float("nan")
        if isinstance(mds, DataSet):
            mds = MultiDataSet((mds.features,), (mds.labels,))
        with torch.no_grad():
            loss, _ = self._score_fn(
                self.params, self.state, self._as_inputs(mds.features),
                self._as_labels(mds.labels), None, None, False)
        return float(loss)

    def evaluate(self, data, batch_size: int = 32):
        raise _not_ported("evaluate()")

    def evaluate_roc(self, data, batch_size: int = 32):
        raise _not_ported("evaluate_roc()")

    def evaluate_roc_multi_class(self, data, batch_size: int = 32):
        raise _not_ported("evaluate_roc_multi_class()")

    def rnn_time_step(self, *inputs):
        raise _not_ported("rnn_time_step()")

    def rnn_clear_previous_state(self):
        raise _not_ported("rnn_clear_previous_state()")

    # -------------------------------------------------------------- summary
    def summary(self) -> str:
        """Vertex table in topological order: name, type, inputs, output
        shape, parameter count."""
        if self.params is None:
            raise RuntimeError("init() the network before summary()")
        types = self._vertex_types or self._resolve_types()
        self._vertex_types = types
        rows = [("vertex", "type", "inputs", "out", "params")]
        total = 0
        for name in self._topo:
            vd = self.conf.vertices[name]
            n = param_util.num_params(self.params.get(name, {}))
            total += n
            rows.append((name, type(vd.vertex).__name__, ",".join(vd.inputs),
                         "x".join(map(str, types[name].shape)), f"{n:,}"))
        return param_util.format_param_table(rows, total)

    # --------------------------------------------------------------- params
    def num_params(self) -> int:
        return param_util.num_params(self.params or {})

    def params_flat(self) -> torch.Tensor:
        return param_util.params_to_flat(self.params)

    def set_params_flat(self, flat):
        self.params = param_util.flat_to_params(flat, self.params)
