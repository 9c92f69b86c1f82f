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

`fit` runs the reference's paths as `MultiLayerNetwork.fit` does: scan-of-K
(a replayed CUDA graph of the train step on CUDA, `nn/step_graph.py`),
gradient accumulation, prefetch with device-side normalization, per-vertex
updaters and frozen vertices, per-vertex gradient checkpointing, and
truncated BPTT (every sequence input, label and mask chunked along one
shared T, the recurrent vertices' state carried across chunks); then
`evaluate*` and `rnn_time_step`. A sharding plan (`fit(plan=)` or the
`use_mesh` one) runs every path data-parallel, as in
`MultiLayerNetwork.fit`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.data.async_iterator import (
    fit_prefetch_enabled, prefetch_to_device,
)
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.pipeline import restore_view_batches
from deeplearning4j_tpu_torch.data.normalization import engaged_device_affine
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, preprocess_forward, preprocessed_type,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertexConf
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn import step_graph
from deeplearning4j_tpu_torch.nn.multilayer import (
    TrainableNet, _is_stateful_recurrent, _required_kind, as_input,
    as_labels, as_mask, host_array, layer_call, masked_eval_pair,
    torch_dtype, tree_to, unwrap_frozen, validate_layer_conf,
)
from deeplearning4j_tpu_torch.nn.regularization import (
    apply_weight_noise, constraint_map, has_constraints,
)
from deeplearning4j_tpu_torch.nn.updaters import tree_map
from deeplearning4j_tpu_torch.util import params as param_util
from deeplearning4j_tpu_torch.util.platform import (
    DeviceLike, resolve_device, set_f32_matmul_exact,
)


class ComputationGraph(TrainableNet):
    _LEDGER_PREFIX = "graph"

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
        self._reset_fit_state()
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
        self._rnn_carries: dict = {}

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

    def _label_tree(self):
        return [(name, "v_", self.conf.vertices[name].vertex)
                for name in self.params]

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
                 stash_pre: bool = False, carries: Optional[dict] = None):
        """Run the DAG. Returns (activations by name, new state, new
        carries, masks by name). Each vertex sees the mask propagated along
        its own inputs. With `stash_pre`, the input of each output vertex
        is kept under ``"__pre__" + name`` for its score, and an output
        vertex that no other vertex reads is not run. With `carries` (a
        dict by vertex name; {} is the zero state), the recurrent vertices
        run `apply_seq` from their carry (rnn_time_step, tbptt)."""
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
        new_carries = {}
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
            remat = train and self.conf.gradient_checkpointing
            if carries is not None and _is_stateful_recurrent(vd.vertex):
                acts[name], new_carries[name] = layer_call(
                    vd.vertex, layer_params, None, x, train=train, mask=m,
                    generator=generator, remat=remat, seq=True,
                    carry=carries.get(name))
                new_state[name] = state.get(name, {})
            else:
                acts[name], new_state[name] = layer_call(
                    vd.vertex, layer_params, state.get(name, {}), x,
                    train=train, mask=m, generator=generator, remat=remat)
            masks[name] = (in_masks[0]
                           if self._vertex_types[name].kind == Kind.RNN
                           else None)
        return acts, new_state, new_carries, masks

    def _as_inputs(self, features) -> tuple:
        return tuple(as_input(f, self.device, self._compute_dtype)
                     for f in features)

    def _stage_inputs(self, features) -> tuple:
        return tuple(self._stage_x(f) for f in features)

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
            acts, _, _, _ = self._forward(self.params, self.state,
                                          self._as_inputs(inputs), False)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs, train: bool = False):
        """Every vertex's activation, by name (DL4J feedForward)."""
        with torch.no_grad():
            acts, _, _, _ = self._forward(self.params, self.state,
                                          self._as_inputs(inputs), train)
        return acts

    # ------------------------------------------------------------------ fit
    def _score_fn(self, params, state, inputs, labels, fmasks, lmasks,
                  train: bool, generator=None, carries=None):
        """Loss on a batch: every output's score on its `__pre__` features,
        plus the l1/l2 penalty over the layer vertices, in f32 or wider;
        and (new state, new carries)."""
        params_c = self._cast_params(params)
        acts, new_state, new_carries, masks = self._forward(
            params_c, state, inputs, train, generator, fmasks,
            stash_pre=True, carries=carries)
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
        return total, (new_state, new_carries)

    @staticmethod
    def _batch_struct(mds: MultiDataSet) -> tuple:
        tup = lambda t: None if t is None else tuple(t)
        return (tuple(mds.features), tuple(mds.labels),
                tup(mds.features_masks), tup(mds.labels_masks))

    def _grad_struct(self, struct, generator, carries=None):
        """(loss, grads, new state, new carries) of one batch struct;
        under a plan, of this rank's block, scaled by its share."""
        struct, scale = self._plan_local(struct)
        feats, labels, fmasks, lmasks = struct
        loss, grads, (new_state, new_carries) = self._gradients(
            lambda live: self._scaled(self._score_fn(
                live, self.state, self._stage_inputs(feats),
                self._as_labels(labels), self._as_masks(fmasks),
                self._as_masks(lmasks), True, generator, carries), scale))
        return loss, grads, new_state, new_carries

    @staticmethod
    def _loss_mask(struct):
        """The first output's labels mask (the share of a multi-output
        graph's loss is taken from its first output)."""
        lmasks = struct[3]
        return None if lmasks is None else lmasks[0]

    def _tbptt_chunks(self, struct):
        """The batch in chunks of tbptt_fwd_length along the one T that
        every sequence (B, T, F) input shares (ComputationGraph's
        doTruncatedBPTT): sequences of that T, rank >= 3, and (B, T) masks
        are sliced; a rank-2 label is one per example and is not, even
        when its width equals T."""
        feats, labels, fmasks, lmasks = struct
        in_types = [self._vertex_types[n] for n in self.conf.network_inputs]
        lengths = [f.shape[1] for t, f in zip(in_types, feats)
                   if t.kind == Kind.RNN]
        if not lengths:
            raise ValueError("tbptt backprop requires at least one RNN "
                             "(B, T, F) network input")
        if len(set(lengths)) > 1:
            raise ValueError(
                f"tbptt requires all RNN inputs to share one sequence "
                f"length, got {lengths} — chunking cannot be aligned "
                f"across inputs of different T")
        T = lengths[0]

        def cut(arr, t0, t1, is_mask=False):
            if arr is not None and arr.shape[1:2] == (T,) and (
                    arr.ndim >= 3 or (is_mask and arr.ndim == 2)):
                return arr[:, t0:t1]
            return arr

        def cut_all(arrs, t0, t1, is_mask=False):
            return None if arrs is None else tuple(
                cut(a, t0, t1, is_mask) for a in arrs)

        fwd = self.conf.tbptt_fwd_length
        for t0 in range(0, T, fwd):
            t1 = t0 + fwd
            yield (cut_all(feats, t0, t1), cut_all(labels, t0, t1),
                   cut_all(fmasks, t0, t1, True),
                   cut_all(lmasks, t0, t1, True))

    def _id_inputs(self):
        """Features that feed an embedding vertex directly (their flat
        leaf index is the input's position)."""
        inputs = self.conf.network_inputs
        out = []
        for name, vd in self.conf.vertices.items():
            layer = unwrap_frozen(vd.vertex)
            if hasattr(layer, "id_range") and vd.inputs[0] in inputs:
                out.append((inputs.index(vd.inputs[0]), layer,
                            layer.id_range(self.params[name])))
        return out

    def compute_gradient_and_score(self, mds: MultiDataSet, generator=None):
        """DL4J computeGradientAndScore on one batch, in training mode:
        (score tensor, gradient tree shaped like `params`, new vertex
        state). Gradients are taken with respect to the parameters as
        stored (f32 master weights under bf16 compute)."""
        return self._grad_struct(self._batch_struct(mds), generator)[:3]

    def _train_step(self, mds: MultiDataSet, generator) -> torch.Tensor:
        """One optimizer step: forward and backward, the updater chain,
        the in-place update, the constraints' projection; the new
        optimizer and vertex state are written into the old tensors. The
        loss is returned on the device; the caller fetches it."""
        return self._step_struct(self._batch_struct(mds), generator)

    def fit(self, data, epochs: int = 1, scan_steps: Optional[int] = None,
            accumulate_steps: int = 1, plan=None):
        """Train (ComputationGraph.fit) on a MultiDataSet, a DataSet, a
        (features, labels) pair of arrays, or an iterable of these, with
        the reference's signature; the paths and options are
        `MultiLayerNetwork.fit`'s. As in the reference the graph's
        prefetch follows DL4J_CUDA_FIT_PREFETCH / DL4J_CUDA_PREFETCH_DEPTH
        (default on); unlike the reference, its scan and accumulate paths
        prefetch too (the worker's device copies feed the captured
        step's static buffers device to device)."""
        if self.params is None:
            self.init()
        scan_steps, plan = self._fit_modes(scan_steps, accumulate_steps,
                                           plan)
        with engaged_device_affine(data, self.listeners) as aff:
            self._set_input_affine(aff)
            copy_marked = self._own_held_batches(
                data, self.device, self._prefetches(data), scan_steps,
                accumulate_steps)
            try:
                self._engage_plan(plan)
                self._run_epochs(
                    epochs, lambda: self._mds_stream(data), scan_steps,
                    accumulate_steps, 331,
                    getattr(data, "reset", lambda: None))
            finally:
                self._engage_plan(None)
                self._input_affine = None
                restore_view_batches(copy_marked)
        return self

    @staticmethod
    def _prefetches(data) -> bool:
        return fit_prefetch_enabled() \
            and getattr(data, "async_supported", True) is not False

    def _mds_stream(self, data):
        """One epoch's MultiDataSets, staged onto the device by a prefetch
        thread (ids range-checked there first), unless prefetch is off or
        the source is not async_supported."""
        if not self._prefetches(data):
            return self._iter_data(data)
        return prefetch_to_device(
            self._iter_data(data), self.device,
            lambda mds: step_graph.flatten(self._batch_struct(mds)),
            lambda mds, arrays: MultiDataSet(*step_graph.unflatten(
                self._batch_struct(mds), arrays)),
            self._check_ids)

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

    def _evaluate_with(self, ev, data, batch_size: int = 32):
        """Feed an eval accumulator from the first output, chunked by
        batch_size, mask-padded entries excluded."""
        for mds in self._iter_data(data):
            labels = host_array(mds.labels[0])
            lm = None if mds.labels_masks is None else mds.labels_masks[0]
            for i in range(0, labels.shape[0], batch_size):
                out = self.output(*(f[i:i + batch_size]
                                    for f in mds.features))
                out = out[0] if isinstance(out, (tuple, list)) else out
                ev.eval(*masked_eval_pair(
                    labels[i:i + batch_size], host_array(out),
                    None if lm is None else lm[i:i + batch_size]))
        if hasattr(data, "reset"):
            data.reset()
        return ev

    # ------------------------------------------------------ recurrent state
    def rnn_time_step(self, *inputs):
        """Stateful streaming inference over the DAG (ComputationGraph
        rnnTimeStep): each sequence input is (B, F) for one step or (B, T,
        F) for several; the recurrent vertices' state persists across
        calls until `rnn_clear_previous_state()`. With a one-step input,
        sequence outputs come back as their last step. Runs under
        no_grad."""
        if self.params is None:
            raise RuntimeError("Network is not initialized — call init() "
                               "first")
        in_types = [self._vertex_types[n] for n in self.conf.network_inputs]
        singles, prep = [], []
        for t, x in zip(in_types, self._as_inputs(inputs)):
            single = t.kind == Kind.RNN and x.ndim == 2
            singles.append(single)
            prep.append(x[:, None, :] if single else x)
        with torch.no_grad():
            acts, _, self._rnn_carries, _ = self._forward(
                self.params, self.state, tuple(prep), False,
                carries=self._rnn_carries)
        outs = []
        for o in self.conf.network_outputs:
            y = acts[o]
            outs.append(y[:, -1, :] if any(singles) and y.ndim == 3 else y)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def rnn_clear_previous_state(self):
        self._rnn_carries = {}

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
        self._drop_graphs()

    def copy(self) -> "ComputationGraph":
        """A graph of the same configuration on the same device, with
        copies of the parameters and vertex state and a fresh optimizer
        (MultiLayerNetwork.copy for graphs)."""
        clone = ComputationGraph(self.conf, device=self.device)
        if self.params is not None:
            clone._vertex_types = self._vertex_types or self._resolve_types()
            clone._pre_kind = self._pre_kind
            clone.params = tree_map(torch.clone, self.params)
            clone.state = tree_map(torch.clone, self.state)
            clone._build_optimizer()
        return clone

    # --------------------------------------------------------------- memory
    def memory_report(self, batch_size: int = 32, with_compiled: bool = True):
        """Per-vertex analytic memory estimate and, on CUDA, the measured
        peak of one training step (DL4J NetworkMemoryReport analog — see
        util/memory.py)."""
        from deeplearning4j_tpu_torch.util.memory import build_memory_report
        return build_memory_report(self, batch_size, with_compiled)
