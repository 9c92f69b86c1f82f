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

Not yet ported, each raising NotImplementedError that names its slice:
the scan, accumulate and tbptt fit paths, sharding plans, the prefetching
wrapper, per-layer updaters and frozen layers, gradient checkpointing and
`evaluate`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator, DataSetIterator, ExistingDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, preprocess_forward, preprocessed_type,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.regularization import (
    apply_constraints, apply_weight_noise, constraint_map, has_constraints,
)
from deeplearning4j_tpu_torch.nn.updaters import (
    apply_updates, build_optimizer, tree_leaves, tree_map,
)
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


def _required_kind(layer: LayerConf) -> Optional[Kind]:
    return _KIND_BY_CLASS.get(type(layer).__name__)


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
    """Features -> a tensor on `device`; floats in the compute dtype,
    integer ids stay integer."""
    x = _tensor(x)
    if x.is_floating_point():
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


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(f"{what} comes with the {slice_name} slice of "
                               "the PyTorch port")


class MultiLayerNetwork:
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
        self._tx = None
        self._param_dtype = torch_dtype(conf.dtype)
        self._compute_dtype = torch_dtype(conf.compute_dtype or conf.dtype)
        self._input_types: Optional[List[InputType]] = None
        self._constraints = constraint_map(self) \
            if has_constraints(self.layers) else {}

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

    def _unported_optimizer(self) -> Optional[str]:
        """What of the reference's optimizer set-up the port lacks for
        this config, or None."""
        for i, layer in enumerate(self.layers):
            if layer.frozen or layer.updater is not None:
                return (f"layer {i}: per-layer updaters and frozen layers "
                        "(optax.multi_transform)")
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
            raise _not_ported(self._unported_optimizer(), "optimizer")
        return self._tx.init(self.params)

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
                 fmask=None, upto: Optional[int] = None):
        """Forward through layers [0, upto) (all by default) with the auto
        preprocessors; RNN-kind layers get the features mask. When `upto`
        stops before the head, the activation is preprocessed into the
        head's kind, ready for head.score()."""
        if self._input_types is None:
            self._input_types = self._resolve_types()
        params = self._cast_params(params)
        cur_type = self.conf.input_type
        n = len(self.layers) if upto is None else upto
        new_state = dict(state)
        for i, layer in enumerate(self.layers[:n]):
            need = _required_kind(layer)
            if need is not None and cur_type.kind != need:
                x = preprocess_forward(cur_type, need, x)
                cur_type = preprocessed_type(cur_type, need)
            mask = fmask if cur_type.kind == Kind.RNN else None
            layer_params = apply_weight_noise(layer, params[str(i)], train,
                                              generator)
            x, new_state[str(i)] = layer.apply(
                layer_params, state[str(i)], x, train=train, mask=mask,
                generator=generator)
            cur_type = layer.output_type(cur_type)
        if upto is not None and upto < len(self.layers):
            need = _required_kind(self.layers[upto])
            if need is not None and cur_type.kind != need:
                x = preprocess_forward(cur_type, need, x)
        return x, new_state

    def _score_fn(self, params, state, x, y, fmask, lmask, train: bool,
                  generator=None):
        """Loss on a batch: the head's score plus regularization
        (computeGradientAndScore), in f32 or wider."""
        if not self.layers or not hasattr(self.layers[-1], "score"):
            raise ValueError("Last layer must be an output/loss layer with a "
                             "score() method to compute training loss")
        head_i = len(self.layers) - 1
        params_c = self._cast_params(params)
        feat, new_state = self._forward(params_c, state, x, train, generator,
                                        fmask, upto=head_i)
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
        return loss.to(score_dtype) + reg, new_state

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference (DL4J output()): a tensor on the network's device.
        As in the reference, `train` is accepted and the forward is the
        inference one."""
        if self.params is None:
            raise RuntimeError("Network is not initialized — call init() first")
        with torch.inference_mode():
            y, _ = self._forward(self.params, self.state, self._as_input(x),
                                 False)
        return y

    # ----------------------------------------------------------------- fit
    def compute_gradient_and_score(self, dataset: DataSet,
                                   generator=None):
        """DL4J computeGradientAndScore on one batch, in training mode:
        (score tensor, gradient tree shaped like `params`, new layer
        state). Gradients are taken with respect to the parameters as
        stored (f32 master weights under bf16 compute)."""
        live = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), self.params)
        leaves = [t for t in tree_leaves(live) if t.requires_grad]
        with torch.enable_grad():
            loss, new_state = self._score_fn(
                live, self.state, self._as_input(dataset.features),
                self._as_labels(dataset.labels),
                self._as_mask(dataset.features_mask),
                self._as_mask(dataset.labels_mask), True, generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads) if g is not None}
        grad_tree = tree_map(lambda t: by_leaf[id(t)] if id(t) in by_leaf
                             else torch.zeros_like(t), live)
        new_state = tree_map(lambda t: t.detach(), new_state)
        return loss.detach(), grad_tree, new_state

    def _train_step(self, ds: DataSet, generator) -> torch.Tensor:
        """One optimizer step: forward and backward, the updater chain
        (clipping included), the in-place update. The loss is returned on
        the device; the caller fetches it."""
        loss, grads, new_state = self.compute_gradient_and_score(ds,
                                                                 generator)
        with torch.no_grad():
            updates, self.opt_state = self._tx.update(grads, self.opt_state,
                                                      self.params)
            apply_updates(self.params, updates)
            if self._constraints:
                apply_constraints(self._constraints, self.params)
        self.state = new_state
        return loss

    def _check_trainable(self, scan_steps, prefetch, accumulate_steps, plan):
        if scan_steps is not None and scan_steps > 1:
            raise _not_ported("fit(scan_steps > 1)", "CUDA-graph fit")
        if accumulate_steps > 1:
            raise _not_ported("fit(accumulate_steps > 1)", "CUDA-graph fit")
        if plan is not None:
            raise _not_ported("fit(plan=...)", "parallel")
        if prefetch:
            raise _not_ported("fit(prefetch=True) (AsyncDataSetIterator)",
                              "data")
        if self.conf.backprop_type == "tbptt":
            raise _not_ported("tbptt training", "recurrent")
        if self.conf.gradient_checkpointing:
            raise _not_ported("gradient checkpointing", "CUDA-graph fit")
        if self._tx is None:
            raise _not_ported(self._unported_optimizer(), "optimizer")

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            scan_steps: Optional[int] = None,
            prefetch: Optional[bool] = None,
            accumulate_steps: int = 1,
            plan=None):
        """Train (DL4J fit(DataSetIterator)) on a DataSetIterator, a
        DataSet, or (features, labels) arrays, with the reference's
        signature. Each step: forward and backward, clip, update in place,
        one `float(loss)` fetch, then the listeners' `iteration_done`.
        The reference's scan, accumulate, prefetch and plan options raise
        NotImplementedError here (scan_steps=1 and prefetch=False are the
        plain per-call path and are accepted)."""
        if self.params is None:
            self.init()
        self._check_trainable(scan_steps, prefetch, accumulate_steps, plan)
        iterator = self._as_iterator(data, batch_size)
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch_count)
            self._fit_epoch(iterator)
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
            iterator.reset()
        return self

    def _as_iterator(self, data, batch_size) -> DataSetIterator:
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, DataSet):
            return ExistingDataSetIterator([data])
        if isinstance(data, (tuple, list)) and len(data) == 2:
            return ArrayDataSetIterator(data[0], data[1], batch_size=batch_size)
        raise ValueError(f"Cannot interpret training data: {type(data)}")

    def _fit_epoch(self, iterator):
        # dropout masks: one generator per epoch on the device, seeded as
        # the reference seeds its epoch key (the streams themselves differ)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.conf.seed + 7919 * (self.epoch_count + 1))
        etl_start = time.perf_counter()
        for ds in iterator:
            etl_ms = (time.perf_counter() - etl_start) * 1e3
            loss = self._train_step(ds, generator)
            # the step's loss fetch; the only other host read is the
            # embedding layer's id-range flag at the start of the forward
            self._score = float(loss)
            bs = int(np.shape(ds.features)[0])
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.epoch_count, self._score, etl_ms, bs)
            self.iteration_count += 1
            etl_start = time.perf_counter()

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

    def evaluate(self, data, batch_size: int = 32):
        raise _not_ported("evaluate()", "evaluation")

    def num_params(self) -> int:
        def count(t):
            return sum(count(v) for v in t.values()) if isinstance(t, dict) \
                else t.numel()
        return count(self.params or {})
