"""Feed-forward layer family.

Counterpart of the JAX package's `nn/layers/feedforward.py`, all twelve
classes with the reference's fields and math: DenseLayer,
ElementWiseMultiplicationLayer, EmbeddingLayer, ActivationLayer,
DropoutLayer, OutputLayer, CenterLossOutputLayer, LossLayer,
AutoEncoder, RepeatVector, PermuteLayer and ReshapeLayer. Weights are
(in, out), applied as ``x @ W``. `init` draws from one CPU
`torch.Generator` in the order the reference splits its key; the values
differ from the reference's for one seed (other random streams).

Under a sharding plan whose rules split ``W``'s output dim over
``model`` (`ShardingRules.megatron()`), DenseLayer, OutputLayer,
CenterLossOutputLayer, AutoEncoder and EmbeddingLayer compute
column-parallel (``TP_GROUPS``; `parallel/tensor.linear`): this rank's
columns and its slice of the bias, gathered whole, since the next layer
reads the whole input and a loss the whole logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.step_graph import check_ids
from deeplearning4j_tpu_torch.parallel import tensor as tp

#: the leaf spec under which a layer of (in, out) kernel ``W`` computes
#: column-parallel (`parallel/tensor.py`)
COLUMN_W = ({"W": (None, tp.MODEL)},)


def _dense_init(layer, generator, input_type, dtype, bias_init=0.0):
    n_in = layer.n_in or input_type.features
    w_init = get_initializer(layer.weight_init)
    params = {"W": w_init(generator, (n_in, layer.n_out), n_in, layer.n_out,
                          dtype)}
    if layer.has_bias:
        params["b"] = torch.full((layer.n_out,), float(bias_init),
                                 dtype=dtype)
    return params


def _affine(layer, params, x, train, generator):
    x = layer.maybe_dropout_input(x, train, generator)
    return tp.linear(x, params["W"], params["b"] if layer.has_bias else None,
                     layer.n_out, layer)


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(LayerConf):
    TP_GROUPS = COLUMN_W
    n_out: int = 0
    n_in: Optional[int] = None          # inferred from input when None
    activation: str = "identity"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        return _dense_init(self, generator, input_type, dtype,
                           self.bias_init), {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(
            _affine(self, params, x, train, generator)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ElementWiseMultiplicationLayer(LayerConf):
    """out = activation(x * w + b) with a learnable per-feature w and b
    (DL4J ElementWiseMultiplicationLayer); input and output sizes equal."""
    n_out: int = 0                      # == n_in; inferred when 0
    n_in: Optional[int] = None
    activation: str = "identity"
    weight_init: str = "xavier"
    bias_init: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        n = self.n_out or input_type.features
        if self.n_in and self.n_in != n:
            raise ValueError("ElementWiseMultiplicationLayer requires "
                             f"n_in == n_out, got {self.n_in} vs {n}")
        return InputType.feed_forward(n)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n = self.n_out or input_type.features
        if input_type.features != n:
            raise ValueError("ElementWiseMultiplicationLayer requires "
                             f"n_in == n_out, got {input_type.features} "
                             f"vs {n}")
        w_init = get_initializer(self.weight_init)
        return {"W": w_init(generator, (n,), n, n, dtype),
                "b": torch.full((n,), float(self.bias_init),
                                dtype=dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        return get_activation(self.activation)(
            x * params["W"] + params["b"]), state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(LayerConf):
    """Index -> embedding row (DL4J EmbeddingLayer). Input: (B,) or (B, 1)
    integer ids (floats are truncated). Ids outside [0, n_in) raise, as
    the port's EmbeddingSequenceLayer does: on CUDA such an index trips a
    device-side assert."""
    TP_GROUPS = COLUMN_W
    n_out: int = 0
    n_in: Optional[int] = None          # vocab size
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (n_in, self.n_out), n_in,
                              self.n_out, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def id_range(self, params):
        """(vocabulary size, the ValueError message of an id outside)."""
        vocab = params["W"].shape[0]
        return vocab, f"EmbeddingLayer: ids outside [0, {vocab})"

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        idx = x.to(torch.int64)
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        check_ids(self, idx, *self.id_range(params))
        w = params["W"]
        y = w[idx]
        b = params["b"] if self.has_bias else None
        if w.shape[1] != self.n_out:        # this rank's columns
            mg = tp.require(self)
            if b is not None:
                y = y + tp.model_slice(b, mg)
            y = tp.gather_from_model(y, mg)
        elif b is not None:
            y = y + b
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(LayerConf):
    """Standalone activation (DL4J ActivationLayer); `alpha` parameterizes
    the leaky/elu-style activations."""
    activation: str = "relu"
    alpha: Optional[float] = None

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        fn = get_activation(self.activation)
        if self.alpha is not None:
            return fn(x, self.alpha), state
        return fn(x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(LayerConf):
    """Standalone dropout (DL4J DropoutLayer): inverted scaling in
    training, the identity in inference."""
    dropout: float = 0.5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return self.maybe_dropout_input(x, train, generator), state


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(LayerConf):
    """Dense + loss head (DL4J OutputLayer): `apply` gives the
    post-activation predictions; `score` the loss on the pre-activations."""
    TP_GROUPS = COLUMN_W
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "softmax"
    loss: str = "mcxent"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        return _dense_init(self, generator, input_type, dtype,
                           self.bias_init), {}

    def preout(self, params, x, train=False, generator=None):
        return _affine(self, params, x, train, generator)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(
            self.preout(params, x, train, generator)), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        z = self.preout(params, x, train, generator)
        return get_loss(self.loss)(labels, z, self.activation, mask=mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(LayerConf):
    """Softmax head + center loss (DL4J CenterLossOutputLayer): loss =
    primary + lambda/2 * ||f - c_y||^2. As in the reference, the centers
    `cL` are ordinary parameters moved by the gradient."""
    TP_GROUPS = COLUMN_W
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "softmax"
    loss: str = "mcxent"
    alpha: float = 0.05             # kept for config parity
    lambda_: float = 2e-4
    weight_init: str = "xavier"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        params = _dense_init(self, generator, input_type, dtype,
                             self.bias_init)
        params["cL"] = torch.zeros((self.n_out, n_in), dtype=dtype)
        return params, {}

    def preout(self, params, x, train=False, generator=None):
        return _affine(self, params, x, train, generator)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(
            self.preout(params, x, train, generator)), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        z = self.preout(params, x, train, generator)
        primary = get_loss(self.loss)(labels, z, self.activation, mask=mask)
        c_y = labels.to(params["cL"].dtype) @ params["cL"]
        center = 0.5 * self.lambda_ * ((x - c_y) ** 2).sum(-1).mean()
        return primary + center


@register_layer
@dataclasses.dataclass(frozen=True)
class LossLayer(LayerConf):
    """Parameter-free loss head (DL4J LossLayer)."""
    activation: str = "identity"
    loss: str = "mse"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(x), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        return get_loss(self.loss)(labels, x, self.activation, mask=mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class AutoEncoder(LayerConf):
    """Denoising autoencoder (DL4J AutoEncoder). As a stacked layer it is
    the encoder; `pretrain_score` corrupts the input, encodes, decodes
    with the tied weight Wᵀ and scores the reconstruction."""
    TP_GROUPS = COLUMN_W
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "sigmoid"
    loss: str = "mse"
    corruption_level: float = 0.3
    weight_init: str = "xavier"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        w_init = get_initializer(self.weight_init)
        return {"W": w_init(generator, (n_in, self.n_out), n_in, self.n_out,
                            dtype),
                "b": torch.zeros((self.n_out,), dtype=dtype),
                "vb": torch.zeros((n_in,), dtype=dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        act = get_activation(self.activation)
        return act(tp.linear(x, params["W"], params["b"], self.n_out,
                             self)), state

    def pretrain_score(self, params, x, generator=None):
        act = get_activation(self.activation)
        x_in = x
        if self.corruption_level > 0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - self.corruption_level
            x_in = torch.where(keep, x, torch.zeros_like(x))
        h = act(x_in @ params["W"] + params["b"])
        recon_pre = h @ params["W"].T + params["vb"]
        return get_loss(self.loss)(x, recon_pre, self.activation)


@register_layer
@dataclasses.dataclass(frozen=True)
class RepeatVector(LayerConf):
    """Repeat a (B, C) vector n times into a (B, n, C) sequence."""
    n: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType(Kind.RNN, (int(self.n), input_type.shape[0]))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return x[:, None, :].expand(-1, int(self.n), -1), state


@register_layer
@dataclasses.dataclass(frozen=True)
class PermuteLayer(LayerConf):
    """Permute the non-batch axes; `dims` is 1-indexed, as Keras' Permute."""
    dims: Tuple[int, ...] = (1,)

    def output_type(self, input_type: InputType) -> InputType:
        shape = tuple(input_type.shape[d - 1] for d in self.dims)
        if len(shape) == len(input_type.shape):
            return InputType(input_type.kind, shape)
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return x.permute((0,) + tuple(int(d) for d in self.dims)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ReshapeLayer(LayerConf):
    """Reshape the non-batch axes; the kind follows the target's rank (1 ->
    FF, 2 -> (T, C), 3 -> (H, W, C)); one dim may be -1."""
    target: Tuple[int, ...] = ()

    def _resolve(self, in_shape) -> Tuple[int, ...]:
        total = math.prod(int(d) for d in in_shape)
        tgt = [int(d) for d in self.target]
        if tgt.count(-1) > 1:
            raise ValueError(f"Reshape: at most one -1 in {self.target}")
        if -1 in tgt:
            rest = math.prod(d for d in tgt if d != -1)
            if rest <= 0 or total % rest:
                raise ValueError(f"Reshape: cannot infer -1 reshaping "
                                 f"{tuple(in_shape)} into {self.target}")
            tgt[tgt.index(-1)] = total // rest
        if math.prod(tgt) != total:
            raise ValueError(f"Reshape: cannot reshape {tuple(in_shape)} "
                             f"(size {total}) into {self.target}")
        return tuple(tgt)

    def output_type(self, input_type: InputType) -> InputType:
        shape = self._resolve(input_type.shape)
        kind = {1: Kind.FF, 2: Kind.RNN, 3: Kind.CNN}.get(len(shape))
        if kind is None:
            raise ValueError(f"Reshape: unsupported rank {len(shape)}")
        return InputType(kind, shape)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return x.reshape((x.shape[0],) + self._resolve(x.shape[1:])), state
