"""Recurrent layer family — for now the time-distributed output head.

Counterpart of the JAX package's `nn/layers/recurrent.py`. This slice
ports `RnnOutputLayer`, the head of `TransformerLM`: the same (F_in ->
n_out) projection at every step, then the activation, and its training
score (the loss over unmasked steps). LSTM, GRU and the other recurrent
layers come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.nn.losses import get_loss


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConf):
    """Time-distributed dense + activation (DL4J RnnOutputLayer)."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "softmax"
    loss: str = "mcxent"
    weight_init: str = "xavier"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (n_in, self.n_out), n_in,
                              self.n_out, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def preout(self, params, x, train=False, generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(
            self.preout(params, x, train, generator)), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        """Mean loss of the pre-activations against `labels`, over the
        unmasked steps."""
        z = self.preout(params, x, train, generator)
        return get_loss(self.loss)(labels, z, self.activation, mask=mask)
