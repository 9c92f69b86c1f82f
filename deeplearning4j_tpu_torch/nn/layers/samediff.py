"""User-defined layers and the freezing wrapper.

Counterpart of the JAX package's `nn/layers/samediff.py`:
- SameDiffLayer (DL4J nn/layers/samediff/SameDiffLayer.java): a custom
  layer from plain PyTorch functions; autograd is its backward.
- FrozenLayerWrapper (DL4J nn/layers/FrozenLayer.java): wraps any layer,
  runs it in inference mode on detached parameters (the reference's
  `lax.stop_gradient`), and the containers give its parameters the NoOp
  updater, so transfer learning can freeze a feature extractor. A frozen
  recurrent layer keeps its stateful entry points (`apply_seq`,
  `rnn_step`), so tbptt and `rnn_time_step` still carry its state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.updaters import tree_map


@register_layer
@dataclasses.dataclass(frozen=True)
class SameDiffLayer(LayerConf):
    """Custom layer from user-supplied functions:

    define_params(generator, input_type, dtype) -> params dict
    forward(params, x, train) -> y
    out_type(input_type) -> InputType

    It serializes only if the callables are module-level and registered
    again on load, as a DL4J custom layer needs its class on the
    classpath."""
    define_params: Optional[Callable] = None
    forward: Optional[Callable] = None
    out_type: Optional[Callable] = None

    def output_type(self, input_type: InputType) -> InputType:
        if self.out_type is not None:
            return self.out_type(input_type)
        return input_type

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        if self.define_params is None:
            return {}, {}
        return self.define_params(generator, input_type, dtype), {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return self.forward(params, x, train), state


def _detached(params):
    return tree_map(lambda t: t.detach(), params)


@register_layer
@dataclasses.dataclass(frozen=True)
class FrozenLayerWrapper(LayerConf):
    """Frozen layer (DL4J FrozenLayer): its parameters get no gradient and
    the NoOp updater; the wrapped layer runs with train=False."""
    layer: Optional[LayerConf] = None

    def output_type(self, input_type: InputType) -> InputType:
        return self.layer.output_type(input_type)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        return self.layer.init(generator, input_type, dtype)

    def has_params(self):
        return self.layer.has_params()

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return self.layer.apply(_detached(params), state, x, train=False,
                                mask=mask, generator=generator)

    def apply_seq(self, params, x, carry, *, train=False, mask=None,
                  generator=None):
        return self.layer.apply_seq(_detached(params), x, carry, train=False,
                                    mask=mask, generator=generator)

    def rnn_step(self, params, x_t, carry):
        return self.layer.rnn_step(_detached(params), x_t, carry)

    def __getattr__(self, name):
        # the rest of the layer contract (score of an output layer, n_out,
        # id_range, ...) comes from the wrapped layer, so a frozen layer
        # stays a drop-in for it
        if name.startswith("__") or name == "layer":
            raise AttributeError(name)
        inner = object.__getattribute__(self, "layer")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)
