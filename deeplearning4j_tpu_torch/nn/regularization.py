"""Dropout variants, weight noise, and parameter constraints.

Counterpart of the JAX package's `nn/regularization.py`, with the same
config classes (so a `configuration.json` names them the same way) and
the same math:

- a LayerConf's `dropout` field takes a float (plain inverted dropout) or
  one of the IDropout objects below, applied to the layer's input in
  training (`LayerConf.maybe_dropout_input`);
- `weight_noise` transforms the layer's parameters inside the training
  forward (DL4J `getParamWithNoise`);
- `constraints` are projected onto the parameters right after the
  optimizer update, in the same train step (`apply_constraints`).

Noise is drawn from an explicit `torch.Generator` that lies on the
tensor's device. The JAX and torch random streams differ, so the tests
hold the noise to the reference by its distribution and its masks'
expectations, never element by element.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.base import dropout as plain_dropout
from deeplearning4j_tpu_torch.nn.conf.base import (
    normal, register_layer, uniform,
)


def _bernoulli(keep: float, shape, like: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """A boolean mask, True with probability `keep`, on `like`'s device."""
    return uniform(shape, generator, like.device) < keep


def _normal(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise shaped and typed like `like` (drawn in f32)."""
    return normal(like.shape, generator, like.device).to(like.dtype)


# ------------------------------------------------------------ dropout family
@dataclasses.dataclass(frozen=True)
class IDropout:
    """Base input-dropout schedule; subclasses implement apply()."""

    def apply(self, x, generator: torch.Generator):
        raise NotImplementedError


@register_layer
@dataclasses.dataclass(frozen=True)
class Dropout(IDropout):
    """Standard inverted dropout (DL4J nn/conf/dropout/Dropout.java); `p`
    is the drop probability."""
    p: float = 0.5

    def apply(self, x, generator):
        return plain_dropout(x, self.p, generator)


@register_layer
@dataclasses.dataclass(frozen=True)
class AlphaDropout(IDropout):
    """SELU-preserving dropout (DL4J AlphaDropout.java): dropped units take
    alpha' and the result is affinely corrected to keep zero mean and unit
    variance."""
    p: float = 0.05

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def apply(self, x, generator):
        keep = 1.0 - self.p
        alpha_p = -self._ALPHA * self._SCALE
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        kept = _bernoulli(keep, x.shape, x, generator)
        return a * torch.where(kept, x, torch.full_like(x, alpha_p)) + b


@register_layer
@dataclasses.dataclass(frozen=True)
class GaussianDropout(IDropout):
    """Multiplicative Gaussian noise N(1, rate / (1 - rate)) (DL4J
    GaussianDropout.java)."""
    rate: float = 0.1

    def apply(self, x, generator):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * _normal(x, generator))


@register_layer
@dataclasses.dataclass(frozen=True)
class GaussianNoise(IDropout):
    """Additive Gaussian noise (DL4J GaussianNoise.java)."""
    stddev: float = 0.1

    def apply(self, x, generator):
        return x + self.stddev * _normal(x, generator)


@register_layer
@dataclasses.dataclass(frozen=True)
class SpatialDropout(IDropout):
    """Channel-wise dropout (DL4J SpatialDropout.java): one draw per
    (example, channel), broadcast over the spatial or time axes; the
    channel axis is last (NHWC, (B, T, C))."""
    p: float = 0.5

    def apply(self, x, generator):
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        kept = _bernoulli(keep, shape, x, generator)
        return torch.where(kept, x / keep, torch.zeros_like(x))


def apply_input_dropout(dropout, x, train: bool, generator):
    """Dispatch for LayerConf.dropout: a float (the drop probability) or an
    IDropout object."""
    if not train or generator is None or dropout is None:
        return x
    if isinstance(dropout, IDropout):
        return dropout.apply(x, generator)
    if not isinstance(dropout, (int, float)):
        raise TypeError(f"dropout must be a float or an IDropout, got "
                        f"{type(dropout).__name__}")
    return plain_dropout(x, float(dropout), generator)


# -------------------------------------------------------- weight noise family
@dataclasses.dataclass(frozen=True)
class IWeightNoise:
    apply_to_bias: bool = False

    def transform(self, params: dict, generator: torch.Generator) -> dict:
        """A transformed copy of the layer's params for this forward (DL4J
        BaseLayer.getParamWithNoise), leaves in sorted-name order."""
        out = {}
        for k, v in sorted(params.items()):
            if k.startswith("b") and not self.apply_to_bias:
                out[k] = v
            else:
                out[k] = self._transform_one(v, generator)
        return out

    def _transform_one(self, w, generator):
        raise NotImplementedError


@register_layer
@dataclasses.dataclass(frozen=True)
class DropConnect(IWeightNoise):
    """Randomly zero weights in training (DL4J DropConnect.java); inverted
    scaling keeps the expectation. `p` is the drop probability."""
    p: float = 0.5

    def _transform_one(self, w, generator):
        return plain_dropout(w, self.p, generator)


@register_layer
@dataclasses.dataclass(frozen=True)
class WeightNoise(IWeightNoise):
    """Additive or multiplicative Gaussian weight noise (DL4J
    WeightNoise.java)."""
    stddev: float = 0.05
    additive: bool = True

    def _transform_one(self, w, generator):
        noise = _normal(w, generator) * self.stddev
        return w + noise if self.additive else w * (1.0 + noise)


def apply_weight_noise(layer, params: dict, train: bool, generator) -> dict:
    """Network-forward hook: a layer's params with its weight noise, in
    training with a generator; the params as they are otherwise."""
    noise = getattr(layer, "weight_noise", None)
    if not train or generator is None or noise is None:
        return params
    if not isinstance(noise, IWeightNoise):
        raise TypeError(f"weight_noise must be an IWeightNoise (DropConnect, "
                        f"WeightNoise), got {type(noise).__name__}")
    return noise.transform(params, generator)


# ---------------------------------------------------------- constraint family
@dataclasses.dataclass(frozen=True)
class BaseConstraint:
    """Projection applied to weights right after the optimizer update
    (DL4J BaseConstraint.applyConstraint). `apply_to_bias` is DL4J's
    constrainBias."""
    apply_to_bias: bool = False

    def project(self, w):
        raise NotImplementedError

    @staticmethod
    def _norms(w):
        """The L2 norm per output unit: over every axis but the last (the
        fan-in and spatial axes of an HWIO kernel)."""
        axes = tuple(range(w.ndim - 1)) or (0,)
        return torch.sqrt((w * w).sum(dim=axes, keepdim=True))


@register_layer
@dataclasses.dataclass(frozen=True)
class MaxNormConstraint(BaseConstraint):
    """Clip each output unit's weight-vector norm to max_norm."""
    max_norm: float = 2.0

    def project(self, w):
        scale = torch.clamp(self.max_norm / torch.clamp(self._norms(w),
                                                        min=1e-12), max=1.0)
        return w * scale


@register_layer
@dataclasses.dataclass(frozen=True)
class MinMaxNormConstraint(BaseConstraint):
    """Force norms into [min_norm, max_norm], interpolated by rate."""
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def project(self, w):
        norms = self._norms(w)
        clipped = torch.clamp(norms, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * norms
        return w * target / torch.clamp(norms, min=1e-12)


@register_layer
@dataclasses.dataclass(frozen=True)
class NonNegativeConstraint(BaseConstraint):
    """Project weights onto the non-negative orthant."""

    def project(self, w):
        return torch.clamp(w, min=0.0)


@register_layer
@dataclasses.dataclass(frozen=True)
class UnitNormConstraint(BaseConstraint):
    """Rescale each output unit's weight vector to unit norm."""

    def project(self, w):
        return w / torch.clamp(self._norms(w), min=1e-12)


def apply_constraints(layer_map: dict, params: dict):
    """Post-update projection for every constrained layer, in place on the
    port's master weights. `layer_map` is {param-dict key: LayerConf}.
    Call under torch.no_grad()."""
    for key, layer in layer_map.items():
        cons: Tuple = getattr(layer, "constraints", ()) or ()
        if not cons or key not in params:
            continue
        for pname, w in params[key].items():
            if not isinstance(w, torch.Tensor):
                continue
            for c in cons:
                if pname.startswith("b") and not c.apply_to_bias:
                    continue
                w.copy_(c.project(w))


def has_constraints(layers) -> bool:
    return any(getattr(l, "constraints", ()) for l in layers)


def constraint_map(model) -> dict:
    """{param-dict key: LayerConf} for `apply_constraints`, for either
    container: vertex names for a graph, layer indices as strings for a
    MultiLayerNetwork."""
    from deeplearning4j_tpu_torch.nn.conf.base import LayerConf
    vertices = getattr(model.conf, "vertices", None)
    if vertices is not None:
        return {name: vd.vertex for name, vd in vertices.items()
                if isinstance(vd.vertex, LayerConf)}
    return {str(i): l for i, l in enumerate(model.layers)}
