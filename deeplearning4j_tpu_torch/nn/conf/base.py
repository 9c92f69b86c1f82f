"""Layer-configuration base machinery.

Counterpart of the JAX package's `nn/conf/base.py`. A layer config is a
frozen dataclass that also carries the math: `init` makes a dict of
tensors, `apply` is the forward on tensors. The `{"@class": name, ...}`
serde, the `InputType` shape inference and the preprocessors are the same
as the reference's, so a `configuration.json` written by either package
loads in the other.

Layouts are the reference's: RNN activations are (batch, time, features),
CNN activations NHWC, and weights (in, out) applied as ``x @ W``.
"""
from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Dict, Optional, Tuple

import torch


# ----------------------------------------------------------------- InputType
class Kind(str, enum.Enum):
    FF = "ff"          # (features,)
    CNN = "cnn"        # (height, width, channels) NHWC
    CNN1D = "cnn1d"    # (time, channels)
    RNN = "rnn"        # (time, features)


@dataclasses.dataclass(frozen=True)
class InputType:
    """Shape metadata for one activation tensor, batch dim excluded."""
    kind: Kind
    shape: Tuple[int, ...]

    @staticmethod
    def feed_forward(n: int) -> "InputType":
        return InputType(Kind.FF, (int(n),))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(Kind.CNN, (int(height), int(width), int(channels)))

    @staticmethod
    def recurrent(features: int, timesteps: int) -> "InputType":
        return InputType(Kind.RNN, (int(timesteps), int(features)))

    @property
    def features(self) -> int:
        if self.kind == Kind.FF:
            return self.shape[0]
        if self.kind in (Kind.RNN, Kind.CNN1D):
            return self.shape[1]
        return self.shape[2]

    @property
    def flat_size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def to_dict(self):
        return {"kind": self.kind.value, "shape": list(self.shape)}

    @staticmethod
    def from_dict(d):
        return InputType(Kind(d["kind"]), tuple(d["shape"]))


# ------------------------------------------------------------- serde registry
_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: register a LayerConf subclass for polymorphic serde."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def _encode_value(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        d = {"@class": type(v).__name__}
        for f in dataclasses.fields(v):
            d[f.name] = _encode_value(getattr(v, f.name))
        return d
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def layer_to_dict(layer) -> dict:
    return _encode_value(layer)


def _decode_fields(cls, d: dict):
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict) and "@class" in v:
            v = layer_from_dict(v)
        elif isinstance(v, list):
            v = tuple(layer_from_dict(x) if isinstance(x, dict) and "@class" in x
                      else x for x in v)
            if typing.get_origin(hints.get(f.name)) is list:
                v = list(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def layer_from_dict(d: dict):
    name = d.get("@class")
    if name is None:
        raise ValueError(f"Missing @class in layer dict: {list(d)[:8]}")
    cls = _LAYER_REGISTRY.get(name) or _AUX_REGISTRY.get(name)
    if cls is None:
        # registration happens when a layer module is imported; a
        # standalone load_model() may deserialize before that
        import deeplearning4j_tpu_torch.nn.layers  # noqa: F401
        import deeplearning4j_tpu_torch.nn.conf.graph_vertices  # noqa: F401
        import deeplearning4j_tpu_torch.nn.regularization  # noqa: F401
        cls = _LAYER_REGISTRY.get(name) or _AUX_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"Unknown layer/config class '{name}' (not ported "
                         "to deeplearning4j_tpu_torch yet)")
    return _decode_fields(cls, d)


# updaters & schedules participate in the same serde
_AUX_REGISTRY: Dict[str, type] = {}


def _register_aux_dataclasses():
    from deeplearning4j_tpu_torch.nn import updaters as U
    for name in dir(U):
        obj = getattr(U, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            _AUX_REGISTRY[obj.__name__] = obj


_register_aux_dataclasses()


class RandomTape:
    """Stands in for a torch.Generator inside a gradient-checkpointed
    layer: the forward draws from `generator` and records each draw, and
    the recompute in the backward replays them in order, so both passes
    use one set of masks (the reference passes its rng key into
    jax.checkpoint for the same reason). torch.utils.checkpoint restores
    only the default generators, and its own restore is not used."""

    def __init__(self, generator):
        self.generator = generator
        self._draws = []
        self._pos = None            # None: recording; else the replay index
        self._recorded = False

    def begin(self):
        self._pos = 0 if self._recorded else None

    def end(self):
        self._recorded = True

    def draw(self, fn, shape, device):
        if self._pos is None:
            t = fn(shape, generator=self.generator, device=device)
            self._draws.append(t)
            return t
        t = self._draws[self._pos]
        self._pos += 1
        return t


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) draws in f32 from `generator` (a torch.Generator or a
    RandomTape); every random draw of a training forward goes through
    here or `normal`."""
    if isinstance(generator, RandomTape):
        return generator.draw(torch.rand, shape, device)
    return torch.rand(shape, generator=generator, device=device)


def normal(shape, generator, device) -> torch.Tensor:
    """Standard normal draws in f32, as `uniform`."""
    if isinstance(generator, RandomTape):
        return generator.draw(torch.randn, shape, device)
    return torch.randn(shape, generator=generator, device=device)


def dropout(x, rate: float, generator: torch.Generator):
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from `generator` (on x's
    device)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = uniform(x.shape, generator, x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------- LayerConf
@dataclasses.dataclass(frozen=True)
class LayerConf:
    """Base class for all layer configurations.

    Subclasses implement:
      output_type(input_type)                  shape inference
      init(generator, input_type, dtype)       -> (params, state) dicts of
                                                  CPU tensors
      apply(params, state, x, *, train, mask)  -> (y, new_state) forward

    The fields are the reference's, so configs serialize to the same JSON.
    Training reads `dropout` (a float probability or an IDropout object),
    `weight_noise`, `constraints` (`nn/regularization.py`) and l1/l2; a
    per-layer `updater` and `frozen` (the NoOp updater) label the
    layer's parameters for the containers' multi_transform.
    """
    name: Optional[str] = None
    dropout: Any = 0.0
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Any] = None
    frozen: bool = False
    weight_noise: Optional[Any] = None
    constraints: Tuple[Any, ...] = ()

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def init(self, generator: torch.Generator, input_type: InputType,
             dtype: torch.dtype = torch.float32):
        """Returns (params, state); both possibly empty dicts."""
        return {}, {}

    def apply(self, params, state, x, *, train: bool = False, mask=None):
        """Forward. Returns (output, new_state)."""
        raise NotImplementedError

    def maybe_dropout_input(self, x, train: bool,
                            generator: Optional[torch.Generator]):
        """DL4J applies a layer's `dropout` to the layer *input* in
        training (inverted dropout: kept values scaled by 1/keep), drawn
        from `generator`, which lies on x's device."""
        if not train or generator is None:
            return x
        if isinstance(self.dropout, (int, float)):
            return dropout(x, self.dropout, generator)
        from deeplearning4j_tpu_torch.nn.regularization import (
            apply_input_dropout,
        )
        return apply_input_dropout(self.dropout, x, train, generator)

    def regularization_score(self, params) -> torch.Tensor:
        """L1/L2 penalty (DL4J BaseLayer.calcRegularizationScore): l1 *
        sum|w| + 0.5 * l2 * sum(w^2) over the layer's top-level params
        whose names do not start with "b" (biases), accumulated in f32
        (wider for wider params)."""
        score = torch.zeros((), dtype=torch.float32)
        if self.l1 == 0.0 and self.l2 == 0.0:
            return score
        for k, v in params.items():
            if k.startswith("b"):
                continue
            if isinstance(v, dict):
                raise NotImplementedError(
                    f"{type(self).__name__}.{k}: l1/l2 on a nested "
                    "parameter group is not defined in the reference")
            score = score.to(torch.promote_types(score.dtype, v.dtype))
            if self.l1:
                score = score + self.l1 * v.abs().sum()
            if self.l2:
                score = score + 0.5 * self.l2 * (v * v).sum()
        return score

    def has_params(self) -> bool:
        return True


# ------------------------------------------------------------ preprocessors
def preprocess_forward(from_type: InputType, to_kind: Kind, x):
    """Reshape activations between layer kinds (the reference's
    reshape-style preprocessors)."""
    if from_type.kind == to_kind:
        return x
    b = x.shape[0]
    if to_kind == Kind.FF:
        return x.reshape(b, -1)
    if from_type.kind == Kind.FF and to_kind == Kind.CNN:
        raise ValueError("FF->CNN preprocessing requires explicit target shape; "
                         "use a ReshapeVertex / specify InputType.convolutional")
    if from_type.kind == Kind.CNN and to_kind == Kind.RNN:
        h, w, c = from_type.shape
        return x.reshape(b, h * w, c)
    if from_type.kind == Kind.RNN and to_kind == Kind.CNN1D:
        return x
    if from_type.kind == Kind.CNN1D and to_kind == Kind.RNN:
        return x
    raise ValueError(f"No preprocessor from {from_type.kind} to {to_kind}")


def preprocessed_type(from_type: InputType, to_kind: Kind) -> InputType:
    if from_type.kind == to_kind:
        return from_type
    if to_kind == Kind.FF:
        return InputType(Kind.FF, (from_type.flat_size,))
    if from_type.kind == Kind.CNN and to_kind == Kind.RNN:
        h, w, c = from_type.shape
        return InputType(Kind.RNN, (h * w, c))
    if from_type.kind in (Kind.RNN, Kind.CNN1D) and to_kind in (Kind.RNN, Kind.CNN1D):
        return InputType(to_kind, from_type.shape)
    raise ValueError(f"No preprocessor from {from_type.kind} to {to_kind}")
