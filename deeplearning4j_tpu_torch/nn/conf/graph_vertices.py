"""Graph vertices — the parameter-free DAG combinators.

Counterpart of the JAX package's `nn/conf/graph_vertices.py`: the base
`GraphVertexConf` and its fourteen vertices (Merge, ElementWise, Subset,
Stack, Unstack, Reshape, Scale, Shift, L2Normalize, L2, LastTimeStep,
DuplicateToTimeSeries, ReverseTimeSeries, PoolHelper), with the same
fields, so a graph's `configuration.json` reads the same in both
packages. Each is a frozen dataclass with `output_type(*input_types)` and
`apply(*inputs)` on tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, register_layer,
)


@dataclasses.dataclass(frozen=True)
class GraphVertexConf:
    def output_type(self, *input_types: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, *inputs):
        raise NotImplementedError

    def has_params(self) -> bool:
        return False


@register_layer
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertexConf):
    """Concatenate along the feature axis (DL4J MergeVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        k = input_types[0].kind
        if k == Kind.FF:
            return InputType.feed_forward(sum(t.shape[0] for t in input_types))
        if k == Kind.RNN:
            return InputType(Kind.RNN, (input_types[0].shape[0],
                                        sum(t.shape[1] for t in input_types)))
        if k == Kind.CNN:
            h, w, _ = input_types[0].shape
            return InputType.convolutional(
                h, w, sum(t.shape[2] for t in input_types))
        raise ValueError(k)

    def apply(self, *inputs):
        return torch.cat(inputs, dim=-1)


@register_layer
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combine (DL4J ElementWiseVertex): add | subtract | product
    | max | average; ResNet's residual adds."""
    op: str = "add"

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if op in ("average", "avg"):
            return sum(inputs) / float(len(inputs))
        raise ValueError(f"Unknown ElementWise op {self.op}")


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertexConf):
    """Feature range [from_idx, to_idx], both inclusive (DL4J SubsetVertex)."""
    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, *input_types: InputType) -> InputType:
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if t.kind == Kind.FF:
            return InputType.feed_forward(n)
        if t.kind == Kind.RNN:
            return InputType(Kind.RNN, (t.shape[0], n))
        if t.kind == Kind.CNN:
            return InputType.convolutional(t.shape[0], t.shape[1], n)
        raise ValueError(t.kind)

    def apply(self, *inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]


@register_layer
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertexConf):
    """Stack along the batch axis (DL4J StackVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        return torch.cat(inputs, dim=0)


@register_layer
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertexConf):
    """Batch slice `from_idx` of `stack_size` (DL4J UnstackVertex)."""
    from_idx: int = 0
    stack_size: int = 1

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]


@register_layer
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertexConf):
    """Batch-preserving reshape (DL4J ReshapeVertex); new_shape excludes
    the batch."""
    new_shape: Tuple[int, ...] = ()
    kind: str = "ff"

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType(Kind(self.kind), tuple(self.new_shape))

    def apply(self, *inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))


@register_layer
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertexConf):
    scale: float = 1.0

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        return inputs[0] * self.scale


@register_layer
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertexConf):
    shift: float = 0.0

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        return inputs[0] + self.shift


@register_layer
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertexConf):
    eps: float = 1e-8

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        x = inputs[0]
        norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
        return x / torch.clamp(norm, min=self.eps)


@register_layer
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertexConf):
    """Pairwise L2 distance between two inputs (DL4J L2Vertex)."""
    eps: float = 1e-8

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(1)

    def apply(self, *inputs):
        a, b = inputs
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        return torch.sqrt((d * d).sum(dim=-1, keepdim=True) + self.eps)


@register_layer
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertexConf):
    """(B, T, F) -> (B, F), the last step (DL4J LastTimeStepVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(input_types[0].shape[1])

    def apply(self, *inputs):
        return inputs[0][:, -1, :]


@register_layer
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """(B, F) -> (B, T, F) by repetition, T from a reference input (DL4J
    DuplicateToTimeSeriesVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        ff, ref = input_types
        return InputType(Kind.RNN, (ref.shape[0], ff.shape[0]))

    def apply(self, *inputs):
        x, ref = inputs
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])


@register_layer
@dataclasses.dataclass(frozen=True)
class ReverseTimeSeriesVertex(GraphVertexConf):
    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        return torch.flip(inputs[0], dims=(1,))


@register_layer
@dataclasses.dataclass(frozen=True)
class PoolHelperVertex(GraphVertexConf):
    """Strip the first spatial row and column of a CNN activation (DL4J
    PoolHelperVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        t = input_types[0]
        if t.kind != Kind.CNN:
            raise ValueError(f"PoolHelperVertex expects CNN input, got "
                             f"{t.kind}")
        h, w, c = t.shape
        return InputType.convolutional(h - 1, w - 1, c)

    def apply(self, *inputs):
        return inputs[0][:, 1:, 1:, :]
