"""Network-level configuration: the sequential and DAG configs and their
builders.

Counterpart of the JAX package's `nn/conf/network.py`:
`MultiLayerConfiguration` and `ComputationGraphConfiguration` with their
JSON and YAML round-trips, the `NeuralNetConfiguration.Builder().list()`
path and `GraphBuilder`. The JSON carries the reference's format tags,
so a config written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, layer_from_dict, layer_to_dict,
)
from deeplearning4j_tpu_torch.nn.updaters import Sgd, get_updater

#: the reference's format tags, kept so the two packages share one format
MULTILAYER_FORMAT = "deeplearning4j_tpu.MultiLayerConfiguration.v1"
GRAPH_FORMAT = "deeplearning4j_tpu.ComputationGraphConfiguration.v1"


def _to_yaml(d: dict) -> str:
    import yaml
    return yaml.safe_dump(d, sort_keys=False)


def _from_yaml(s: str) -> dict:
    import yaml
    return yaml.safe_load(s)


@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    layers: Tuple[LayerConf, ...] = ()
    input_type: Optional[InputType] = None
    seed: int = 0
    updater: Any = dataclasses.field(default_factory=lambda: Sgd(1e-2))
    backprop_type: str = "standard"       # standard | tbptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"                # parameter dtype
    compute_dtype: Optional[str] = None   # activation dtype (None = dtype)
    grad_clip_norm: Optional[float] = None
    grad_clip_value: Optional[float] = None
    gradient_checkpointing: bool = False

    def to_dict(self) -> dict:
        return {
            "format": MULTILAYER_FORMAT,
            "layers": [layer_to_dict(l) for l in self.layers],
            "input_type": None if self.input_type is None
            else self.input_type.to_dict(),
            "seed": self.seed,
            "updater": layer_to_dict(get_updater(self.updater)),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "grad_clip_norm": self.grad_clip_norm,
            "grad_clip_value": self.grad_clip_value,
            "gradient_checkpointing": self.gradient_checkpointing,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self) -> str:
        return _to_yaml(self.to_dict())

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(_from_yaml(s))

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=tuple(layer_from_dict(l) for l in d["layers"]),
            input_type=None if d.get("input_type") is None
            else InputType.from_dict(d["input_type"]),
            seed=d.get("seed", 0),
            updater=layer_from_dict(d["updater"])
            if isinstance(d.get("updater"), dict)
            else d.get("updater", Sgd(1e-2)),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            grad_clip_norm=d.get("grad_clip_norm"),
            grad_clip_value=d.get("grad_clip_value"),
            gradient_checkpointing=d.get("gradient_checkpointing", False),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


class NeuralNetConfiguration:
    """Fluent builder entry point, as in the reference:

        conf = (NeuralNetConfiguration.Builder()
                .seed(12345).updater(AdamW(3e-4))
                .list()
                .layer(EmbeddingSequenceLayer(n_out=256, n_in=1024))
                .layer(RnnOutputLayer(n_out=1024))
                .set_input_type(InputType.recurrent(1, 256))
                .build())
    """

    class Builder:
        def __init__(self):
            self._seed = 0
            self._updater: Any = Sgd(1e-2)
            self._l1 = 0.0
            self._l2 = 0.0
            self._dtype = "float32"
            self._compute_dtype: Optional[str] = None
            self._grad_clip_norm: Optional[float] = None
            self._grad_clip_value: Optional[float] = None
            self._gradient_checkpointing = False
            self._weight_init: Optional[str] = None
            self._activation: Optional[str] = None
            self._dropout: Optional[float] = None

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._updater = u
            return self

        def l1(self, v: float):
            self._l1 = float(v)
            return self

        def l2(self, v: float):
            self._l2 = float(v)
            return self

        def weight_init(self, w: str):
            self._weight_init = w
            return self

        def activation(self, a: str):
            self._activation = a
            return self

        def dropout(self, d: float):
            self._dropout = float(d)
            return self

        def dtype(self, d: str):
            self._dtype = d
            return self

        def compute_dtype(self, d: str):
            self._compute_dtype = d
            return self

        def grad_clip_norm(self, v: float):
            self._grad_clip_norm = float(v)
            return self

        def grad_clip_value(self, v: float):
            self._grad_clip_value = float(v)
            return self

        def gradient_checkpointing(self, on: bool = True):
            self._gradient_checkpointing = bool(on)
            return self

        def list(self) -> "ListBuilder":
            return ListBuilder(self)

        def graph_builder(self) -> "GraphBuilder":
            return GraphBuilder(self)


def _apply_global_defaults(b: "NeuralNetConfiguration.Builder",
                           layer: LayerConf) -> LayerConf:
    """Fill layer fields from global builder defaults when the layer left
    them at their dataclass defaults (DL4J's 'global config' semantics)."""
    updates: Dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(layer)}
    if b._l1 and "l1" in fields and layer.l1 == 0.0:
        updates["l1"] = b._l1
    if b._l2 and "l2" in fields and layer.l2 == 0.0:
        updates["l2"] = b._l2
    if b._dropout is not None and layer.dropout == 0.0:
        updates["dropout"] = b._dropout
    for name, value in (("weight_init", b._weight_init),
                        ("activation", b._activation)):
        if value is not None and name in fields \
                and getattr(layer, name) == fields[name].default:
            updates[name] = value
    return dataclasses.replace(layer, **updates) if updates else layer


class ListBuilder:
    """DL4J NeuralNetConfiguration.ListBuilder analog."""

    def __init__(self, parent: "NeuralNetConfiguration.Builder"):
        self._parent = parent
        self._layers: List[LayerConf] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, l: LayerConf):
        self._layers.append(_apply_global_defaults(self._parent, l))
        return self

    def set_input_type(self, t: InputType):
        self._input_type = t
        return self

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20):
        if t == "tbptt" and back_length != fwd_length:
            raise NotImplementedError(
                "tbptt_back_length != tbptt_fwd_length is not supported; "
                "use equal lengths")
        self._backprop_type = t
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def tbptt(self, fwd_length: int, back_length: Optional[int] = None):
        return self.backprop_type("tbptt", fwd_length,
                                  back_length or fwd_length)

    def build(self) -> MultiLayerConfiguration:
        p = self._parent
        return MultiLayerConfiguration(
            layers=tuple(self._layers),
            input_type=self._input_type,
            seed=p._seed,
            updater=p._updater,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            grad_clip_norm=p._grad_clip_norm,
            grad_clip_value=p._grad_clip_value,
            gradient_checkpointing=p._gradient_checkpointing,
        )


# ------------------------------------------------------------------- graph
@dataclasses.dataclass(frozen=True)
class VertexDef:
    """One node of the DAG: a LayerConf or a GraphVertexConf, and the
    names of its inputs."""
    vertex: Any
    inputs: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ComputationGraphConfiguration:
    """DAG config (DL4J ComputationGraphConfiguration): vertices keyed by
    name, in insertion order; `topological_order` is the reference's."""
    vertices: Dict[str, VertexDef] = dataclasses.field(default_factory=dict)
    network_inputs: Tuple[str, ...] = ()
    network_outputs: Tuple[str, ...] = ()
    input_types: Tuple[InputType, ...] = ()
    seed: int = 0
    updater: Any = dataclasses.field(default_factory=lambda: Sgd(1e-2))
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    grad_clip_norm: Optional[float] = None
    grad_clip_value: Optional[float] = None
    gradient_checkpointing: bool = False

    def topological_order(self) -> List[str]:
        """Sweeps over the vertices in insertion order, taking each whose
        inputs are all known, until none is left (the reference's order,
        which fixes the order of the parameter dict)."""
        order: List[str] = []
        seen = set(self.network_inputs)
        pending = dict(self.vertices)
        while pending:
            progressed = False
            for name, vd in list(pending.items()):
                if all(i in seen for i in vd.inputs):
                    order.append(name)
                    seen.add(name)
                    del pending[name]
                    progressed = True
            if not progressed:
                raise ValueError(f"Graph has a cycle or missing inputs: "
                                 f"{list(pending)}")
        return order

    def to_dict(self) -> dict:
        return {
            "format": GRAPH_FORMAT,
            "vertices": {
                name: {"vertex": layer_to_dict(vd.vertex),
                       "inputs": list(vd.inputs)}
                for name, vd in self.vertices.items()
            },
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            "input_types": [t.to_dict() for t in self.input_types],
            "seed": self.seed,
            "updater": layer_to_dict(get_updater(self.updater)),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "grad_clip_norm": self.grad_clip_norm,
            "grad_clip_value": self.grad_clip_value,
            "gradient_checkpointing": self.gradient_checkpointing,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self) -> str:
        return _to_yaml(self.to_dict())

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(_from_yaml(s))

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            vertices={name: VertexDef(layer_from_dict(vd["vertex"]),
                                      tuple(vd["inputs"]))
                      for name, vd in d["vertices"].items()},
            network_inputs=tuple(d["network_inputs"]),
            network_outputs=tuple(d["network_outputs"]),
            input_types=tuple(InputType.from_dict(t)
                              for t in d.get("input_types", [])),
            seed=d.get("seed", 0),
            updater=layer_from_dict(d["updater"])
            if isinstance(d.get("updater"), dict)
            else d.get("updater", Sgd(1e-2)),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            grad_clip_norm=d.get("grad_clip_norm"),
            grad_clip_value=d.get("grad_clip_value"),
            gradient_checkpointing=d.get("gradient_checkpointing", False),
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """DL4J ComputationGraphConfiguration.GraphBuilder analog; layers get
    the parent builder's global defaults, as in the list path."""

    def __init__(self, parent: Optional["NeuralNetConfiguration.Builder"]
                 = None):
        self._parent = parent or NeuralNetConfiguration.Builder()
        self._vertices: Dict[str, VertexDef] = {}
        self._inputs: Tuple[str, ...] = ()
        self._outputs: Tuple[str, ...] = ()
        self._input_types: Tuple[InputType, ...] = ()
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str):
        self._inputs = tuple(names)
        return self

    def set_input_types(self, *types: InputType):
        self._input_types = tuple(types)
        return self

    def add_layer(self, name: str, layer: LayerConf, *inputs: str):
        self._vertices[name] = VertexDef(
            _apply_global_defaults(self._parent, layer), tuple(inputs))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        self._vertices[name] = VertexDef(vertex, tuple(inputs))
        return self

    def set_outputs(self, *names: str):
        self._outputs = tuple(names)
        return self

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20):
        self._backprop_type = t
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def build(self) -> ComputationGraphConfiguration:
        p = self._parent
        return ComputationGraphConfiguration(
            vertices=dict(self._vertices),
            network_inputs=self._inputs,
            network_outputs=self._outputs,
            input_types=self._input_types,
            seed=p._seed,
            updater=p._updater,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            grad_clip_norm=p._grad_clip_norm,
            grad_clip_value=p._grad_clip_value,
            gradient_checkpointing=p._gradient_checkpointing,
        )
