"""Transfer learning: surgery on trained networks.

Counterpart of the JAX package's `nn/transferlearning.py` (DL4J
`nn/transferlearning/`):
- `TransferLearning` (TransferLearning.Builder, MultiLayerNetwork):
  `set_feature_extractor(n)` freezes layers 0..n, `remove_output_layer` /
  `remove_layers_from_output`, `add_layer`, `n_out_replace`,
  `fine_tune_configuration`.
- `TransferLearningGraph` (TransferLearning.GraphBuilder): the same by
  vertex name, freezing a vertex and its ancestors.
- `FineTuneConfiguration`: updater, l1/l2, dropout and seed overrides for
  the retained layers.
- `TransferLearningHelper`: featurize through the frozen body once and
  train only the head on the features.

Parameters are dicts of tensors, so the surgery is dict work plus a fresh
init of the new layers; retained layers keep copies (not aliases) of
their trained tensors, and frozen layers are `FrozenLayerWrapper`s (no
gradient, NoOp updater). A built network lives on its source's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.base import LayerConf
from deeplearning4j_tpu_torch.nn.layers.samediff import FrozenLayerWrapper
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, as_input, unwrap_frozen,
)
from deeplearning4j_tpu_torch.nn.updaters import tree_map


def _copied(tree):
    return tree_map(torch.clone, tree)


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global overrides applied to every retained layer (DL4J
    FineTuneConfiguration: updater, l1/l2, dropout, seed)."""
    updater: Optional[Any] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def apply_to_layer(self, layer: LayerConf) -> LayerConf:
        changes = {f: getattr(self, f) for f in ("l1", "l2", "dropout")
                   if getattr(self, f) is not None and hasattr(layer, f)}
        return dataclasses.replace(layer, **changes) if changes else layer

    def conf_changes(self) -> dict:
        changes = {}
        if self.updater is not None:
            changes["updater"] = self.updater
        if self.seed is not None:
            changes["seed"] = self.seed
        return changes


class TransferLearning:
    """Builder of a modified MultiLayerNetwork (DL4J
    TransferLearning.Builder)."""

    def __init__(self, network: MultiLayerNetwork):
        if network.params is None:
            raise ValueError("source network must be initialized/trained")
        self._net = network
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._remove_from: Optional[int] = None
        self._appended: List[LayerConf] = []
        self._n_out_replace: Dict[int, int] = {}

    def fine_tune_configuration(self, cfg: FineTuneConfiguration):
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, layer_index: int):
        """Freeze layers [0..layer_index] (DL4J setFeatureExtractor)."""
        self._freeze_until = layer_index
        return self

    def remove_output_layer(self):
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int):
        self._remove_from = len(self._net.layers) - n
        return self

    def n_out_replace(self, layer_index: int, n_out: int):
        """Change a layer's width; its parameters and those of the layers
        its width flows into are initialized afresh (DL4J nOutReplace)."""
        self._n_out_replace[layer_index] = n_out
        return self

    def add_layer(self, layer: LayerConf):
        self._appended.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._net
        keep = len(src.layers) if self._remove_from is None \
            else self._remove_from
        reinit: set = set()
        new_layers: List[LayerConf] = []
        for i in range(keep):
            base = unwrap_frozen(src.layers[i])
            if i in self._n_out_replace:
                base = dataclasses.replace(base,
                                           n_out=self._n_out_replace[i])
                reinit.add(i)
                # the new width reaches every following layer up to and
                # including the next one with its own n_out (batch norm,
                # activations and dropout pass the width on)
                for j in range(i + 1, keep):
                    reinit.add(j)
                    if getattr(unwrap_frozen(src.layers[j]), "n_out", 0):
                        break
            if self._fine_tune is not None:
                base = self._fine_tune.apply_to_layer(base)
            if self._freeze_until is not None and i <= self._freeze_until:
                new_layers.append(FrozenLayerWrapper(layer=base))
            else:
                new_layers.append(base)
        n_kept = len(new_layers)
        new_layers.extend(self._appended)

        changes = {"layers": tuple(new_layers)}
        if self._fine_tune is not None:
            changes.update(self._fine_tune.conf_changes())
        net = MultiLayerNetwork(dataclasses.replace(src.conf, **changes),
                                device=src.device).init()
        for i in range(n_kept):
            if i not in reinit:
                net.params[str(i)] = _copied(src.params[str(i)])
                net.state[str(i)] = _copied(src.state[str(i)])
        net._build_optimizer()
        return net


class TransferLearningHelper:
    """Featurization workflow (DL4J TransferLearningHelper): the frozen
    body runs once per input, and only the head trains, on the
    features."""

    def __init__(self, network: MultiLayerNetwork, frozen_until: int):
        """frozen_until: the last frozen layer's index (inclusive)."""
        self.src = network
        self.frozen_until = frozen_until
        self._split = frozen_until + 1
        if self._split >= len(network.layers):
            raise ValueError("frozen_until leaves no trainable head")
        types = network._resolve_types()
        body_out = network.layers[self._split - 1].output_type(
            types[self._split - 1])
        head_layers = network.layers[self._split:]
        head_conf = dataclasses.replace(network.conf,
                                        layers=tuple(head_layers),
                                        input_type=body_out)
        self.head = MultiLayerNetwork(head_conf,
                                      device=network.device).init()
        for i in range(len(head_layers)):
            self.head.params[str(i)] = _copied(
                network.params[str(self._split + i)])
            self.head.state[str(i)] = _copied(
                network.state[str(self._split + i)])
        self.head._build_optimizer()

    def featurize(self, features) -> torch.Tensor:
        """The frozen body's output, to cache (DL4J featurize())."""
        src = self.src
        with torch.no_grad():
            x, _, _ = src._forward(src.params, src.state,
                                   as_input(features, src.device,
                                            src._compute_dtype),
                                   False, upto=self._split)
        return x

    def fit_featurized(self, features, labels, epochs: int = 1,
                       batch_size: int = 32):
        if isinstance(features, torch.Tensor):
            features = features.cpu().numpy()
        self.head.fit((features, labels), epochs=epochs,
                      batch_size=batch_size)
        return self.head

    def unfrozen_network(self) -> MultiLayerNetwork:
        """A copy of the full network with the trained head written
        back."""
        net = self.src.copy()
        for i in range(self._split, len(net.layers)):
            net.params[str(i)] = _copied(self.head.params[str(i - self._split)])
        return net


class TransferLearningGraph:
    """Surgery on a ComputationGraph (DL4J TransferLearning.GraphBuilder):
    freeze by vertex name, remove vertices and their dependents, attach
    new layers, swap outputs, keeping the retained vertices' trained
    weights."""

    def __init__(self, graph):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        if not isinstance(graph, ComputationGraph):
            raise TypeError("TransferLearningGraph wraps a ComputationGraph")
        if graph.params is None:
            raise ValueError("source graph must be initialized/trained")
        self._net = graph
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_at: List[str] = []
        self._removed: List[str] = []
        self._added: List[tuple] = []        # (name, layer, inputs)
        self._n_out_replace: Dict[str, int] = {}
        self._outputs: Optional[tuple] = None

    def fine_tune_configuration(self, cfg: FineTuneConfiguration):
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, *vertex_names: str):
        """Freeze the named vertices and every ancestor feeding them
        (DL4J setFeatureExtractor(vertexName))."""
        self._freeze_at.extend(vertex_names)
        return self

    def remove_vertex_and_connections(self, name: str):
        self._removed.append(name)
        return self

    def add_layer(self, name: str, layer: LayerConf, *inputs: str):
        self._added.append((name, layer, tuple(inputs)))
        return self

    def n_out_replace(self, name: str, n_out: int):
        self._n_out_replace[name] = n_out
        return self

    def set_outputs(self, *names: str):
        self._outputs = tuple(names)
        return self

    @staticmethod
    def _ancestors(conf, targets) -> set:
        out = set()
        stack = list(targets)
        while stack:
            v = stack.pop()
            if v in out or v in conf.network_inputs:
                continue
            out.add(v)
            stack.extend(conf.vertices[v].inputs)
        return out

    def _check_names(self, conf):
        known = set(conf.vertices) | set(conf.network_inputs)
        unknown = sorted((set(self._freeze_at) | set(self._removed)
                          | set(self._n_out_replace)) - known)
        if unknown:
            raise ValueError(f"unknown vertex names {unknown}; graph has "
                             f"{sorted(conf.vertices)}")
        for name in self._n_out_replace:
            if not hasattr(conf.vertices[name].vertex, "n_out"):
                raise ValueError(
                    f"n_out_replace('{name}'): vertex type "
                    f"{type(conf.vertices[name].vertex).__name__} has no "
                    "n_out to replace")

    def _removed_closure(self, conf) -> set:
        """The removed vertices and every vertex that depends on one."""
        removed = set(self._removed)
        changed = True
        while changed:
            changed = False
            for name, vd in conf.vertices.items():
                if name not in removed and any(i in removed
                                               for i in vd.inputs):
                    removed.add(name)
                    changed = True
        return removed

    def _reinitialized(self, conf) -> set:
        """Vertices whose fan-in changed with a width, through the
        parameter-free vertices (merges, element-wise, batch norm,
        activations) that pass the new width on."""
        reinit = set(self._n_out_replace)
        width_changed = set(self._n_out_replace)
        for name in conf.topological_order():
            vd = conf.vertices.get(name)
            if vd is None or name in width_changed:
                continue
            if any(i in width_changed for i in vd.inputs):
                reinit.add(name)
                if not getattr(unwrap_frozen(vd.vertex), "n_out", 0):
                    width_changed.add(name)
        return reinit

    def build(self):
        from deeplearning4j_tpu_torch.nn.conf.network import VertexDef
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        src = self._net
        conf = src.conf
        self._check_names(conf)
        removed = self._removed_closure(conf)
        frozen = self._ancestors(conf, self._freeze_at) if self._freeze_at \
            else set()
        reinit = self._reinitialized(conf)

        new_vertices: Dict[str, Any] = {}
        for name, vd in conf.vertices.items():
            if name in removed:
                continue
            vertex = unwrap_frozen(vd.vertex)
            if name in self._n_out_replace and hasattr(vertex, "n_out"):
                vertex = dataclasses.replace(
                    vertex, n_out=self._n_out_replace[name])
            if self._fine_tune is not None and isinstance(vertex, LayerConf):
                vertex = self._fine_tune.apply_to_layer(vertex)
            if name in frozen and isinstance(vertex, LayerConf):
                vertex = FrozenLayerWrapper(layer=vertex)
            new_vertices[name] = dataclasses.replace(vd, vertex=vertex)
        for name, layer, inputs in self._added:
            if name in new_vertices:
                raise ValueError(
                    f"add_layer('{name}'): a vertex with that name is "
                    "already retained — remove it first or pick another "
                    "name")
            missing = [i for i in inputs if i not in new_vertices
                       and i not in conf.network_inputs]
            if missing:
                raise ValueError(f"add_layer('{name}'): unknown inputs "
                                 f"{missing}")
            new_vertices[name] = VertexDef(layer, tuple(inputs))

        outputs = self._outputs if self._outputs is not None else tuple(
            o for o in conf.network_outputs if o in new_vertices)
        if not outputs:
            raise ValueError("resulting graph has no outputs — call "
                             "set_outputs(...)")
        changes = {"vertices": new_vertices, "network_outputs": outputs}
        if self._fine_tune is not None:
            changes.update(self._fine_tune.conf_changes())
        net = ComputationGraph(dataclasses.replace(conf, **changes),
                               device=src.device).init()
        added = {n for n, _, _ in self._added}
        for name in new_vertices:
            if name in added or name in reinit:
                continue
            if name in src.params:
                net.params[name] = _copied(src.params[name])
            if src.state and name in src.state:
                net.state[name] = _copied(src.state[name])
        net._build_optimizer()
        return net
