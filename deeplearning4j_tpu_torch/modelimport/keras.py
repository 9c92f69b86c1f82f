"""Keras model import.

Parity target: DL4J `deeplearning4j-modelimport/.../keras/KerasModelImport.java:41-125`
(importKerasSequentialModelAndWeights / importKerasModelAndWeights),
`KerasModel.java:57,276,377` (config parse + weight copy), and the
`layers/` mapper packages.

Scope: Keras 2/3 HDF5 archives (`model.save("x.h5")`) and config+weights
pairs. Sequential models map to MultiLayerNetwork; functional Models with
linear or merge (Add/Concatenate) topologies map to ComputationGraph.

A structural advantage over the reference: Keras(TF) is NHWC/HWIO and so is
this framework, so convolution kernels import WITHOUT the NCHW transposition
gymnastics DL4J needs (`KerasModel.java:276-377` weight transposition) —
weights copy through verbatim; only LSTM gate blocks are order-checked
(Keras i,f,c,o == ours i,f,g,o).

The port's counterpart of the JAX package's `modelimport/keras.py`. The
network is built on `device` (default CUDA, raising without it; ``"cpu"``
for the CPU), initialized there, and each Keras weight is copied into
its tensor in place, in the tensor's dtype; a weight whose shape is not
the layer's raises. h5py is imported only where an archive is read, so
`import_keras_model_configuration` (a JSON config) works without it.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.base import InputType, LayerConf
from deeplearning4j_tpu_torch.util.platform import DeviceLike


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:
        raise ImportError(
            "Keras import requires h5py (unavailable in this build)") from e


def _put(params: dict, key: str, w) -> None:
    """Copy one Keras weight into the network's tensor `params[key]`, in
    place, in its dtype and on its device."""
    t = params[key]
    a = np.asarray(w)
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"Keras weight of shape {tuple(a.shape)} does not "
                         f"fit the parameter {key!r} of shape "
                         f"{tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))


_ACTIVATIONS = {
    "relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
    "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign", "swish": "swish",
    "silu": "swish", "gelu": "gelu", "hard_sigmoid": "hardsigmoid",
    "leaky_relu": "leakyrelu", "relu6": "relu6", "mish": "mish",
}


# Keras loss names -> ours (KerasLossUtils.mapLossFunction)
_LOSS_MAP = {
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "sparse_mcxent",
    "binary_crossentropy": "xent",
    "kullback_leibler_divergence": "kl_divergence", "kld": "kl_divergence",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
}


def _map_loss(name) -> str:
    """Keras loss -> ours; unknown losses refuse loudly (a silently
    different training objective is worse than an import error)."""
    if isinstance(name, dict):
        # serialized loss objects: config.name is the snake_case registry
        # key; class_name is CamelCase and only a last resort
        name = (name.get("config", {}) or {}).get(
            "name", name.get("class_name", ""))
    key = str(name).lower()
    if key not in _LOSS_MAP:
        raise ValueError(f"Unsupported Keras loss '{name}' "
                         f"(mappable: {sorted(_LOSS_MAP)})")
    return _LOSS_MAP[key]


def _act(name) -> str:
    if isinstance(name, dict):      # serialized activation object
        name = name.get("class_name", "linear").lower()
    mapped = _ACTIVATIONS.get(str(name).lower())
    if mapped is None:
        raise ValueError(f"Unsupported Keras activation '{name}'")
    return mapped


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _padding(mode: str) -> str:
    return {"same": "same", "valid": "truncate"}[mode]


class KerasModelImport:
    """Entry points (KerasModelImport.java API parity)."""

    @staticmethod
    def import_keras_sequential_model_and_weights(path: str,
                                                  enforce_training_config:
                                                  bool = False,
                                                  device: DeviceLike = None):
        net = KerasModelImport._import(path, device)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        if not isinstance(net, MultiLayerNetwork):
            raise ValueError("model is not Sequential; use "
                             "import_keras_model_and_weights")
        return net

    @staticmethod
    def import_keras_model_and_weights(path: str, device: DeviceLike = None):
        return KerasModelImport._import(path, device)

    @staticmethod
    def import_keras_model_configuration(json_path: str,
                                         device: DeviceLike = None):
        """Config-only import (DL4J importKerasSequentialConfiguration):
        the network on `device`, not yet initialized."""
        with open(json_path) as f:
            cfg = json.load(f)
        conf, _ = _build_from_config(cfg, device=device)
        return conf

    # ------------------------------------------------------------ internals
    @staticmethod
    def _import(path: str, device: DeviceLike = None):
        h5py = _h5py()
        with h5py.File(path, "r") as f:
            if "model_config" not in f.attrs:
                raise ValueError(
                    f"{path}: no model_config attribute — is this a Keras "
                    "model archive saved with model.save()?")
            raw = f.attrs["model_config"]
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            cfg = json.loads(raw)
            updater = _updater_from_training_config(f.attrs.get(
                "training_config"))
            output_loss = _loss_from_training_config(f.attrs.get(
                "training_config"))
            net, importers = _build_from_config(cfg, updater=updater,
                                                output_loss=output_loss,
                                                device=device)
            net.init()
            weights_root = f["model_weights"] if "model_weights" in f else f
            for name, load in importers:
                if name is None:
                    continue
                load(net, _layer_weights(weights_root, name))
        return net


class _WeightList(list):
    """Weights plus their h5 paths — wrapper mappers (Bidirectional) need
    the names to tell the forward/backward halves apart, since Keras 2
    lists forward first while h5 alphabetical iteration yields backward
    first."""
    names: List[str]


def _layer_weights(root, layer_name: str) -> "_WeightList":
    """Datasets for one layer, in weight_names order (Keras 2) or h5
    iteration order of the nested group (Keras 3)."""
    out = _WeightList()
    out.names = []
    if layer_name not in root:
        return out
    g = root[layer_name]
    names = g.attrs.get("weight_names")
    if names is not None:
        for n in names:
            if isinstance(n, bytes):
                n = n.decode("utf-8")
            # Keras 2 paths are relative to the layer group; Keras 3
            # prefixes the model name — try both
            node = g
            for part in n.split("/"):
                if part in node:
                    node = node[part]
                else:
                    node = None
                    break
            if node is None:
                node = _find_dataset(g, n.split("/")[-1])
            out.append(np.asarray(node))
            out.names.append(n)
        return out
    _collect_datasets(g, out)
    return out


def _find_dataset(g, name):
    found = []

    def visit(_, obj):
        if getattr(obj, "shape", None) is not None and \
                obj.name.split("/")[-1] == name:
            found.append(obj)
    g.visititems(visit)
    if not found:
        raise KeyError(f"weight dataset '{name}' not found")
    return found[0]


def _collect_datasets(g, out, prefix=""):
    for k in g:
        obj = g[k]
        if getattr(obj, "shape", None) is not None:
            out.append(np.asarray(obj))
            if hasattr(out, "names"):
                out.names.append(prefix + k)
        else:
            _collect_datasets(obj, out, prefix + k + "/")


# --------------------------------------------------------------- conf build
def _updater_from_training_config(raw):
    """Map a compiled model's saved optimizer onto our updaters (DL4J
    `enforceTrainingConfig` path, KerasModel.java:276 optimizer import).
    Returns None when the model was saved uncompiled."""
    if raw is None:
        return None
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    try:
        tc = json.loads(raw)
    except (TypeError, ValueError):
        return None
    opt = tc.get("optimizer_config") or {}
    ocls = str(opt.get("class_name", "")).rsplit(">", 1)[-1].lower()
    ocfg = opt.get("config", {})
    lr = ocfg.get("learning_rate", ocfg.get("lr", 1e-3))
    if isinstance(lr, dict):        # LR schedule object — use its base rate
        lr = lr.get("config", {}).get("initial_learning_rate", 1e-3)
    lr = float(lr)
    from deeplearning4j_tpu_torch.nn import updaters as U
    if ocls == "sgd":
        mom = float(ocfg.get("momentum", 0.0))
        if mom and ocfg.get("nesterov"):
            return U.Nesterovs(lr, momentum=mom)
        if mom:
            return U.Momentum(lr, momentum=mom)
        return U.Sgd(lr)
    if ocls == "rmsprop":
        return U.RmsProp(lr, decay=float(ocfg.get("rho", 0.9)))
    if ocls == "adagrad":
        return U.AdaGrad(lr)
    if ocls == "adamax":
        return U.AdaMax(lr)
    if ocls == "nadam":
        return U.Nadam(lr)
    if ocls == "adadelta":
        return U.AdaDelta(rho=float(ocfg.get("rho", 0.95)))
    if ocls == "adamw":
        wd = ocfg.get("weight_decay")
        return U.AdamW(lr, weight_decay=4e-3 if wd is None else float(wd))
    if ocfg.get("amsgrad"):
        return U.AMSGrad(lr, beta1=float(ocfg.get("beta_1", 0.9)),
                         beta2=float(ocfg.get("beta_2", 0.999)))
    return U.Adam(lr, beta1=float(ocfg.get("beta_1", 0.9)),
                  beta2=float(ocfg.get("beta_2", 0.999)))


def _build_from_config(cfg: dict, updater=None, output_loss=None,
                       device: DeviceLike = None):
    cls = cfg.get("class_name")
    inner = cfg.get("config", cfg)
    if cls == "Sequential":
        return _build_sequential(inner, updater=updater,
                                 output_loss=output_loss, device=device)
    if cls in ("Model", "Functional"):
        return _build_functional(inner, updater=updater,
                                 output_loss=output_loss, device=device)
    raise ValueError(f"Unsupported Keras model class '{cls}'")


def _loss_from_training_config(raw):
    """The compiled model's loss (KerasLoss.java's real role): mapped to
    our registry when recognized, None when absent/unmappable (fall back
    to the activation heuristic rather than failing the import —
    inference parity never depends on the training loss)."""
    if raw is None:
        return None
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    try:
        tc = json.loads(raw)
    except (TypeError, ValueError):
        return None
    loss = tc.get("loss")
    if isinstance(loss, dict):
        loss = (loss.get("config", {}) or {}).get("name",
                                                  loss.get("class_name"))
    if isinstance(loss, (list, tuple)):
        # multi-output models: per-output losses can differ — applying
        # loss[0] to every head would silently train secondary outputs
        # against the wrong objective, so defer to the per-layer
        # activation heuristic instead
        uniq = {_LOSS_MAP.get(str(l).lower()) for l in loss}
        if len(uniq) != 1:      # per-output objectives differ: heuristic
            return None
        loss = next(iter(uniq))
        return loss             # already mapped (None when unmappable)
    if loss is None:
        return None
    return _LOSS_MAP.get(str(loss).lower())


def _input_type_from_shape(shape) -> InputType:
    dims = [d for d in shape if d is not None]
    if len(dims) == 3:
        return InputType.convolutional(*dims)       # (H, W, C) NHWC
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    raise ValueError(f"Unsupported input shape {shape}")


def _build_sequential(cfg: dict, updater=None, output_loss=None,
                      device: DeviceLike = None):
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    layers_cfg = cfg["layers"]
    input_type = None
    b = (NeuralNetConfiguration.Builder()
         .updater(updater if updater is not None else Adam(1e-3)).list())
    importers: List[Tuple[Optional[str], Any]] = []
    n_real = sum(1 for lc in layers_cfg
                 if lc["class_name"] not in ("InputLayer", "Flatten",
                                             "Dropout", "Masking"))
    seen_real = 0
    cur_seq = False        # is the running activation a (B, T, F) sequence?
    pending_mask = None    # Keras Masking wraps the NEXT RNN layer
    for lc in layers_cfg:
        k_cls = lc["class_name"]
        k_cfg = lc.get("config", {})
        name = k_cfg.get("name", lc.get("name"))
        if k_cls == "InputLayer":
            shape = k_cfg.get("batch_shape") or k_cfg.get(
                "batch_input_shape")
            input_type = _input_type_from_shape(shape[1:])
            cur_seq = input_type.kind.value == "rnn"
            continue
        if input_type is None and (
                k_cfg.get("batch_input_shape") or k_cfg.get("batch_shape")):
            shape = k_cfg.get("batch_input_shape") or k_cfg["batch_shape"]
            input_type = _input_type_from_shape(shape[1:])
            cur_seq = input_type.kind.value == "rnn"
        if k_cls == "Flatten":
            cur_seq = False     # auto preprocessor handles CNN/RNN->FF
            continue
        if k_cls == "Masking":
            # Keras Masking emits a mask that propagates to EVERY
            # downstream RNN until the sequence collapses. Mapping: wrap
            # each subsequent recurrent layer in MaskZeroLayer — the first
            # with the configured mask_value, later ones with 0.0 (masked
            # steps emit exact zeros, so the mask re-derives).
            pending_mask = float(k_cfg.get("mask_value", 0.0))
            continue
        is_last_real = False
        if k_cls not in ("Dropout",):
            seen_real += 1
            is_last_real = seen_real == n_real
        layer, loader = _map_layer(k_cls, k_cfg, is_last_real,
                                   sequence=cur_seq,
                                   output_loss=output_loss)
        cur_seq = _sequence_after(k_cls, cur_seq, k_cfg)
        if layer is None:
            continue
        if pending_mask is not None and _recurrent_capable(layer):
            layer = _wrap_mask_zero(layer, pending_mask, k_cls)
            pending_mask = 0.0      # downstream masked steps are zeroed
        elif pending_mask is not None and k_cls not in _MASK_TRANSPARENT:
            # layer transforms values (e.g. Dense bias), so masked steps
            # are no longer re-derivable from zeros — silent divergence
            # from Keras; refuse loudly (pass features_mask at fit/output
            # time instead of relying on an in-graph Masking layer)
            raise ValueError(
                f"Keras Masking cannot propagate through '{k_cls}': masked "
                "steps would stop being exact zeros. Remove the Masking "
                "layer and supply features_mask explicitly instead.")
        if not cur_seq:
            pending_mask = None     # mask consumed / sequence collapsed
        b.layer(layer)
        importers.append((name if loader else None, loader))
    if input_type is None:
        raise ValueError("Could not infer input shape from Keras config")
    b.set_input_type(input_type)
    conf = b.build()
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf, device=device)
    # bind loader closures to layer indices
    bound = []
    for i, (name, loader) in enumerate(importers):
        if name is None or loader is None:
            continue
        bound.append((name, _bind_mln_loader(loader, i)))
    return net, bound


# Keras classes whose mapped layer is purely multiplicative on values
# (identity at inference), so exact-zero masked steps stay exact zeros and
# a chained MaskZeroLayer re-derives the same mask
_MASK_TRANSPARENT = frozenset({
    "Dropout", "SpatialDropout1D", "SpatialDropout2D", "GaussianDropout",
})


def _recurrent_capable(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers import Bidirectional, LastTimeStep
    return (hasattr(layer, "apply_seq")
            or isinstance(layer, (Bidirectional, LastTimeStep)))


def _wrap_mask_zero(layer, mask_value: float, k_cls: str):
    """Wrap a recurrent layer downstream of a Keras Masking in
    MaskZeroLayer (the KerasMasking -> MaskZeroLayer mapping)."""
    from deeplearning4j_tpu_torch.nn.layers import MaskZeroLayer
    if not _recurrent_capable(layer):
        raise ValueError(
            f"Keras Masking must be followed by a recurrent layer; got "
            f"'{k_cls}'")
    return MaskZeroLayer(layer=layer, mask_value=mask_value)


def _bind_mln_loader(loader, index):
    def load(net, weights):
        if not weights:
            return
        loader(net.params[str(index)], net.state[str(index)], weights)
    return load


def _vertex_name(name: str, node_idx: int) -> str:
    """Vertex name for one call site of a (possibly shared) Keras layer."""
    return name if node_idx == 0 else f"{name}__call{node_idx}"


def _build_functional(cfg: dict, updater=None, output_loss=None,
                      device: DeviceLike = None):
    from deeplearning4j_tpu_torch.nn.conf.network import (
        GraphBuilder, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
        ElementWiseVertex, MergeVertex,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    g = GraphBuilder(NeuralNetConfiguration.Builder()
                     .updater(updater if updater is not None else Adam(1e-3)))
    inputs = []
    input_types = []
    importers = []
    out_names = _io_vertex_names(cfg.get("output_layers", []))
    flatten_alias: Dict[str, str] = {}
    mask_pending: Dict[str, float] = {}   # Masking node -> mask_value
    seq_of: Dict[str, bool] = {}
    _WEIGHTLESS = {"Flatten", "Masking", "Dropout", "Activation",
                   "Add", "Concatenate", "Average", "Maximum", "Subtract",
                   "Multiply", "LeakyReLU", "ELU", "ReLU", "Softmax",
                   "SpatialDropout1D", "SpatialDropout2D", "GaussianNoise",
                   "GaussianDropout", "AlphaDropout", "Permute", "Reshape",
                   "RepeatVector", "Cropping1D", "Cropping2D",
                   "UpSampling1D", "UpSampling2D", "ZeroPadding1D",
                   "ZeroPadding2D", "MaxPooling1D", "MaxPooling2D",
                   "AveragePooling1D", "AveragePooling2D",
                   "GlobalAveragePooling1D", "GlobalAveragePooling2D",
                   "GlobalMaxPooling1D", "GlobalMaxPooling2D"}
    for lc in cfg["layers"]:
        k_cls = lc["class_name"]
        k_cfg = lc.get("config", {})
        name = k_cfg.get("name", lc.get("name"))
        if k_cls == "InputLayer":
            shape = k_cfg.get("batch_shape") or k_cfg.get(
                "batch_input_shape")
            inputs.append(name)
            t = _input_type_from_shape(shape[1:])
            input_types.append(t)
            seq_of[name] = t.kind.value == "rnn"
            continue
        if k_cls in ("NotEqual", "Any"):
            # Keras 3 materializes Masking's mask as NotEqual -> Any op
            # nodes feeding downstream `mask` kwargs (which the inbound
            # walker ignores); the Masking node carries the semantics
            continue
        call_sites = _inbound_per_node(lc)
        if len(call_sites) > 1 and k_cls not in _WEIGHTLESS:
            # Keras shares ONE weight set across call sites; vertices here
            # are per-call-site with COPIED weights, so forward parity
            # holds at import but further training unties them
            import logging
            logging.getLogger("deeplearning4j_tpu_torch").warning(
                "shared Keras layer '%s' (%d call sites): imported as "
                "per-call-site vertices with copied weights — training "
                "will untie them", name, len(call_sites))
        for node_idx, entries in enumerate(call_sites):
            vname = _vertex_name(name, node_idx)
            raw_inbound = [_vertex_name(n, ni) for n, ni in entries]
            inbound = [flatten_alias.get(n, n) for n in raw_inbound]
            in_seq = seq_of.get(inbound[0], False) if inbound else False
            if k_cls == "Flatten":
                flatten_alias[vname] = inbound[0]   # auto preprocessor
                seq_of[vname] = False
                continue
            if k_cls == "Masking":
                # alias through; consumers get wrapped in MaskZeroLayer
                flatten_alias[vname] = inbound[0]
                mask_pending[vname] = float(k_cfg.get("mask_value", 0.0))
                seq_of[vname] = in_seq
                continue
            carried = next((mask_pending[n] for n in raw_inbound
                            if n in mask_pending), None)
            if k_cls in ("Add", "Concatenate", "Average", "Maximum",
                         "Subtract", "Multiply"):
                if carried is not None:
                    raise ValueError(
                        f"Keras Masking cannot propagate through a "
                        f"'{k_cls}' merge; supply features_mask "
                        "explicitly instead.")
                vertex = MergeVertex() if k_cls == "Concatenate" else \
                    ElementWiseVertex(op={"Add": "add",
                                          "Subtract": "subtract",
                                          "Multiply": "product",
                                          "Average": "average",
                                          "Maximum": "max"}[k_cls])
                g.add_vertex(vname, vertex, *inbound)
                seq_of[vname] = in_seq
                continue
            layer, loader = _map_layer(k_cls, k_cfg, vname in out_names,
                                       sequence=in_seq,
                                       output_loss=output_loss)
            seq_of[vname] = _sequence_after(k_cls, in_seq, k_cfg)
            if layer is None:
                flatten_alias[vname] = inbound[0]
                if carried is not None:
                    mask_pending[vname] = carried
                continue
            if carried is not None:
                if _recurrent_capable(layer):
                    layer = _wrap_mask_zero(layer, carried, k_cls)
                    if seq_of[vname]:   # masked steps now exact zeros
                        mask_pending[vname] = 0.0
                elif k_cls in _MASK_TRANSPARENT:
                    mask_pending[vname] = carried   # zero-preserving
                else:
                    raise ValueError(
                        f"Keras Masking cannot propagate through "
                        f"'{k_cls}': masked steps would stop being exact "
                        "zeros. Supply features_mask explicitly instead.")
            g.add_layer(vname, layer, *inbound)
            if loader:
                # every call-site vertex loads the SAME keras weight group
                importers.append((name, _bind_graph_loader(loader, vname)))
    g.add_inputs(*inputs)
    g.set_input_types(*input_types)
    g.set_outputs(*out_names)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = ComputationGraph(g.build(), device=device)
    return net, importers


def _io_vertex_names(v) -> List[str]:
    """output_layers entries -> per-call-site vertex names (the entry's
    node index selects WHICH call of a shared layer is the output)."""
    if not v:
        return []
    if isinstance(v, list) and isinstance(v[0], str):
        return [_vertex_name(v[0], int(v[1]) if len(v) > 1 else 0)]
    out = []
    for o in v:
        if isinstance(o, list):
            out.append(_vertex_name(
                o[0], int(o[1]) if len(o) > 1 else 0))
        else:
            out.append(str(o))
    return out


def _bind_graph_loader(loader, name):
    def load(net, weights):
        if not weights:
            return
        loader(net.params[name], net.state[name], weights)
    return load



def _inbound_per_node(lc) -> List[List[Tuple[str, int]]]:
    """One entry per CALL SITE of this layer: the list of
    (producer_name, producer_node_index) pairs that call consumes.
    Multiple call sites = a shared layer (weight reuse in Keras)."""
    nodes_out: List[List[Tuple[str, int]]] = []
    for node in lc.get("inbound_nodes", []):
        cur: List[Tuple[str, int]] = []
        if isinstance(node, dict):      # Keras 3 style
            args = node.get("args", [])

            def walk(a):
                if isinstance(a, dict) and "config" in a and \
                        "keras_history" in a.get("config", {}):
                    h = a["config"]["keras_history"]
                    cur.append((h[0], int(h[1]) if len(h) > 1 else 0))
                elif isinstance(a, (list, tuple)):
                    for x in a:
                        walk(x)
            walk(args)
        else:                           # Keras 2: [[name, node, 0, {}],..]
            for entry in node:
                cur.append((entry[0],
                            int(entry[1]) if len(entry) > 1 else 0))
        nodes_out.append(cur)
    return nodes_out



def _sequence_after(k_cls: str, cur_seq: bool, k_cfg: dict = None) -> bool:
    """Does the activation remain/become a (B, T, F) sequence after this
    layer? LSTM/GRU/Embedding emit sequences; pooling/Dense/conv leave
    them. RNN layers with return_sequences=False collapse to (B, F)."""
    k_cfg = k_cfg or {}
    if k_cls in ("LSTM", "GRU", "SimpleRNN"):
        return bool(k_cfg.get("return_sequences", False))
    if k_cls == "Bidirectional":
        inner = k_cfg.get("layer", {}).get("config", {})
        return bool(inner.get("return_sequences", False))
    if k_cls in ("Embedding", "RepeatVector"):
        return True
    if k_cls in ("GlobalAveragePooling1D", "GlobalMaxPooling1D",
                 "Flatten"):
        return False
    if k_cls in ("Conv1D", "AtrousConvolution1D", "MaxPooling1D",
                 "AveragePooling1D", "Cropping1D", "UpSampling1D",
                 "ZeroPadding1D", "LocallyConnected1D", "Masking"):
        return cur_seq          # 1D conv/pool/pad keep (B, T, C) sequences
    if k_cls == "Reshape":
        return len(k_cfg.get("target_shape", ())) == 2   # (T, C) -> seq
    if k_cls in ("Dropout", "Activation", "BatchNormalization",
                 "LayerNormalization", "Dense", "TimeDistributed",
                 "LeakyReLU", "ELU", "ReLU", "Softmax", "Permute",
                 "SpatialDropout1D", "SpatialDropout2D", "GaussianNoise",
                 "GaussianDropout", "AlphaDropout"):
        return cur_seq          # Keras Dense on 3D is time-distributed
    return False


# -------------------------------------------------------------- layer maps
def _map_layer(k_cls: str, k_cfg: dict, is_output: bool,
               sequence: bool = False, output_loss=None):
    """Returns (LayerConf | None, loader | None). loader(params, state,
    weights) copies Keras weights into the network's tensors."""
    from deeplearning4j_tpu_torch.nn.layers import (
        GRU, ActivationLayer, BatchNormalization, Bidirectional,
        ConvolutionLayer, Cropping1D, Cropping2D, Deconvolution2D,
        DenseLayer, DepthwiseConvolution2D, DropoutLayer,
        EmbeddingSequenceLayer, GlobalPoolingLayer, LastTimeStep,
        LayerNormLayer, LocallyConnected1D, LocallyConnected2D, LSTM,
        OutputLayer, PermuteLayer, RepeatVector, RnnOutputLayer,
        SeparableConvolution2D, SimpleRnn, SubsamplingLayer, Upsampling1D,
        ZeroPadding1DLayer, ZeroPaddingLayer,
    )
    if k_cls in ("AtrousConvolution1D", "AtrousConvolution2D"):
        # genuine Keras-1 archives use the old field names — normalize
        # them to the Keras-2 keys the conv branches read
        legacy = {"nb_filter": "filters", "filter_length": "kernel_size",
                  "subsample_length": "strides", "subsample": "strides",
                  "border_mode": "padding", "atrous_rate": "dilation_rate"}
        k_cfg = dict(k_cfg)
        for old_key, new_key in legacy.items():
            if old_key in k_cfg and new_key not in k_cfg:
                k_cfg[new_key] = k_cfg.pop(old_key)
        if "kernel_size" not in k_cfg and "nb_row" in k_cfg:
            k_cfg["kernel_size"] = [k_cfg.pop("nb_row"),
                                    k_cfg.pop("nb_col")]

    def set_wb(params, state, w):
        _put(params, "W", w[0])
        if len(w) > 1 and "b" in params:
            _put(params, "b", w[1])

    if k_cls == "Dense":
        act = _act(k_cfg.get("activation", "linear"))
        # the compiled model's loss (training_config) wins over the
        # activation heuristic — the KerasLoss.java role
        heur = "mcxent" if act == "softmax" else "mse"
        out_loss = output_loss or heur
        if sequence:
            # Keras Dense on a 3D input is time-distributed; RnnOutputLayer
            # is the (B, T, F) dense projection here (its loss only engages
            # when it terminates a training network)
            return RnnOutputLayer(
                n_out=int(k_cfg["units"]), activation=act,
                loss=out_loss if is_output else heur,
                has_bias=k_cfg.get("use_bias", True)), set_wb
        if is_output and (act == "softmax" or output_loss is not None):
            return OutputLayer(n_out=int(k_cfg["units"]), activation=act,
                               loss=out_loss,
                               has_bias=k_cfg.get("use_bias", True)), set_wb
        return DenseLayer(n_out=int(k_cfg["units"]), activation=act,
                          has_bias=k_cfg.get("use_bias", True)), set_wb

    if k_cls in ("Conv2D", "AtrousConvolution2D"):
        return ConvolutionLayer(
            n_out=int(k_cfg["filters"]),
            kernel=_pair(k_cfg.get("kernel_size", 3)),
            stride=_pair(k_cfg.get("strides", 1)),
            dilation=_pair(k_cfg.get("dilation_rate", 1)),
            convolution_mode=_padding(k_cfg.get("padding", "valid")),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), set_wb

    if k_cls in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            kernel=_pair(k_cfg.get("pool_size", 2)),
            stride=_pair(k_cfg.get("strides") or k_cfg.get("pool_size", 2)),
            pooling_type="max" if k_cls.startswith("Max") else "avg",
            convolution_mode=_padding(k_cfg.get("padding", "valid"))), None

    if k_cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        return GlobalPoolingLayer(
            pooling_type="avg" if "Average" in k_cls else "max"), None

    if k_cls == "Dropout":
        return DropoutLayer(dropout=float(k_cfg.get("rate", 0.5))), None

    if k_cls == "Activation":
        return ActivationLayer(
            activation=_act(k_cfg.get("activation", "linear"))), None

    if k_cls == "ZeroPadding2D":
        pad = k_cfg.get("padding", 1)
        if isinstance(pad, int):
            p = (pad, pad, pad, pad)
        else:
            (t, bm), (l, r) = pad
            p = (t, bm, l, r)
        return ZeroPaddingLayer(padding=tuple(int(x) for x in p)), None

    if k_cls == "BatchNormalization":
        def load_bn(params, state, w):
            # Keras order: gamma, beta, moving_mean, moving_variance
            _put(params, "gamma", w[0])
            _put(params, "beta", w[1])
            _put(state, "mean", w[2])
            _put(state, "var", w[3])
        return BatchNormalization(
            epsilon=float(k_cfg.get("epsilon", 1e-3)),
            decay=float(k_cfg.get("momentum", 0.99))), load_bn

    if k_cls == "LayerNormalization":
        def load_ln(params, state, w):
            _put(params, "gamma", w[0])
            _put(params, "beta", w[1])
        return LayerNormLayer(
            epsilon=float(k_cfg.get("epsilon", 1e-3))), load_ln

    if k_cls == "Embedding":
        def load_emb(params, state, w):
            _put(params, "W", w[0])
        return EmbeddingSequenceLayer(
            n_out=int(k_cfg["output_dim"]),
            n_in=int(k_cfg["input_dim"])), load_emb

    if k_cls == "LSTM":
        def load_lstm(params, state, w):
            # Keras: kernel (in, 4H), recurrent_kernel (H, 4H), bias (4H)
            # gate order i,f,c,o == ours i,f,g,o — verbatim copy
            _put(params, "W", w[0])
            _put(params, "R", w[1])
            if len(w) > 2:
                _put(params, "b", w[2])
        layer = LSTM(
            n_out=int(k_cfg["units"]),
            activation=_act(k_cfg.get("activation", "tanh")),
            gate_activation=_act(
                k_cfg.get("recurrent_activation", "sigmoid")))
        if not k_cfg.get("return_sequences", False):
            # KerasLstm.java:212 — return_sequences=False == LastTimeStep
            layer = LastTimeStep(layer=layer)
        return layer, load_lstm

    if k_cls == "SimpleRNN":
        def load_rnn(params, state, w):
            # Keras: kernel (in, H), recurrent_kernel (H, H), bias (H)
            _put(params, "W", w[0])
            _put(params, "R", w[1])
            if len(w) > 2:
                _put(params, "b", w[2])
        layer = SimpleRnn(n_out=int(k_cfg["units"]),
                          activation=_act(k_cfg.get("activation", "tanh")))
        if not k_cfg.get("return_sequences", False):
            layer = LastTimeStep(layer=layer)
        return layer, load_rnn

    if k_cls == "Bidirectional":
        inner = k_cfg.get("layer") or {}
        inner_cls = inner.get("class_name")
        inner_cfg = dict(inner.get("config", {}))
        if inner_cls not in ("LSTM", "GRU", "SimpleRNN"):
            raise ValueError(f"Bidirectional: unsupported inner layer "
                             f"'{inner_cls}'")
        merge = k_cfg.get("merge_mode", "concat")
        mode = {"concat": "concat", "sum": "add", "mul": "mul",
                "ave": "ave"}.get(merge)
        if mode is None:
            raise ValueError(f"Bidirectional: merge_mode '{merge}' is not "
                             "mapped (concat/sum/mul/ave)")
        # map the inner layer (LastTimeStep-wrapped when
        # return_sequences=False — KerasBidirectional.java:126-137 builds
        # Bidirectional(mode, LastTimeStep(rnn)) in that case)
        inner_layer, inner_loader = _map_layer(inner_cls, inner_cfg, False,
                                               sequence=True)

        def load_bi(params, state, w):
            half = len(w) // 2
            fw, bw = w[:half], w[half:]
            names = getattr(w, "names", None)
            if names and any("backward" in str(n) for n in names[:half]):
                fw, bw = bw, fw     # h5 alphabetical order: backward first
            inner_loader(params["fwd"], {}, fw)
            inner_loader(params["bwd"], {}, bw)
        return Bidirectional(layer=inner_layer, mode=mode), load_bi

    if k_cls == "GRU":
        reset_after = bool(k_cfg.get("reset_after", True))

        def load_gru(params, state, w):
            # Keras: kernel (in, 3H), recurrent_kernel (H, 3H), bias
            # ((2, 3H) when reset_after else (3H,)); gate order z,r,h ==
            # ours — verbatim copy
            _put(params, "W", w[0])
            _put(params, "R", w[1])
            if len(w) > 2:
                _put(params, "b", np.asarray(w[2]).reshape(
                    tuple(params["b"].shape)))
        layer = GRU(
            n_out=int(k_cfg["units"]),
            activation=_act(k_cfg.get("activation", "tanh")),
            gate_activation=_act(
                k_cfg.get("recurrent_activation", "sigmoid")),
            reset_after=reset_after)
        if not k_cfg.get("return_sequences", False):
            layer = LastTimeStep(layer=layer)
        return layer, load_gru

    if k_cls == "Conv2DTranspose":
        def load_deconv(params, state, w):
            # Keras kernel (kh, kw, out, in), spatial taps stored for the
            # gradient-of-conv formulation; our conv_transpose consumes an
            # unflipped HWIO kernel -> flip spatial dims and swap in/out
            _put(params, "W",
                np.asarray(w[0])[::-1, ::-1].transpose(0, 1, 3, 2))
            if len(w) > 1 and "b" in params:
                _put(params, "b", w[1])
        return Deconvolution2D(
            n_out=int(k_cfg["filters"]),
            kernel=_pair(k_cfg.get("kernel_size", 3)),
            stride=_pair(k_cfg.get("strides", 1)),
            dilation=_pair(k_cfg.get("dilation_rate", 1)),
            convolution_mode=_padding(k_cfg.get("padding", "valid")),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_deconv

    if k_cls == "SeparableConv2D":
        def load_sep(params, state, w):
            # depthwise (kh, kw, in, mult) -> (kh, kw, 1, in*mult); the
            # C-order reshape maps (c, m) -> channel c*mult + m, matching
            # the grouped convolution's output channel layout
            dk = np.asarray(w[0])
            kh, kw, cin, mult = dk.shape
            _put(params, "dW", dk.reshape(kh, kw, 1, cin * mult))
            _put(params, "pW", w[1])
            if len(w) > 2 and "b" in params:
                _put(params, "b", w[2])
        return SeparableConvolution2D(
            n_out=int(k_cfg["filters"]),
            depth_multiplier=int(k_cfg.get("depth_multiplier", 1)),
            kernel=_pair(k_cfg.get("kernel_size", 3)),
            stride=_pair(k_cfg.get("strides", 1)),
            dilation=_pair(k_cfg.get("dilation_rate", 1)),
            convolution_mode=_padding(k_cfg.get("padding", "valid")),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_sep

    if k_cls == "DepthwiseConv2D":
        def load_dw(params, state, w):
            dk = np.asarray(w[0])
            kh, kw, cin, mult = dk.shape
            _put(params, "W", dk.reshape(kh, kw, 1, cin * mult))
            if len(w) > 1 and "b" in params:
                _put(params, "b", w[1])
        return DepthwiseConvolution2D(
            depth_multiplier=int(k_cfg.get("depth_multiplier", 1)),
            kernel=_pair(k_cfg.get("kernel_size", 3)),
            stride=_pair(k_cfg.get("strides", 1)),
            dilation=_pair(k_cfg.get("dilation_rate", 1)),
            convolution_mode=_padding(k_cfg.get("padding", "valid")),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_dw

    if k_cls == "Cropping2D":
        crop = k_cfg.get("cropping", ((0, 0), (0, 0)))
        if isinstance(crop, int):
            c = (crop, crop, crop, crop)
        else:
            (t, bm), (l, r) = crop
            c = (t, bm, l, r)
        return Cropping2D(cropping=tuple(int(x) for x in c)), None

    if k_cls == "TimeDistributed":
        # unwrap: TimeDistributed(inner) over (B, T, F) == inner applied
        # per step; our sequence-aware mappers already are
        inner = k_cfg["layer"]
        inner_cls = inner.get("class_name")
        inner_cfg = inner.get("config", {})
        return _map_layer(inner_cls, inner_cfg, is_output, sequence=True,
                          output_loss=output_loss)

    def _one(v) -> int:
        """Scalar from a Keras 1D size field (stored scalar or 1-tuple)."""
        return int(v[0] if isinstance(v, (list, tuple)) else v)

    if k_cls == "Loss":
        # KerasLoss.java: a bare training-loss head over the incoming
        # activations (model compiled with a loss but no trailing Dense)
        from deeplearning4j_tpu_torch.nn.layers import LossLayer, RnnLossLayer
        loss = _map_loss(k_cfg.get("loss", "mse"))
        cls = RnnLossLayer if sequence else LossLayer
        return cls(loss=loss), None

    if k_cls in ("AtrousConvolution1D", "Conv1D"):
        # Keras-1 atrous convs are dilated convs under an older name
        # (KerasAtrousConvolution1D.java); keys normalized above
        from deeplearning4j_tpu_torch.nn.layers import Convolution1DLayer
        if k_cfg.get("padding") == "causal":
            raise ValueError("Conv1D: padding='causal' is not mapped "
                             "(pad the input explicitly or use 'same')")

        def load_c1(params, state, w):
            _put(params, "W", w[0])     # (k, in, out) both sides
            if len(w) > 1 and "b" in params:
                _put(params, "b", w[1])
        return Convolution1DLayer(
            n_out=int(k_cfg["filters"]),
            kernel=_one(k_cfg.get("kernel_size", 3)),
            stride=_one(k_cfg.get("strides", 1)),
            dilation=_one(k_cfg.get("dilation_rate", 1)),
            convolution_mode=_padding(k_cfg.get("padding", "valid")),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_c1

    if k_cls in ("MaxPooling1D", "AveragePooling1D"):
        from deeplearning4j_tpu_torch.nn.layers import Subsampling1DLayer
        ps = k_cfg.get("pool_size", 2)
        return Subsampling1DLayer(
            kernel=_one(ps),
            stride=_one(k_cfg.get("strides") or ps),
            pooling_type="max" if k_cls.startswith("Max") else "avg",
            convolution_mode=_padding(k_cfg.get("padding", "valid"))), None

    if k_cls in ("GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return GlobalPoolingLayer(
            pooling_type="avg" if "Average" in k_cls else "max"), None

    if k_cls == "UpSampling2D":
        from deeplearning4j_tpu_torch.nn.layers import Upsampling2D
        if k_cfg.get("interpolation", "nearest") != "nearest":
            raise ValueError("UpSampling2D: only nearest interpolation "
                             "is mapped")
        sz = k_cfg.get("size", 2)
        if isinstance(sz, (list, tuple)):
            sz = tuple(int(x) for x in sz)   # asymmetric (h, w) supported
        else:
            sz = int(sz)
        return Upsampling2D(size=sz), None

    if k_cls in ("LeakyReLU", "ELU", "ReLU", "Softmax"):
        if k_cls == "Softmax" and k_cfg.get("axis", -1) != -1:
            raise ValueError("Softmax: only axis=-1 is mapped")
        name = {"LeakyReLU": "leakyrelu", "ELU": "elu", "ReLU": "relu",
                "Softmax": "softmax"}[k_cls]
        alpha = None
        if k_cls == "LeakyReLU":       # Keras 3: negative_slope; 2: alpha
            alpha = float(k_cfg.get("negative_slope",
                                    k_cfg.get("alpha", 0.3)))
        elif k_cls == "ELU":
            alpha = float(k_cfg.get("alpha", 1.0))
        elif k_cls == "ReLU":
            mv = k_cfg.get("max_value")
            ns = float(k_cfg.get("negative_slope", 0.0) or 0.0)
            thr = float(k_cfg.get("threshold", 0.0) or 0.0)
            if ns or thr:
                raise ValueError("ReLU: negative_slope/threshold variants "
                                 "are not mapped")
            if mv is not None:
                if float(mv) != 6.0:
                    raise ValueError("ReLU: only max_value in (None, 6.0) "
                                     "is mapped")
                name = "relu6"        # MobileNet-family clipped relu
        return ActivationLayer(activation=name, alpha=alpha), None

    if k_cls == "Permute":
        dims = k_cfg.get("dims", (1,))
        return PermuteLayer(dims=tuple(int(d) for d in dims)), None

    if k_cls == "Reshape":
        # KerasReshape.java -> ReshapePreprocessor; layer form here
        from deeplearning4j_tpu_torch.nn.layers import ReshapeLayer
        target = tuple(int(d) for d in k_cfg["target_shape"])
        return ReshapeLayer(target=target), None

    if k_cls in ("LRN", "LocalResponseNormalization"):
        # KerasLRN.java (custom/keras-contrib layer in Keras-2 archives)
        from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization
        return LocalResponseNormalization(
            k=float(k_cfg.get("k", 2.0)), n=int(k_cfg.get("n", 5)),
            alpha=float(k_cfg.get("alpha", 1e-4)),
            beta=float(k_cfg.get("beta", 0.75))), None

    if k_cls == "RepeatVector":
        return RepeatVector(n=int(k_cfg["n"])), None

    if k_cls in ("SpatialDropout1D", "SpatialDropout2D"):
        from deeplearning4j_tpu_torch.nn.regularization import SpatialDropout
        return DropoutLayer(
            dropout=SpatialDropout(p=float(k_cfg.get("rate", 0.5)))), None

    if k_cls == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.regularization import GaussianNoise
        return DropoutLayer(dropout=GaussianNoise(
            stddev=float(k_cfg.get("stddev", 0.1)))), None

    if k_cls == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.regularization import GaussianDropout
        return DropoutLayer(dropout=GaussianDropout(
            rate=float(k_cfg.get("rate", 0.1)))), None

    if k_cls == "AlphaDropout":
        from deeplearning4j_tpu_torch.nn.regularization import AlphaDropout
        return DropoutLayer(dropout=AlphaDropout(
            p=float(k_cfg.get("rate", 0.05)))), None

    if k_cls == "Cropping1D":
        crop = k_cfg.get("cropping", (1, 1))
        if isinstance(crop, int):
            crop = (crop, crop)
        return Cropping1D(cropping=tuple(int(x) for x in crop)), None

    if k_cls == "UpSampling1D":
        return Upsampling1D(size=_one(k_cfg.get("size", 2))), None

    if k_cls == "ZeroPadding1D":
        pad = k_cfg.get("padding", 1)
        if isinstance(pad, int):
            pad = (pad, pad)
        return ZeroPadding1DLayer(padding=tuple(int(x) for x in pad)), None

    if k_cls == "LocallyConnected1D":
        # Keras 2 layer (dropped in Keras 3); implementation 1 storage:
        # kernel (ot, k*c_in, filters), bias (ot, filters) — our layout
        if k_cfg.get("padding", "valid") != "valid":
            raise ValueError("LocallyConnected1D: only padding='valid'")

        def load_lc1(params, state, w):
            _put(params, "W", w[0])
            if len(w) > 1 and "b" in params:
                _put(params, "b", np.asarray(w[1]).reshape(
                    tuple(params["b"].shape)))
        return LocallyConnected1D(
            n_out=int(k_cfg["filters"]),
            kernel=_one(k_cfg.get("kernel_size", 3)),
            stride=_one(k_cfg.get("strides", 1)),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_lc1

    if k_cls == "LocallyConnected2D":
        if k_cfg.get("padding", "valid") != "valid":
            raise ValueError("LocallyConnected2D: only padding='valid'")

        def load_lc2(params, state, w):
            _put(params, "W", w[0])
            if len(w) > 1 and "b" in params:
                _put(params, "b", np.asarray(w[1]).reshape(
                    tuple(params["b"].shape)))
        return LocallyConnected2D(
            n_out=int(k_cfg["filters"]),
            kernel=_pair(k_cfg.get("kernel_size", 3)),
            stride=_pair(k_cfg.get("strides", 1)),
            activation=_act(k_cfg.get("activation", "linear")),
            has_bias=k_cfg.get("use_bias", True)), load_lc2

    raise ValueError(f"Unsupported Keras layer '{k_cls}' "
                     "(KerasModelImport layer mappers)")
