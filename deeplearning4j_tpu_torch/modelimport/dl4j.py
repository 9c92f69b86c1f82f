"""DL4J artifact bridge: read AND write the reference's checkpoint format.

The reference persists trained models as a zip of three entries
(ModelSerializer.java:109-173):

  configuration.json -- MultiLayerConfiguration Jackson JSON
                        (MultiLayerConfiguration.java toJson)
  coefficients.bin   -- Nd4j.write(model.params()) binary: the single flat
                        parameter row-vector (MultiLayerNetwork.params())
  updaterState.bin   -- Nd4j.write(updater.getStateViewArray()) (optional)

This module implements both directions so a DL4J user can carry a trained
artifact across (restore_multilayer_network) and back (save_dl4j_model):

* the ND4J single-array binary codec (BaseDataBuffer.write semantics: each
  buffer = Java-modified-UTF allocation-mode tag, int32 big-endian length,
  UTF dtype name, then big-endian elements; an INDArray is the shape-info
  int buffer followed by the data buffer; shape-info layout
  [rank, *shape, *stride, offset, elementWiseStride, orderChar]);
* the Jackson layer-config tree (Layer.java:55 WRAPPER_OBJECT type names:
  "dense", "convolution", "subsampling", "batchNormalization", "LSTM",
  "output", ...), mapped into this framework's LayerConf dataclasses;
* the flat parameter layout, per the reference param initializers:
    dense/output/embedding: W ('f'-order, nIn x nOut) then b
        (DefaultParamInitializer.java init)
    convolution: b FIRST, then W ('c'-order, [nOut, nIn, kH, kW])
        (ConvolutionParamInitializer.java init / createWeightMatrix)
    batch-norm: gamma, beta, global mean, global var
        (BatchNormalizationParamInitializer.java init)
    LSTM: W_in ('f', nIn x 4H), W_rec ('f', H x 4H), b(4H), gate blocks in
        IFOG order (LSTMParamInitializer.java init + bias comment)
  with the port's layout conversions applied on the way in/out:
    conv  IOhw -> HWIO transpose (the port keeps HWIO kernels and NHWC
          activations, as the JAX package does);
    LSTM  IFOG -> IFGO gate-block permutation (this framework splits
          z into i,f,g,o -- nn/layers/recurrent.py _lstm_scan);
    dense-after-conv row permutation (the reference flattens activations
          NCHW 'c'-order; this framework flattens NHWC).

GravesLSTM is intentionally NOT importable: the reference wires its three
peephole columns to the forget / input-modulation / output gates
(LSTMHelpers.java:235,259,302 -- wFF, wGG, wOO), whereas this framework's
GravesLSTM follows Graves 2013 (peepholes on input/forget/output). The
parameters are not semantically transferable; we refuse loudly rather than
import a silently-different model.

Updater state: MultiLayerUpdater concatenates per-block state views. For the
overwhelmingly common uniform-updater case there is ONE block spanning all
layers, and the per-updater layouts are: Adam/AdaMax/Nadam/AMSGrad
[m(all params), v(all params)], Nesterovs/momentum [trace], AdaGrad
[accumulated sq grads], RmsProp [sq avg], Sgd/NoOp []. m/v/trace views are
shaped exactly like the params, so they undergo the same per-layer layout
conversions, then are copied into the port's optimizer state (nested
dicts in optax's layout, `nn/updaters.py`). A slot the port's state does
not hold (per-layer updaters or frozen layers, whose state is split by
label) raises; it is never left at zero.

The port's counterpart of the JAX package's `modelimport/dl4j.py`:
networks are restored onto `device` (default CUDA, raising without it;
``"cpu"`` for the CPU), and decoded arrays are copied into the
initialized network's tensors in place, in their dtype. Zips are written
deflated, or stored when ``DL4J_CUDA_ZIP_STORED=1`` (as `save_model`).
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.base import InputType, Kind
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.util.platform import DeviceLike
from deeplearning4j_tpu_torch.util.serialization import zip_compression


def _np(v) -> np.ndarray:
    """A tensor (on any device) or array as an f32 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)

# ======================================================================
# ND4J binary array codec
# ======================================================================

_DTYPES = {"FLOAT": (">f4", 4), "DOUBLE": (">f8", 8),
           "INT": (">i4", 4), "LONG": (">i8", 8), "HALF": (">f2", 2)}


def _write_java_utf(f, s: str) -> None:
    b = s.encode("utf-8")           # ASCII names only -> modified UTF == UTF-8
    f.write(struct.pack(">H", len(b)))
    f.write(b)


def _read_java_utf(f) -> str:
    (n,) = struct.unpack(">H", f.read(2))
    return f.read(n).decode("utf-8")


def _write_buffer(f, arr: np.ndarray, dtype_name: str) -> None:
    _write_java_utf(f, "DIRECT")                 # allocation mode tag
    flat = np.ascontiguousarray(arr).ravel()
    f.write(struct.pack(">i", flat.size))
    _write_java_utf(f, dtype_name)
    f.write(flat.astype(_DTYPES[dtype_name][0]).tobytes())


def _read_buffer(f) -> np.ndarray:
    _read_java_utf(f)                            # allocation mode; ignored
    (length,) = struct.unpack(">i", f.read(4))
    dtype_name = _read_java_utf(f)
    if dtype_name == "COMPRESSED":
        raise ValueError("compressed ND4J buffers are not supported")
    np_dt, size = _DTYPES[dtype_name]
    return np.frombuffer(f.read(length * size), dtype=np_dt).copy()


def write_nd4j_array(f, arr: np.ndarray) -> None:
    """Serialize `arr` in the Nd4j.write(INDArray, DataOutputStream) format
    (shape-info int buffer, then the data buffer). Data is written f32,
    c-order, matching DL4J's default float dtype."""
    arr = np.asarray(arr)
    if arr.ndim == 1:               # DL4J params() is a [1, N] row vector
        arr = arr.reshape(1, -1)
    rank = arr.ndim
    shape = list(arr.shape)
    strides = []                    # c-order element strides
    acc = 1
    for d in reversed(shape):
        strides.insert(0, acc)
        acc *= d
    shape_info = np.array([rank] + shape + strides + [0, 1, ord("c")],
                          dtype=np.int32)
    _write_buffer(f, shape_info, "INT")
    _write_buffer(f, arr, "FLOAT")


def read_nd4j_array(f) -> np.ndarray:
    """Inverse of write_nd4j_array (Nd4j.read semantics). Handles c- and
    f-ordered source arrays via the shape-info order char."""
    shape_info = _read_buffer(f)
    rank = int(shape_info[0])
    shape = [int(x) for x in shape_info[1:1 + rank]]
    order = chr(int(shape_info[2 * rank + 3])) if rank else "c"
    data = _read_buffer(f)
    n = int(np.prod(shape)) if shape else data.size
    arr = data[:n].astype(np.float32) if data.dtype.kind == "f" else data[:n]
    return arr.reshape(shape, order=order if order in ("c", "f") else "c")


# ======================================================================
# Jackson <-> LayerConf maps
# ======================================================================

_ACT_FROM = {
    "ActivationReLU": "relu", "ActivationReLU6": "relu6",
    "ActivationIdentity": "identity", "ActivationTanH": "tanh",
    "ActivationSigmoid": "sigmoid", "ActivationSoftmax": "softmax",
    "ActivationLReLU": "leakyrelu", "ActivationELU": "elu",
    "ActivationSELU": "selu", "ActivationSoftPlus": "softplus",
    "ActivationSoftSign": "softsign", "ActivationHardSigmoid": "hardsigmoid",
    "ActivationHardTanH": "hardtanh", "ActivationCube": "cube",
    "ActivationRationalTanh": "rationaltanh",
    "ActivationRectifiedTanh": "rectifiedtanh", "ActivationSwish": "swish",
    "ActivationGELU": "gelu",
    "ActivationThresholdedReLU": "thresholdedrelu",
}
_ACT_TO = {v: k for k, v in _ACT_FROM.items()}
_ACT_TO["linear"] = "ActivationIdentity"

_LOSS_FROM = {
    "LossMCXENT": "mcxent", "LossMSE": "mse", "LossMAE": "mae",
    "LossL2": "mse", "LossL1": "mae",
    "LossBinaryXENT": "binary_crossentropy",
    "LossNegativeLogLikelihood": "negativeloglikelihood",
    "LossKLD": "kl_divergence", "LossPoisson": "poisson",
    "LossCosineProximity": "cosine_proximity", "LossHinge": "hinge",
    "LossSquaredHinge": "squared_hinge",
}
_LOSS_TO = {"mcxent": "LossMCXENT", "mse": "LossMSE", "mae": "LossMAE",
            "binary_crossentropy": "LossBinaryXENT",
            "xent": "LossBinaryXENT",
            "negativeloglikelihood": "LossNegativeLogLikelihood",
            "kl_divergence": "LossKLD", "poisson": "LossPoisson",
            "cosine_proximity": "LossCosineProximity", "hinge": "LossHinge",
            "squared_hinge": "LossSquaredHinge"}


def _act_from(d: Any, default: str = "identity") -> str:
    """activationFn {"@class": ...} (or legacy "activationFunction" string)."""
    if d is None:
        return default
    if isinstance(d, str):                       # pre-0.8 legacy string form
        return d.lower()
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    if cls in _ACT_FROM:
        return _ACT_FROM[cls]
    raise ValueError(f"unsupported DL4J activation: {cls}")


def _act_to(name: str) -> dict:
    if name not in _ACT_TO:
        raise ValueError(f"activation {name!r} has no DL4J class mapping")
    return {"@class": "org.nd4j.linalg.activations.impl." + _ACT_TO[name]}


def _loss_from(d: Any) -> str:
    if d is None:
        return "mcxent"
    if isinstance(d, str):
        key = d.upper()
        legacy = {"MCXENT": "mcxent", "MSE": "mse",
                  "NEGATIVELOGLIKELIHOOD": "negativeloglikelihood",
                  "XENT": "binary_crossentropy"}
        if key in legacy:
            return legacy[key]
        raise ValueError(f"unsupported DL4J loss: {d}")
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    if cls in _LOSS_FROM:
        return _LOSS_FROM[cls]
    raise ValueError(f"unsupported DL4J loss: {cls}")


def _loss_to(name: str) -> dict:
    if name not in _LOSS_TO:
        raise ValueError(f"loss {name!r} has no DL4J class mapping")
    return {"@class": "org.nd4j.linalg.lossfunctions.impl." + _LOSS_TO[name]}


def _layer_updater(body: dict):
    """Updater from a layer JSON body — modern `iUpdater` object, or the
    pre-0.9 legacy form (`"updater": "ADAM"` enum plus flat learningRate/
    momentum/rho/rmsDecay/adamMeanDecay/adamVarDecay fields), which the
    reference migrates in BaseNetConfigDeserializer.java
    handleUpdaterBackwardCompatibility. Returns None when neither is
    present."""
    iupd = body.get("iUpdater")
    if iupd is not None:
        return _updater_from(iupd)
    name = body.get("updater")
    if not isinstance(name, str):
        return None
    raw_lr = body.get("learningRate")
    # None-only fallback: an explicit 0.0 (deliberate no-step) must survive
    lr = 1e-1 if raw_lr is None else float(raw_lr)
    eps = body.get("epsilon")

    def _eps(default):
        return default if eps is None else float(eps)

    name = name.upper()
    if name == "SGD":
        return upd.Sgd(lr)
    if name in ("ADAM", "ADAMAX", "NADAM"):
        cls = {"ADAM": upd.Adam, "ADAMAX": upd.AdaMax,
               "NADAM": upd.Nadam}[name]
        return cls(lr, beta1=float(body.get("adamMeanDecay", 0.9)),
                   beta2=float(body.get("adamVarDecay", 0.999)),
                   epsilon=_eps(1e-8))
    if name == "NESTEROVS":
        return upd.Nesterovs(lr, momentum=float(body.get("momentum", 0.9)))
    if name == "ADAGRAD":
        return upd.AdaGrad(lr, epsilon=_eps(1e-6))
    if name == "RMSPROP":
        return upd.RmsProp(lr, decay=float(body.get("rmsDecay", 0.95)),
                           epsilon=_eps(1e-8))
    if name == "ADADELTA":
        return upd.AdaDelta(rho=float(body.get("rho", 0.95)),
                            epsilon=_eps(1e-6))
    if name == "NONE":
        return upd.NoOp()
    # reference handleUpdaterBackwardCompatibility leaves unmappable
    # legacy updaters null and still loads the model — match that
    import logging
    logging.getLogger("deeplearning4j_tpu_torch").warning(
        "unmappable legacy updater enum %r; importing with the default "
        "updater (parameters are unaffected)", name)
    return None


def _updater_from(d: Any) -> upd.Updater:
    """iUpdater {"@class": "org.nd4j.linalg.learning.config.X", ...}."""
    if d is None:
        return upd.Sgd(1e-2)
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    lr = float(d.get("learningRate", 1e-3))
    if cls == "Sgd":
        return upd.Sgd(lr)
    if cls == "Adam":
        return upd.Adam(lr, beta1=float(d.get("beta1", 0.9)),
                        beta2=float(d.get("beta2", 0.999)),
                        epsilon=float(d.get("epsilon", 1e-8)))
    if cls == "AdaMax":
        return upd.AdaMax(lr, beta1=float(d.get("beta1", 0.9)),
                          beta2=float(d.get("beta2", 0.999)))
    if cls == "Nadam":
        return upd.Nadam(lr, beta1=float(d.get("beta1", 0.9)),
                         beta2=float(d.get("beta2", 0.999)))
    if cls == "Nesterovs":
        return upd.Nesterovs(lr, momentum=float(d.get("momentum", 0.9)))
    if cls == "AdaGrad":
        return upd.AdaGrad(lr)
    if cls == "RmsProp":
        return upd.RmsProp(lr, decay=float(d.get("rmsDecay", 0.95)),
                           epsilon=float(d.get("epsilon", 1e-8)))
    if cls == "AdaDelta":
        return upd.AdaDelta(rho=float(d.get("rho", 0.95)),
                            epsilon=float(d.get("epsilon", 1e-6)))
    if cls == "NoOp":
        return upd.NoOp()
    raise ValueError(f"unsupported DL4J updater: {cls}")


def _updater_to(u: upd.Updater) -> dict:
    base = "org.nd4j.linalg.learning.config."
    name = type(u).__name__
    if name == "Sgd":
        return {"@class": base + "Sgd", "learningRate": u.learning_rate}
    if name in ("Adam", "AdaMax", "Nadam"):
        return {"@class": base + name, "learningRate": u.learning_rate,
                "beta1": u.beta1, "beta2": u.beta2,
                "epsilon": getattr(u, "epsilon", 1e-8)}
    if name == "Nesterovs":
        return {"@class": base + "Nesterovs", "learningRate": u.learning_rate,
                "momentum": u.momentum}
    if name == "AdaGrad":
        return {"@class": base + "AdaGrad", "learningRate": u.learning_rate}
    if name == "RmsProp":
        return {"@class": base + "RmsProp", "learningRate": u.learning_rate,
                "rmsDecay": u.decay, "epsilon": u.epsilon}
    if name == "AdaDelta":
        return {"@class": base + "AdaDelta", "rho": u.rho,
                "epsilon": u.epsilon}
    if name == "NoOp":
        return {"@class": base + "NoOp"}
    raise ValueError(f"updater {name} has no DL4J class mapping")


# ======================================================================
# Layer conf parsing (import direction)
# ======================================================================

class UnsupportedLayerError(ValueError):
    pass


def _pair(v, default) -> Tuple[int, int]:
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    return (int(v[0]), int(v[1]))


def _dropout_from(d: Any) -> float:
    """iDropout {"@class": "...dropout.Dropout", "p": retainProb} -> this
    framework's DROP probability (DL4J's p is the RETAIN probability —
    Dropout.java applyDropout keeps activations with prob p)."""
    if not d:
        return 0.0
    cls = d.get("@class", "").rsplit(".", 1)[-1]
    if cls != "Dropout":
        raise UnsupportedLayerError(
            f"unsupported iDropout variant {cls!r} (only standard Dropout "
            "imports; re-export without AlphaDropout/GaussianDropout)")
    return 1.0 - float(d.get("p", 1.0))


def _apply_common(layers, d: dict):
    """Overlay the regularization config (input dropout, l1/l2) onto the
    layer that carries the parameters — silently dropping it would resume
    training under different regularization than the artifact was trained
    with."""
    if d.get("iDropout") is not None:
        drop = _dropout_from(d["iDropout"])
    else:
        # pre-0.9 legacy flat field: dropOut = RETAIN probability (0 =
        # dropout off, matching the reference's legacy migration)
        legacy = float(d.get("dropOut", 0.0) or 0.0)
        drop = 1.0 - legacy if legacy > 0.0 else 0.0
    l1 = float(d.get("l1", 0.0) or 0.0)
    l2 = float(d.get("l2", 0.0) or 0.0)
    if drop or l1 or l2:
        layers = list(layers)
        layers[-1] = dataclasses.replace(layers[-1], dropout=drop,
                                         l1=l1, l2=l2)
    return layers


def _parse_layer(kind: str, d: dict):
    """One DL4J layer JSON -> list of our LayerConfs (padding may expand to
    [ZeroPaddingLayer, Conv]; parameters always belong to the LAST conf in
    the list)."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
        DropoutLayer, EmbeddingLayer, GlobalPoolingLayer, LossLayer, LSTM,
        OutputLayer, RnnOutputLayer, SubsamplingLayer, Upsampling2D,
        ZeroPaddingLayer,
    )
    raw_act = d.get("activationFn", d.get("activationFunction"))
    act = _act_from(raw_act)
    # default activations apply ONLY when the JSON omits the field — an
    # explicit ActivationIdentity on an output head (the standard DL4J
    # regression pattern, Identity + LossMSE) must survive as identity
    head_act = "softmax" if raw_act is None else act
    lstm_act = "tanh" if raw_act is None else act
    nin = int(d.get("nin", 0) or 0)
    nout = int(d.get("nout", 0) or 0)
    has_bias = bool(d.get("hasBias", True))
    name = d.get("layerName")

    if kind == "dense":
        return [DenseLayer(name=name, n_in=nin or None, n_out=nout,
                           activation=act, has_bias=has_bias)]
    if kind == "ElementWiseMult":
        from deeplearning4j_tpu_torch.nn.layers import ElementWiseMultiplicationLayer
        return [ElementWiseMultiplicationLayer(
            name=name, n_in=nin or None, n_out=nout, activation=act)]
    if kind == "embedding":
        return [EmbeddingLayer(name=name, n_in=nin or None, n_out=nout,
                               has_bias=has_bias)]
    if kind == "output":
        return [OutputLayer(name=name, n_in=nin or None, n_out=nout,
                            activation=head_act,
                            loss=_loss_from(d.get("lossFn", d.get("lossFunction"))),
                            has_bias=has_bias)]
    if kind == "rnnoutput":
        return [RnnOutputLayer(name=name, n_in=nin or None, n_out=nout,
                               activation=head_act,
                               loss=_loss_from(d.get("lossFn", d.get("lossFunction"))),
                               )]
    if kind == "loss":
        return [LossLayer(name=name, activation=act,
                          loss=_loss_from(d.get("lossFn", d.get("lossFunction"))))]
    if kind == "activation":
        return [ActivationLayer(name=name, activation=act)]
    if kind == "dropout":
        return [DropoutLayer(name=name)]
    if kind in ("convolution", "subsampling"):
        kernel = _pair(d.get("kernelSize"), (3, 3) if kind == "convolution" else (2, 2))
        stride = _pair(d.get("stride"), (1, 1) if kind == "convolution" else (2, 2))
        pad = _pair(d.get("padding"), (0, 0))
        mode = (d.get("convolutionMode") or "Truncate").lower()
        out: List[Any] = []
        if pad != (0, 0) and mode != "same":
            out.append(ZeroPaddingLayer(
                padding=(pad[0], pad[0], pad[1], pad[1])))
        if kind == "convolution":
            out.append(ConvolutionLayer(
                name=name, n_in=nin or None, n_out=nout, kernel=kernel,
                stride=stride, dilation=_pair(d.get("dilation"), (1, 1)),
                convolution_mode=mode, activation=act, has_bias=has_bias))
        else:
            ptype = (d.get("poolingType") or "MAX").lower()
            out.append(SubsamplingLayer(
                name=name, kernel=kernel, stride=stride, pooling_type=ptype,
                convolution_mode=mode, pnorm=int(d.get("pnorm", 2) or 2)))
        return out
    if kind == "batchNormalization":
        return [BatchNormalization(
            name=name, epsilon=float(d.get("eps", 1e-5)),
            decay=float(d.get("decay", 0.9)),
            gamma_init=float(d.get("gamma", 1.0)),
            beta_init=float(d.get("beta", 0.0)),
            lock_gamma_beta=bool(d.get("lockGammaBeta", False)))]
    if kind == "LSTM":
        return [LSTM(name=name, n_in=nin or None, n_out=nout,
                     activation=lstm_act,
                     gate_activation=_act_from(
                         d.get("gateActivationFn"), "sigmoid"),
                     forget_gate_bias_init=float(
                         d.get("forgetGateBiasInit", 1.0)))]
    if kind == "localResponseNormalization":
        from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization
        return [LocalResponseNormalization(
            name=name, k=float(d.get("k", 2.0)), n=int(d.get("n", 5)),
            alpha=float(d.get("alpha", 1e-4)),
            beta=float(d.get("beta", 0.75)))]
    if kind == "CenterLossOutputLayer":
        from deeplearning4j_tpu_torch.nn.layers import CenterLossOutputLayer
        return [CenterLossOutputLayer(
            name=name, n_in=nin or None, n_out=nout,
            activation=head_act,
            loss=_loss_from(d.get("lossFn", d.get("lossFunction"))),
            alpha=float(d.get("alpha", 0.05)),
            lambda_=float(d.get("lambda", 2e-4)))]
    if kind == "Bidirectional":
        from deeplearning4j_tpu_torch.nn.layers import Bidirectional
        fwd_wrap = d.get("fwd")
        if not fwd_wrap:
            raise UnsupportedLayerError("Bidirectional JSON missing 'fwd'")
        (ikind, ibody), = fwd_wrap.items()
        inner = _apply_common(_parse_layer(ikind, ibody), ibody)
        if len(inner) != 1:
            raise UnsupportedLayerError(
                "Bidirectional wrapping a multi-layer expansion is not "
                "importable")
        mode = {"CONCAT": "concat", "ADD": "add", "MUL": "mul",
                "AVERAGE": "ave"}.get((d.get("mode") or "CONCAT").upper())
        if mode is None:
            raise UnsupportedLayerError(
                f"unknown Bidirectional mode {d.get('mode')!r}")
        return [Bidirectional(name=name, layer=inner[0], mode=mode)]
    if kind == "gravesLSTM":
        raise UnsupportedLayerError(
            "GravesLSTM peephole parameters are not transferable: the "
            "reference wires wFF/wGG/wOO to the forget/input-modulation/"
            "output gates (LSTMHelpers.java:235,259,302) while this "
            "framework follows Graves 2013 (input/forget/output). "
            "Re-export the model with plain LSTM layers.")
    if kind == "GlobalPooling":
        ptype = (d.get("poolingType") or "MAX").lower()
        return [GlobalPoolingLayer(name=name, pooling_type=ptype,
                                   pnorm=int(d.get("pnorm", 2) or 2))]
    if kind == "zeroPadding":
        p = d.get("padding") or [0, 0, 0, 0]
        if len(p) == 2:
            p = [p[0], p[0], p[1], p[1]]
        return [ZeroPaddingLayer(name=name, padding=tuple(int(x) for x in p))]
    if kind == "Upsampling2D":
        return [Upsampling2D(name=name, size=_pair(d.get("size"), (2, 2)))]
    raise UnsupportedLayerError(f"unsupported DL4J layer type: {kind!r}")


# ======================================================================
# Flat-vector <-> param-tree conversion
# ======================================================================

def _nchw_to_nhwc_perm(h: int, w: int, c: int) -> np.ndarray:
    """Row permutation for dense weights after a conv->ff flatten boundary:
    perm[i_nhwc] = i_nchw for the same (h, w, c) position, so
    W_ours = W_dl4j[perm]. (CnnToFeedForwardPreProcessor flattens 'c'-order
    NCHW; this framework flattens NHWC.)"""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def _ifog_to_ifgo(mat: np.ndarray, H: int, axis: int) -> np.ndarray:
    """Swap the O and G gate blocks along `axis` (reference IFOG order ->
    this framework's i,f,g,o split order)."""
    idx = np.concatenate([np.arange(0, 2 * H),            # i, f
                          np.arange(3 * H, 4 * H),        # g  (ref block 4)
                          np.arange(2 * H, 3 * H)])       # o  (ref block 3)
    return np.take(mat, idx, axis=axis)


def _layer_num_params(layer, in_type: InputType) -> int:
    cls = type(layer).__name__
    if cls in ("DenseLayer", "OutputLayer", "RnnOutputLayer", "EmbeddingLayer"):
        nin = layer.n_in or in_type.features
        return nin * layer.n_out + (layer.n_out if layer.has_bias else 0)
    if cls == "ElementWiseMultiplicationLayer":
        return 2 * (layer.n_out or in_type.features)
    if cls == "ConvolutionLayer":
        nin = layer.n_in or in_type.shape[2]
        kh, kw = layer.kernel
        return nin * layer.n_out * kh * kw + (layer.n_out if layer.has_bias else 0)
    if cls == "BatchNormalization":
        n = in_type.features
        return (2 * n if not layer.lock_gamma_beta else 0) + 2 * n
    if cls == "LSTM":
        nin = layer.n_in or in_type.features
        H = layer.n_out
        return nin * 4 * H + H * 4 * H + 4 * H
    if cls == "Bidirectional":
        return 2 * _layer_num_params(layer.layer, in_type)
    if cls == "CenterLossOutputLayer":
        nin = layer.n_in or in_type.features
        # CenterLossParamInitializer: W + b + centers (nOut x nIn)
        return nin * layer.n_out + layer.n_out + layer.n_out * nin
    return 0


def _decode_layer_params(layer, in_type: InputType, seg: np.ndarray,
                         raw_in: Optional[InputType] = None):
    """One reference flat segment -> (params dict, state dict) in this
    framework's layout. Inverse of _encode_layer_params. `in_type` is the
    post-preprocessor input type (what the layer actually sees); `raw_in`
    the pre-preprocessor one — a CNN raw_in on an FF layer marks the
    flatten boundary where the reference's NCHW 'c'-order row layout needs
    the NHWC permutation."""
    cls = type(layer).__name__
    if cls in ("DenseLayer", "OutputLayer", "RnnOutputLayer", "EmbeddingLayer"):
        nin = layer.n_in or in_type.features
        nout = layer.n_out
        W = seg[:nin * nout].reshape((nin, nout), order="F")
        if (raw_in is not None and raw_in.kind == Kind.CNN
                and cls != "EmbeddingLayer"):
            h, w, c = raw_in.shape
            W = W[_nchw_to_nhwc_perm(h, w, c)]
        params = {"W": W}
        if layer.has_bias:
            params["b"] = seg[nin * nout:nin * nout + nout]
        return params, {}
    if cls == "ElementWiseMultiplicationLayer":
        n = layer.n_out or in_type.features
        return {"W": seg[:n], "b": seg[n:2 * n]}, {}
    if cls == "ConvolutionLayer":
        nin = layer.n_in or in_type.shape[2]
        nout = layer.n_out
        kh, kw = layer.kernel
        off = 0
        params = {}
        if layer.has_bias:
            params["b"] = seg[:nout]
            off = nout
        W = seg[off:off + nout * nin * kh * kw].reshape(
            (nout, nin, kh, kw), order="C")          # 'c'-order per reference
        params["W"] = W.transpose(2, 3, 1, 0)        # OIhw -> HWIO
        return params, {}
    if cls == "BatchNormalization":
        n = in_type.features
        params = {}
        off = 0
        if not layer.lock_gamma_beta:
            params = {"gamma": seg[:n], "beta": seg[n:2 * n]}
            off = 2 * n
        state = {"mean": seg[off:off + n], "var": seg[off + n:off + 2 * n]}
        return params, state
    if cls == "LSTM":
        nin = layer.n_in or in_type.features
        H = layer.n_out
        nw, nr = nin * 4 * H, H * 4 * H
        W = seg[:nw].reshape((nin, 4 * H), order="F")
        R = seg[nw:nw + nr].reshape((H, 4 * H), order="F")
        b = seg[nw + nr:nw + nr + 4 * H]
        return {"W": _ifog_to_ifgo(W, H, 1),
                "R": _ifog_to_ifgo(R, H, 1),
                "b": _ifog_to_ifgo(b, H, 0)}, {}
    if cls == "CenterLossOutputLayer":
        nin = layer.n_in or in_type.features
        nout = layer.n_out
        W = seg[:nin * nout].reshape((nin, nout), order="F")
        b = seg[nin * nout:nin * nout + nout]
        centers = seg[nin * nout + nout:].reshape((nout, nin), order="C")
        return {"W": W, "b": b, "cL": centers}, {}
    if cls == "Bidirectional":
        # BidirectionalParamInitializer.java:92-93 — [fwd flat | bwd flat]
        n = _layer_num_params(layer.layer, in_type)
        fwd, _ = _decode_layer_params(layer.layer, in_type, seg[:n], raw_in)
        bwd, _ = _decode_layer_params(layer.layer, in_type, seg[n:2 * n],
                                      raw_in)
        return {"fwd": fwd, "bwd": bwd}, {}
    return {}, {}


def _encode_layer_params(layer, in_type: InputType, params: dict,
                         state: dict,
                         raw_in: Optional[InputType] = None) -> np.ndarray:
    """This framework's per-layer params -> the reference flat segment."""
    cls = type(layer).__name__
    if cls == "Bidirectional":
        # nested fwd/bwd subtrees (BidirectionalParamInitializer.java:92-93
        # layout [fwd flat | bwd flat]); must recurse before the flat
        # leaf conversion below
        return np.concatenate([
            _encode_layer_params(layer.layer, in_type, params["fwd"], {},
                                 raw_in),
            _encode_layer_params(layer.layer, in_type, params["bwd"], {},
                                 raw_in)])
    P = {k: _np(v) for k, v in (params or {}).items()}
    S = {k: _np(v) for k, v in (state or {}).items()}
    if cls in ("DenseLayer", "OutputLayer", "RnnOutputLayer", "EmbeddingLayer"):
        W = P["W"]
        if (raw_in is not None and raw_in.kind == Kind.CNN
                and cls != "EmbeddingLayer"):
            h, w, c = raw_in.shape
            inv = np.empty_like(perm := _nchw_to_nhwc_perm(h, w, c))
            inv[perm] = np.arange(perm.size)
            W = W[inv]
        out = [W.ravel(order="F")]
        if layer.has_bias:
            out.append(P["b"].ravel())
        return np.concatenate(out)
    if cls == "ElementWiseMultiplicationLayer":
        return np.concatenate([P["W"].ravel(), P["b"].ravel()])
    if cls == "ConvolutionLayer":
        out = []
        if layer.has_bias:
            out.append(P["b"].ravel())
        out.append(P["W"].transpose(3, 2, 0, 1).ravel(order="C"))
        return np.concatenate(out)
    if cls == "BatchNormalization":
        out = []
        if not layer.lock_gamma_beta:
            out += [P["gamma"].ravel(), P["beta"].ravel()]
        out += [S["mean"].ravel(), S["var"].ravel()]
        return np.concatenate(out)
    if cls == "CenterLossOutputLayer":
        return np.concatenate([P["W"].ravel(order="F"), P["b"].ravel(),
                               P["cL"].ravel(order="C")])
    if cls == "LSTM":
        H = layer.n_out
        # inverse of IFOG->IFGO is IFGO->IFOG: swap blocks back
        idx = np.concatenate([np.arange(0, 2 * H), np.arange(3 * H, 4 * H),
                              np.arange(2 * H, 3 * H)])
        return np.concatenate([
            np.take(P["W"], idx, 1).ravel(order="F"),
            np.take(P["R"], idx, 1).ravel(order="F"),
            np.take(P["b"], idx, 0).ravel()])
    return np.zeros((0,), np.float32)


# ======================================================================
# Import: restore_multilayer_network
# ======================================================================

def parse_dl4j_conf(conf_json: str):
    """Reference MultiLayerConfiguration JSON -> (our MultiLayerConfiguration,
    dl4j_to_ours: list mapping each reference layer index to the index of the
    OUR layer that carries its parameters)."""
    d = json.loads(conf_json)
    if "confs" not in d:
        raise ValueError(
            "not a MultiLayerConfiguration (ComputationGraph import is not "
            "supported; 'confs' entry missing)")
    our_layers: List[Any] = []
    owner: List[int] = []
    seed = 0
    updater = None
    for conf in d["confs"]:
        seed = int(conf.get("seed", seed) or 0)
        (kind, body), = conf["layer"].items()
        if updater is None:
            updater = _layer_updater(body)
        expansion = _apply_common(_parse_layer(kind, body), body)
        our_layers.extend(expansion)
        owner.append(len(our_layers) - 1)
    bp = (d.get("backpropType") or "Standard")
    ours = MultiLayerConfiguration(
        layers=tuple(our_layers), seed=seed,
        updater=updater or upd.Sgd(1e-2),
        backprop_type="tbptt" if bp == "TruncatedBPTT" else "standard",
        tbptt_fwd_length=int(d.get("tbpttFwdLength", 20) or 20),
        tbptt_back_length=int(d.get("tbpttBackLength", 20) or 20),
    )
    return ours, owner


def _infer_input_type(d_conf: dict, our_layers) -> Optional[InputType]:
    """Best-effort input-type recovery. FF nets: feed_forward(nin of first
    parameterized layer). CNN/RNN inputs generally need the caller to pass
    input_type= (the reference JSON does not store the input H/W/T)."""
    first = our_layers[0]
    cls = type(first).__name__
    if cls in ("DenseLayer", "OutputLayer", "EmbeddingLayer") and first.n_in:
        return InputType.feed_forward(first.n_in)
    # FeedForwardToCnnPreProcessor at index 0 records the image dims
    pre = (d_conf.get("inputPreProcessors") or {}).get("0")
    if pre and "FeedForwardToCnn" in pre.get("@class", ""):
        return InputType.convolutional(int(pre["inputHeight"]),
                                       int(pre["inputWidth"]),
                                       int(pre["numChannels"]))
    return None


def restore_multilayer_network(path, load_updater: bool = True,
                               input_type: Optional[InputType] = None,
                               device: DeviceLike = None):
    """Load a reference-produced model zip (ModelSerializer.writeModel
    output) into a ready-to-run MultiLayerNetwork on `device` (default
    CUDA; raises without it).

    `input_type` is required for convolutional/recurrent inputs (the
    reference JSON does not persist the input image/sequence dims unless a
    FeedForwardToCnnPreProcessor is present)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        conf_json = zf.read("configuration.json").decode("utf-8")
        coeffs = (read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
                  if "coefficients.bin" in names else None)
        updater_state = (read_nd4j_array(io.BytesIO(zf.read("updaterState.bin")))
                         if "updaterState.bin" in names and load_updater
                         else None)

    conf, owner = parse_dl4j_conf(conf_json)
    if input_type is None:
        input_type = _infer_input_type(json.loads(conf_json), conf.layers)
    if input_type is None:
        raise ValueError(
            "cannot infer the network input type from the configuration; "
            "pass input_type=InputType.convolutional(h, w, c) / "
            ".recurrent(features, timesteps) / .feed_forward(n)")
    conf = dataclasses.replace(conf, input_type=input_type)
    net = MultiLayerNetwork(conf, device=device).init()

    if coeffs is not None:
        flat = np.asarray(coeffs, np.float32).ravel()
        _load_flat(net, owner, flat)
        if updater_state is not None:
            _load_updater_state(net, owner,
                                np.asarray(updater_state, np.float32).ravel())
    return net


def _segments(net, owner):
    """Yield (our_layer_index, layer, post_type, raw_type, size) in
    reference layer order, for every parameterized reference layer.
    post_type = net._input_types[i] (after auto preprocessing); raw_type =
    the previous layer's raw output type, which still knows the CNN shape
    at a flatten boundary."""
    raw_types = []
    cur_raw = net.conf.input_type
    for i, layer in enumerate(net.layers):
        raw_types.append(cur_raw)
        cur_raw = layer.output_type(net._input_types[i])
    for our_i in owner:
        layer = net.layers[our_i]
        in_type = net._input_types[our_i]
        size = _layer_num_params(layer, in_type)
        if size:
            yield our_i, layer, in_type, raw_types[our_i], size


def _load_flat(net, owner, flat: np.ndarray) -> None:
    offset = 0
    for our_i, layer, in_type, raw_in, size in _segments(net, owner):
        seg = flat[offset:offset + size]
        if seg.size != size:
            raise ValueError(
                f"coefficients.bin too short: layer {our_i} "
                f"({type(layer).__name__}) wants {size} params at offset "
                f"{offset}, got {seg.size}")
        params, state = _decode_layer_params(layer, in_type, seg, raw_in)
        _graft(net, our_i, params, state)
        offset += size
    if offset != flat.size:
        raise ValueError(f"coefficients.bin length mismatch: consumed "
                         f"{offset} of {flat.size} values")


def _graft_tree(dst: dict, src: dict) -> None:
    """Recursively copy decoded arrays into a (possibly nested) tree of
    the network's tensors, in place, in their dtype and on their device —
    Bidirectional wraps its inner layer's params under fwd/bwd."""
    with torch.no_grad():
        for k, v in src.items():
            if isinstance(v, dict):
                _graft_tree(dst[k], v)
            else:
                t = dst[k]
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(v, np.float32).reshape(tuple(t.shape)))))


def _graft(net, our_i, params: dict, state: dict) -> None:
    key = str(our_i)
    _graft_tree(net.params[key], params)
    _graft_tree(net.state[key], state)
    net._drop_graphs()


#: the optimizer-state fields holding each updater's slots, in the
#: reference's state-view order (nd4j AdamUpdater [m | v], AMSGrad
#: [m | v | vHat], AdaDelta [msg | msdx] -> e_g / e_x, ...)
_SLOT_FIELDS = {"Adam": ("mu", "nu"), "AdamW": ("mu", "nu"),
                "AMSGrad": ("mu", "nu", "nu_max"), "Nadam": ("mu", "nu"),
                "AdaMax": ("mu", "nu"), "Nesterovs": ("trace",),
                "Momentum": ("trace",), "AdaGrad": ("sum_of_squares",),
                "RmsProp": ("nu",), "AdaDelta": ("e_g", "e_x"),
                "Sgd": (), "NoOp": ()}


def _updater_state_slots(u: upd.Updater) -> int:
    return len(_SLOT_FIELDS.get(type(u).__name__, ()))


def _slot_holder(net, fields) -> dict:
    """The one state dict of the network's optimizer state that holds
    `fields` (the updater's transformation inside the chain, clipping
    stages around it). Raises when the state is split by label
    (per-layer updaters, frozen layers) or holds no such dict."""
    state = net.opt_state
    if isinstance(state, dict) and "inner_states" in state:
        raise ValueError(
            "updaterState.bin maps onto one uniform updater; this network's "
            "optimizer state is split by layer (per-layer updaters or "
            "frozen layers), so its slots cannot be mapped")
    found = []

    def walk(node):
        if not isinstance(node, dict):
            return
        if all(f in node for f in fields):
            found.append(node)
            return
        for v in node.values():
            walk(v)
    walk(state)
    if len(found) != 1:
        raise ValueError(
            f"the optimizer state of {type(net.conf.updater).__name__} "
            f"holds {len(found)} states with the fields {fields}; "
            "updaterState.bin cannot be mapped onto it")
    return found[0]


def _graft_updater_state(net, segments, flat: np.ndarray) -> None:
    """Copy the reference updater state view into the port's optimizer
    state. `segments` is a list of (key, layer, post_type, raw_type, size)
    — the flat-order contract for either container (layer index keys for
    MultiLayerNetwork, vertex names for ComputationGraph). Assumes the
    uniform-updater single-block layout (see module docstring); a view
    of another length is skipped with a warning, as the reference skips
    it, and a slot the port's state does not hold raises."""
    import logging

    u = net.conf.updater
    fields = _SLOT_FIELDS.get(type(u).__name__, ())
    slots = len(fields)
    n = sum(size for *_x, size in segments)
    if slots == 0 or flat.size != slots * n:
        if flat.size:
            logging.getLogger("deeplearning4j_tpu_torch").warning(
                "updaterState.bin length %d does not match the uniform "
                "%s layout (%d slots x %d params); skipping updater import",
                flat.size, type(u).__name__, slots, n)
        return
    holder = _slot_holder(net, fields)

    def _shape_like(src: dict, tmpl: dict) -> dict:
        """Recursively align decoded arrays to the param template — nested
        for wrapper layers (Bidirectional fwd/bwd); drops keys the template
        lacks (BN mean/var are layer state, not trained parameters)."""
        out = {}
        for k, v in src.items():
            if k not in tmpl:
                continue
            out[k] = _shape_like(v, tmpl[k]) if isinstance(v, dict) else v
        return out

    for field, i in zip(fields, range(slots)):
        slot_flat = flat[i * n:(i + 1) * n]
        offset = 0
        for key, layer, in_type, raw_in, size in segments:
            params, state = _decode_layer_params(
                layer, in_type, slot_flat[offset:offset + size], raw_in)
            merged = dict(params)
            merged.update(state)
            # leaves the reference does not carry keep their zeros
            _graft_tree(holder[field][key],
                        _shape_like(merged, net.params[key]))
            offset += size
    net._drop_graphs()


def _load_updater_state(net, owner, flat: np.ndarray) -> None:
    _graft_updater_state(
        net, [(str(i), lay, post, raw, size)
              for i, lay, post, raw, size in _segments(net, owner)], flat)


# ======================================================================
# Export: save_dl4j_model
# ======================================================================

_KIND_TO = {"DenseLayer": "dense", "OutputLayer": "output",
            "Bidirectional": "Bidirectional",
            "ElementWiseMultiplicationLayer": "ElementWiseMult",
            "RnnOutputLayer": "rnnoutput", "LossLayer": "loss",
            "EmbeddingLayer": "embedding", "ActivationLayer": "activation",
            "DropoutLayer": "dropout", "ConvolutionLayer": "convolution",
            "SubsamplingLayer": "subsampling",
            "BatchNormalization": "batchNormalization", "LSTM": "LSTM",
            "GlobalPoolingLayer": "GlobalPooling",
            "ZeroPaddingLayer": "zeroPadding", "Upsampling2D": "Upsampling2D"}


def _layer_to_dl4j_json(layer, in_type: InputType) -> Tuple[str, dict]:
    cls = type(layer).__name__
    if cls not in _KIND_TO:
        raise UnsupportedLayerError(
            f"{cls} has no DL4J JSON mapping; export supports the shared "
            f"layer subset: {sorted(_KIND_TO)}")
    kind = _KIND_TO[cls]
    if cls == "Bidirectional":
        ikind, ibody = _layer_to_dl4j_json(layer.layer, in_type)
        mode = {"concat": "CONCAT", "add": "ADD", "mul": "MUL",
                "ave": "AVERAGE"}[layer.mode]
        return kind, {"layerName": layer.name, "mode": mode,
                      "fwd": {ikind: ibody}, "bwd": {ikind: dict(ibody)}}
    body: Dict[str, Any] = {"layerName": layer.name}
    if isinstance(layer.dropout, (int, float)) and layer.dropout > 0:
        body["iDropout"] = {
            "@class": "org.deeplearning4j.nn.conf.dropout.Dropout",
            "p": 1.0 - float(layer.dropout)}     # DL4J p = retain prob
    if layer.l1:
        body["l1"] = layer.l1
    if layer.l2:
        body["l2"] = layer.l2
    if hasattr(layer, "activation"):
        body["activationFn"] = _act_to(layer.activation)
    if hasattr(layer, "n_out") and getattr(layer, "n_out", 0):
        body["nout"] = layer.n_out
        nin = getattr(layer, "n_in", None)
        body["nin"] = nin or (in_type.shape[2] if in_type.kind == Kind.CNN
                              else in_type.flat_size
                              if in_type.kind != Kind.RNN
                              else in_type.features)
    if hasattr(layer, "loss"):
        body["lossFn"] = _loss_to(layer.loss)
    if hasattr(layer, "has_bias"):
        body["hasBias"] = layer.has_bias
    if cls in ("ConvolutionLayer", "SubsamplingLayer"):
        body["kernelSize"] = list(layer.kernel)
        body["stride"] = list(layer.stride)
        body["padding"] = [0, 0]
        body["convolutionMode"] = layer.convolution_mode.capitalize()
        if cls == "ConvolutionLayer":
            body["dilation"] = list(layer.dilation)
        else:
            body["poolingType"] = layer.pooling_type.upper()
            body["pnorm"] = layer.pnorm
    if cls == "GlobalPoolingLayer":
        body["poolingType"] = layer.pooling_type.upper()
        body["pnorm"] = layer.pnorm
    if cls == "ZeroPaddingLayer":
        body["padding"] = list(layer.padding)     # [top,bottom,left,right]
    if cls == "Upsampling2D":
        body["size"] = list(layer.size)
    if cls == "BatchNormalization":
        body.update(eps=layer.epsilon, decay=layer.decay,
                    gamma=layer.gamma_init, beta=layer.beta_init,
                    lockGammaBeta=layer.lock_gamma_beta)
    if cls == "LSTM":
        body["gateActivationFn"] = _act_to(layer.gate_activation)
        body["forgetGateBiasInit"] = layer.forget_gate_bias_init
    return kind, body


def save_dl4j_model(net, path, save_updater: bool = True) -> None:
    """Write this framework's MultiLayerNetwork as a reference-format model
    zip (configuration.json + coefficients.bin [+ updaterState.bin]), so the
    artifact can travel back to a DL4J deployment. Layout conversions are
    the exact inverses of the import path. The updater state is written for
    the updaters whose state the reference writes (every mapped one but
    AMSGrad); a mapped updater whose slots the port's state does not hold
    raises."""
    confs = []
    for i, layer in enumerate(net.layers):
        in_type = net._input_types[i]
        kind, body = _layer_to_dl4j_json(layer, in_type)
        body["iUpdater"] = _updater_to(net.conf.updater)
        confs.append({"layer": {kind: body}, "seed": net.conf.seed})
    top = {
        "backprop": True,
        "backpropType": ("TruncatedBPTT"
                         if net.conf.backprop_type == "tbptt" else "Standard"),
        "tbpttFwdLength": net.conf.tbptt_fwd_length,
        "tbpttBackLength": net.conf.tbptt_back_length,
        "confs": confs,
        "pretrain": False,
    }
    owner = list(range(len(net.layers)))
    flat_parts = []
    for our_i, layer, in_type, raw_in, _size in _segments(net, owner):
        flat_parts.append(_encode_layer_params(
            layer, in_type, net.params[str(our_i)], net.state[str(our_i)],
            raw_in))
    flat = (np.concatenate(flat_parts) if flat_parts
            else np.zeros((0,), np.float32))

    upd_flat = None
    fields = _SLOT_FIELDS.get(type(net.conf.updater).__name__, ())
    if save_updater and fields and type(net.conf.updater).__name__ \
            != "AMSGrad" and net.opt_state is not None:
        holder = _slot_holder(net, fields)
        parts = []
        for field in fields:
            tree = holder[field]
            for our_i, layer, in_type, raw_in, _size in _segments(net, owner):
                lp = {k: tree[str(our_i)][k]
                      for k in net.params[str(our_i)]}
                # positions the reference updater tracks but we don't
                # (BN running mean/var are non-trainable here) -> zeros
                zstate = {k: np.zeros(tuple(v.shape), np.float32)
                          for k, v in net.state.get(str(our_i), {}).items()}
                parts.append(_encode_layer_params(
                    layer, in_type, lp, zstate, raw_in))
        upd_flat = np.concatenate(parts) if parts else None

    with zipfile.ZipFile(path, "w", zip_compression()) as zf:
        zf.writestr("configuration.json", json.dumps(top, indent=2))
        buf = io.BytesIO()
        write_nd4j_array(buf, flat)
        zf.writestr("coefficients.bin", buf.getvalue())
        if upd_flat is not None:
            buf = io.BytesIO()
            write_nd4j_array(buf, upd_flat)
            zf.writestr("updaterState.bin", buf.getvalue())


# ======================================================================
# ComputationGraph import (ModelSerializer.restoreComputationGraph)
# ======================================================================

def _parse_graph_vertex(body: dict):
    """One non-layer GraphVertex JSON (WRAPPER_OBJECT, GraphVertex.java:40
    subtype names) -> our GraphVertexConf."""
    from deeplearning4j_tpu_torch.nn.conf import graph_vertices as gv
    (kind, d), = body.items()
    d = d or {}
    if kind == "MergeVertex":
        return gv.MergeVertex()
    if kind == "ElementWiseVertex":
        return gv.ElementWiseVertex(op=(d.get("op") or "Add").lower())
    if kind == "SubsetVertex":
        return gv.SubsetVertex(from_idx=int(d.get("from", 0)),
                               to_idx=int(d.get("to", 0)))
    if kind == "ScaleVertex":
        return gv.ScaleVertex(scale=float(d.get("scaleFactor", 1.0)))
    if kind == "ShiftVertex":
        return gv.ShiftVertex(shift=float(d.get("shiftFactor", 0.0)))
    if kind == "StackVertex":
        return gv.StackVertex()
    if kind == "UnstackVertex":
        return gv.UnstackVertex(from_idx=int(d.get("from", 0)),
                                stack_size=int(d.get("stackSize", 1)))
    if kind == "L2Vertex":
        return gv.L2Vertex()
    if kind == "L2NormalizeVertex":
        return gv.L2NormalizeVertex()
    if kind == "ReverseTimeSeriesVertex":
        return gv.ReverseTimeSeriesVertex()
    if kind == "LastTimeStepVertex":
        return gv.LastTimeStepVertex()
    if kind == "DuplicateToTimeSeriesVertex":
        return gv.DuplicateToTimeSeriesVertex()
    if kind == "PoolHelperVertex":
        return gv.PoolHelperVertex()
    raise UnsupportedLayerError(f"unsupported DL4J graph vertex: {kind!r}")


def _dl4j_topo_order(network_inputs, vertex_names, vertex_inputs):
    """Reproduce ComputationGraph.topologicalSortOrder() (Kahn's algorithm
    over indices assigned inputs-first then JSON vertex order, FIFO queue,
    ascending tie-break) — this IS the flat parameter order contract."""
    from collections import deque
    names = list(network_inputs) + list(vertex_names)
    idx = {n: i for i, n in enumerate(names)}
    incoming = {i: set() for i in range(len(names))}
    outgoing = {i: set() for i in range(len(names))}
    for vn in vertex_names:
        for src in vertex_inputs.get(vn, []) or []:
            incoming[idx[vn]].add(idx[src])
            outgoing[idx[src]].add(idx[vn])
    q = deque(sorted(i for i in range(len(names)) if not incoming[i]))
    out = []
    while q:
        nxt = q.popleft()
        out.append(nxt)
        for o in sorted(outgoing[nxt]):
            incoming[o].discard(nxt)
            if not incoming[o]:
                q.append(o)
    if len(out) != len(names):
        raise ValueError("cycle in ComputationGraph configuration")
    return [names[i] for i in out]


def parse_dl4j_graph_conf(conf_json: str, input_types=None):
    """Reference ComputationGraphConfiguration JSON -> (our
    ComputationGraphConfiguration, layer-vertex names in the reference's
    flat-parameter order)."""
    from deeplearning4j_tpu_torch.nn.conf.network import GraphBuilder

    d = json.loads(conf_json)
    if "vertices" not in d or "networkInputs" not in d:
        raise ValueError("not a ComputationGraphConfiguration "
                         "('vertices'/'networkInputs' missing)")
    net_inputs = list(d["networkInputs"])
    net_outputs = list(d.get("networkOutputs", []))
    vertices = d["vertices"]                 # JSON object order preserved
    vertex_inputs = d.get("vertexInputs", {})

    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    parent = NeuralNetConfiguration.Builder()
    updater = None
    seed = 0
    g = GraphBuilder(parent).add_inputs(*net_inputs)

    layer_owner: Dict[str, Any] = {}         # vertex name -> param layer
    for vname, vbody in vertices.items():
        (vkind, vd), = vbody.items()
        ins = list(vertex_inputs.get(vname, []))
        if vkind == "LayerVertex":
            nnconf = vd.get("layerConf") or {}
            seed = int(nnconf.get("seed", seed) or 0)
            (lkind, lbody), = nnconf["layer"].items()
            if updater is None:
                updater = _layer_updater(lbody)
            expansion = _apply_common(_parse_layer(lkind, lbody), lbody)
            prev = ins
            for i, lay in enumerate(expansion):
                last = i == len(expansion) - 1
                nm = vname if last else f"{vname}__pre{i}"
                g.add_layer(nm, lay, *prev)
                prev = [nm]
            layer_owner[vname] = expansion[-1]
        else:
            g.add_vertex(vname, _parse_graph_vertex(vbody), *ins)
    g.set_outputs(*net_outputs)

    parent._seed = seed
    parent._updater = updater or upd.Sgd(1e-2)
    bp = d.get("backpropType") or "Standard"
    if bp == "TruncatedBPTT":
        g.backprop_type("tbptt", int(d.get("tbpttFwdLength", 20) or 20),
                        int(d.get("tbpttBackLength", 20) or 20))
    if input_types is not None:
        g.set_input_types(*input_types)
    else:
        inferred = []
        # mirror _infer_input_type's restriction: only genuinely
        # feed-forward consumers allow FF inference — an LSTM/Conv nin
        # would silently build the wrong input kind
        _FF_CONSUMERS = ("DenseLayer", "OutputLayer", "EmbeddingLayer",
                         "ElementWiseMultiplicationLayer")
        for iname in net_inputs:
            ft = None
            for vname, lay in layer_owner.items():
                if iname in (vertex_inputs.get(vname) or []) and \
                        type(lay).__name__ in _FF_CONSUMERS and \
                        getattr(lay, "n_in", None):
                    ft = InputType.feed_forward(lay.n_in)
                    break
            if ft is None:
                raise ValueError(
                    f"cannot infer the input type of graph input {iname!r}; "
                    "pass input_types=[InputType...] in network-input order")
            inferred.append(ft)
        g.set_input_types(*inferred)

    topo = _dl4j_topo_order(net_inputs, list(vertices.keys()), vertex_inputs)
    layer_order = [n for n in topo if n in layer_owner]
    return g.build(), layer_order


def _graph_segments(gnet, layer_order):
    """(vertex_name, layer, post_in_type, raw_in_type, size) per
    param-carrying vertex, in the reference's flat order."""
    from deeplearning4j_tpu_torch.nn.conf.base import preprocessed_type
    for name in layer_order:
        vd = gnet.conf.vertices[name]
        layer = vd.vertex
        raw = gnet._vertex_types[vd.inputs[0]]
        post = raw
        need = gnet._pre_kind[name]
        if need is not None and raw.kind != need:
            post = preprocessed_type(raw, need)
        size = _layer_num_params(layer, post)
        if size:
            yield name, layer, post, raw, size


def restore_computation_graph(path, load_updater: bool = True,
                              input_types=None, device: DeviceLike = None):
    """Load a reference-produced ComputationGraph model zip
    (ModelSerializer.restoreComputationGraph, ModelSerializer.java:250+)
    into a ready-to-run ComputationGraph on `device` (default CUDA;
    raises without it). `input_types` is a sequence of
    InputType in networkInputs order (required unless every graph input
    feeds a layer that declares nin)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        conf_json = zf.read("configuration.json").decode("utf-8")
        coeffs = (read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
                  if "coefficients.bin" in names else None)
        updater_state = (read_nd4j_array(io.BytesIO(zf.read("updaterState.bin")))
                         if "updaterState.bin" in names and load_updater
                         else None)

    conf, layer_order = parse_dl4j_graph_conf(conf_json, input_types)
    gnet = ComputationGraph(conf, device=device).init()

    if coeffs is not None:
        flat = np.asarray(coeffs, np.float32).ravel()
        offset = 0
        for name, layer, post, raw, size in _graph_segments(gnet,
                                                            layer_order):
            params, state = _decode_layer_params(
                layer, post, flat[offset:offset + size], raw)
            _graft(gnet, name, params, state)
            offset += size
        if offset != flat.size:
            raise ValueError(f"coefficients.bin length mismatch: consumed "
                             f"{offset} of {flat.size} values")
        if updater_state is not None:
            _load_graph_updater_state(
                gnet, layer_order,
                np.asarray(updater_state, np.float32).ravel())
    return gnet


def _load_graph_updater_state(gnet, layer_order, flat: np.ndarray) -> None:
    _graft_updater_state(gnet, list(_graph_segments(gnet, layer_order)),
                         flat)


# ======================================================================
# normalizer.bin (ModelSerializer.addNormalizerToModel /
# restoreNormalizerFromFile; nd4j NormalizerSerializer strategies)
# ======================================================================
#
# Wire format (nd4j NormalizerSerializer + per-type strategy):
#   Java-UTF header = NormalizerType enum name ("STANDARDIZE" | "MIN_MAX")
#   STANDARDIZE (StandardizeSerializerStrategy):
#       boolean fitLabel; Nd4j(mean); Nd4j(std) [; labelMean; labelStd]
#   MIN_MAX (MinMaxSerializerStrategy):
#       boolean fitLabel; double targetMin; double targetMax;
#       Nd4j(min); Nd4j(max) [; labelMin; labelMax]

def read_normalizer(f):
    """Parse a normalizer.bin stream into this framework's normalizer
    objects (data/normalization.py)."""
    from deeplearning4j_tpu_torch.data.normalization import (
        NormalizerMinMaxScaler, NormalizerStandardize,
    )
    ntype = _read_java_utf(f)
    if ntype == "STANDARDIZE":
        fit_label = bool(f.read(1)[0])
        norm = NormalizerStandardize(fit_labels=fit_label)
        norm.feature_mean = read_nd4j_array(f).ravel().astype(np.float32)
        norm.feature_std = read_nd4j_array(f).ravel().astype(np.float32)
        if fit_label:
            norm.label_mean = read_nd4j_array(f).ravel().astype(np.float32)
            norm.label_std = read_nd4j_array(f).ravel().astype(np.float32)
        return norm
    if ntype == "MIN_MAX":
        fit_label = bool(f.read(1)[0])
        (lo,) = struct.unpack(">d", f.read(8))
        (hi,) = struct.unpack(">d", f.read(8))
        norm = NormalizerMinMaxScaler(lo=lo, hi=hi)
        norm.feature_min = read_nd4j_array(f).ravel().astype(np.float32)
        norm.feature_max = read_nd4j_array(f).ravel().astype(np.float32)
        if fit_label:
            # consume labelMin/labelMax so the stream position stays
            # valid, but our MinMax scaler has no label-scaling mode —
            # dropped loudly, not silently
            read_nd4j_array(f)
            read_nd4j_array(f)
            import logging
            logging.getLogger("deeplearning4j_tpu_torch").warning(
                "normalizer.bin MIN_MAX was fitted with fitLabel=true; "
                "label min/max stats are dropped (NormalizerMinMaxScaler "
                "here scales features only)")
        return norm
    raise UnsupportedLayerError(
        f"unsupported normalizer type {ntype!r} in normalizer.bin "
        "(STANDARDIZE and MIN_MAX import)")


def write_normalizer(f, norm) -> None:
    """Inverse of read_normalizer, for artifacts travelling back."""
    from deeplearning4j_tpu_torch.data.normalization import (
        NormalizerMinMaxScaler, NormalizerStandardize,
    )
    if isinstance(norm, NormalizerStandardize):
        _write_java_utf(f, "STANDARDIZE")
        fit_label = norm.label_mean is not None
        f.write(bytes([1 if fit_label else 0]))
        write_nd4j_array(f, norm.feature_mean)
        write_nd4j_array(f, norm.feature_std)
        if fit_label:
            write_nd4j_array(f, norm.label_mean)
            write_nd4j_array(f, norm.label_std)
        return
    if isinstance(norm, NormalizerMinMaxScaler):
        _write_java_utf(f, "MIN_MAX")
        f.write(bytes([0]))
        f.write(struct.pack(">d", norm.lo))
        f.write(struct.pack(">d", norm.hi))
        write_nd4j_array(f, norm.feature_min)
        write_nd4j_array(f, norm.feature_max)
        return
    raise UnsupportedLayerError(
        f"{type(norm).__name__} has no normalizer.bin mapping")


def restore_normalizer(path):
    """restoreNormalizerFromFile parity: read the normalizer saved inside
    a model zip (returns None when the zip has no normalizer entry)."""
    with zipfile.ZipFile(path, "r") as zf:
        if "normalizer.bin" not in zf.namelist():
            return None
        return read_normalizer(io.BytesIO(zf.read("normalizer.bin")))


def add_normalizer_to_model(path, norm) -> None:
    """addNormalizerToModel parity: attach (or replace) the normalizer
    entry of an existing model zip in place."""
    import os
    import tempfile
    with zipfile.ZipFile(path, "r") as zf:
        entries = [(n, zf.read(n)) for n in zf.namelist()
                   if n != "normalizer.bin"]
    buf = io.BytesIO()
    write_normalizer(buf, norm)
    # write-then-rename: a crash mid-write must not destroy the original
    # model artifact
    orig_mode = os.stat(path).st_mode
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path))
                               or ".", suffix=".zip.tmp")
    os.close(fd)
    try:
        with zipfile.ZipFile(tmp, "w", zip_compression()) as zf:
            for n, data in entries:
                zf.writestr(n, data)
            zf.writestr("normalizer.bin", buf.getvalue())
        os.chmod(tmp, orig_mode)        # mkstemp creates 0600; keep the
        os.replace(tmp, path)           # artifact's sharing permissions
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
