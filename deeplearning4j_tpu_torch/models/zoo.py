"""Zoo architectures: the `ZooModel` base, the CNN models and the name
registry.

Counterpart of the JAX package's `models/zoo.py`: `ZooModel`, `LeNet`,
`SimpleCNN`, `ResNet50` (with its `space_to_depth_stem` option and
`s2d_stem_weights`) and `TextGenerationLSTM` build the reference's configs
field for field, so a zoo model's `configuration.json` is the same in both
packages. The transformer LM family lives in `models/transformer.py`; the
other architectures are not ported yet (ROADMAP A.4). Activations are
NHWC and kernels HWIO, as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, GlobalPoolingLayer, OutputLayer, RnnOutputLayer,
    SpaceToDepthLayer, SubsamplingLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.util.platform import DeviceLike


class ZooModel:
    """Base zoo model (DL4J `zoo/ZooModel.java`): `init()` builds an
    untrained network from the config and a seed; `init_pretrained()`
    loads published weights from a local cache only (there is no
    download)."""

    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    def conf(self):
        raise NotImplementedError

    def init(self, device: DeviceLike = None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        c = self.conf()
        cls = ComputationGraph if isinstance(
            c, ComputationGraphConfiguration) else MultiLayerNetwork
        return cls(c, device=device).init()

    def init_pretrained(self, cache_dir: Optional[str] = None,
                        device: DeviceLike = None):
        """The reference's cache layout, ``<cache_dir>/<name>.zip``; a
        missing file raises FileNotFoundError, as in the reference."""
        from deeplearning4j_tpu_torch.util.serialization import load_model
        name = type(self).__name__.lower()
        cache_dir = cache_dir or os.path.expanduser(
            "~/.deeplearning4j_tpu/models")
        path = os.path.join(cache_dir, f"{name}.zip")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No pretrained weights cached at {path}; pretrained "
                "downloads require network access (DL4J "
                "ZooModel.initPretrained)")
        return load_model(path, device=device)


# --------------------------------------------------------------------- LeNet
@dataclasses.dataclass
class LeNet(ZooModel):
    """LeNet-5 on MNIST-sized input (DL4J `zoo/model/LeNet.java`)."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (28, 28, 1)
    seed: int = 123

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(Adam(1e-3))
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(*self.input_shape))
                .build())


# ----------------------------------------------------------------- SimpleCNN
@dataclasses.dataclass
class SimpleCNN(ZooModel):
    """DL4J `zoo/model/SimpleCNN.java`, a small VGG-like CNN."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (48, 48, 3)
    seed: int = 123

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .weight_init("relu")
             .list())
        for n_out, pool in ((16, False), (16, True), (32, False), (32, True),
                            (64, False), (64, True)):
            b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="identity"))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="relu"))
            if pool:
                b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        b.layer(DropoutLayer(dropout=0.5))
        b.layer(DenseLayer(n_out=256, activation="relu"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()


# ------------------------------------------------------------------ ResNet50
@dataclasses.dataclass
class ResNet50(ZooModel):
    """ResNet-50 (DL4J `zoo/model/ResNet50.java`) as a ComputationGraph:
    bottleneck blocks with projection shortcuts in the first block of each
    stage, batch norm after every convolution, the residual adds as
    ElementWiseVertex(add). `space_to_depth_stem` replaces the 7x7/s2
    stem by a 2x2 space-to-depth and a 4x4/s1 conv, exactly equivalent
    under `s2d_stem_weights`."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123
    space_to_depth_stem: bool = False

    def _conv_bn(self, g, name, n_out, kernel, stride, inp, pad="same",
                 relu=True):
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                     convolution_mode=pad,
                                     activation="identity", has_bias=False),
                    inp)
        g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if relu:
            g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                        f"{name}_bn")
            return f"{name}_relu"
        return f"{name}_bn"

    def _bottleneck(self, g, name, inp, filters, stride, project):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", f1, (1, 1), stride, inp)
        x = self._conv_bn(g, f"{name}_b", f2, (3, 3), (1, 1), x)
        x = self._conv_bn(g, f"{name}_c", f3, (1, 1), (1, 1), x, relu=False)
        if project:
            sc = self._conv_bn(g, f"{name}_sc", f3, (1, 1), stride, inp,
                               relu=False)
        else:
            sc = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Nesterovs(1e-1, momentum=0.9))
                          .weight_init("relu")
                          .l2(1e-4))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        if self.space_to_depth_stem:
            h, w = self.input_shape[:2]
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth_stem needs even input H/W (the 2x2 "
                    f"rearrange + exact 7x7-stem equivalence both require "
                    f"it); got {self.input_shape} — use the standard stem")
            g.add_layer("stem_s2d", SpaceToDepthLayer(block_size=2),
                        "input")
            # pad (2 left, 1 right): the 7x7 + pad-3 receptive field spans
            # s2d cells i-2..i+1 (see s2d_stem_weights)
            g.add_layer("stem_pad", ZeroPaddingLayer(padding=(2, 1, 2, 1)),
                        "stem_s2d")
            x = self._conv_bn(g, "stem", 64, (4, 4), (1, 1), "stem_pad",
                              pad="truncate")
        else:
            g.add_layer("stem_pad", ZeroPaddingLayer(padding=(3, 3, 3, 3)),
                        "input")
            x = self._conv_bn(g, "stem", 64, (7, 7), (2, 2), "stem_pad",
                              pad="truncate")
        g.add_layer("stem_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                     convolution_mode="same"), x)
        x = "stem_pool"
        stages = [
            ("res2", (64, 64, 256), 3, (1, 1)),
            ("res3", (128, 128, 512), 4, (2, 2)),
            ("res4", (256, 256, 1024), 6, (2, 2)),
            ("res5", (512, 512, 2048), 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = self._bottleneck(g, f"{sname}a", x, filters, stride, True)
            for i in range(1, blocks):
                x = self._bottleneck(g, f"{sname}{chr(97 + i)}", x, filters,
                                     (1, 1), False)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output",
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"), "avgpool")
        g.set_outputs("output")
        return g.build()


def s2d_stem_weights(w7):
    """Map the standard stem's (7, 7, C, F) HWIO weights onto the
    space-to-depth stem's (4, 4, 4*C, F), exactly: pad w7 to 8x8 with a
    zero leading row and column (k8[1:, 1:] = w7), then regroup
    ``w4[a, b, (dr*2 + dc)*C + ch, f] = k8[2a + dr, 2b + dc, ch, f]``,
    SpaceToDepthLayer's (dr, dc, ch) depth order. Takes and returns numpy
    arrays."""
    w7 = np.asarray(w7)
    kh, kw, c, f = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError("the stem mapping is for the 7x7 head conv")
    k8 = np.zeros((8, 8, c, f), w7.dtype)
    k8[1:, 1:] = w7
    w4 = k8.reshape(4, 2, 4, 2, c, f).transpose(0, 2, 1, 3, 4, 5)
    return w4.reshape(4, 4, 4 * c, f)


# -------------------------------------------------------- TextGenerationLSTM
@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    """Char-level text generation LSTM (DL4J
    `zoo/model/TextGenerationLSTM.java`): two stacked LSTMs and a softmax
    RnnOutputLayer, Adam(1e-3), gradient norm clipped at 5, truncated BPTT
    of 50 steps."""
    total_unique_characters: int = 47
    max_length: int = 40
    units: int = 256
    seed: int = 123

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(Adam(1e-3))
                .grad_clip_norm(5.0)
                .list()
                .layer(LSTM(n_out=self.units, activation="tanh"))
                .layer(LSTM(n_out=self.units, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.total_unique_characters,
                                      activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(
                    self.total_unique_characters, self.max_length))
                .backprop_type("tbptt", 50, 50)
                .build())


def zoo_models() -> dict:
    """Name -> ZooModel subclass map, the resolver behind `zoo:<Name>`."""
    from deeplearning4j_tpu_torch.models import transformer
    out = {}
    for mod_globals in (globals(), vars(transformer)):
        for obj in mod_globals.values():
            if isinstance(obj, type) and issubclass(obj, ZooModel) \
                    and obj is not ZooModel:
                out[obj.__name__] = obj
    return out


def model_by_name(name: str, **overrides) -> ZooModel:
    """Instantiate a zoo architecture by (case-insensitive) class name,
    with dataclass field overrides. Raises KeyError listing the known
    names for a typo'd arch."""
    models = zoo_models()
    by_lower = {k.lower(): v for k, v in models.items()}
    cls = models.get(name) or by_lower.get(name.lower())
    if cls is None:
        raise KeyError(f"unknown zoo model {name!r}; available: "
                       f"{', '.join(sorted(models))}")
    return cls(**overrides)
