"""Zoo architectures: the `ZooModel` base, the CNN and recurrent models
and the name registry.

Counterpart of the JAX package's `models/zoo.py`, every model of it:
LeNet, SimpleCNN, AlexNet, VGG16/19, ResNet50 (with its
`space_to_depth_stem` option and `s2d_stem_weights`), GoogLeNet,
Darknet19, TinyYOLO and YOLO2 (a Darknet backbone and a
Yolo2OutputLayer head), TextGenerationLSTM, InceptionResNetV1,
FaceNetNN4Small2 and UNet build the reference's configs field for field,
so a zoo model's `configuration.json` is the same in both packages. The
transformer LM family lives in `models/transformer.py`. Activations are
NHWC and kernels HWIO, as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex, MergeVertex, ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, ActivationLayer, BatchNormalization, CnnLossLayer, ConvolutionLayer,
    DenseLayer, DropoutLayer, GlobalPoolingLayer, LocalResponseNormalization,
    OutputLayer, RnnOutputLayer, SpaceToDepthLayer, SubsamplingLayer,
    Upsampling2D, Yolo2OutputLayer, ZeroPaddingLayer,
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


# ------------------------------------------------------------------- AlexNet
@dataclasses.dataclass
class AlexNet(ZooModel):
    """AlexNet (DL4J `zoo/model/AlexNet.java`, one-tower variant with LRN)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(Nesterovs(1e-2, momentum=0.9))
                .weight_init("relu")
                .l2(5e-4)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel=(11, 11), stride=(4, 4),
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel=(5, 5),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel=(3, 3),
                                        convolution_mode="same",
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(*self.input_shape))
                .build())


# ----------------------------------------------------------------- VGG 16/19
def _vgg_conf(blocks, num_classes, input_shape, seed):
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .updater(Nesterovs(1e-2, momentum=0.9))
         .weight_init("relu")
         .list())
    for n_convs, n_out in blocks:
        for _ in range(n_convs):
            b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu"))
        b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(*input_shape))
    return b.build()


@dataclasses.dataclass
class VGG16(ZooModel):
    """VGG-16 (DL4J `zoo/model/VGG16.java`)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                         self.num_classes, self.input_shape, self.seed)


@dataclasses.dataclass
class VGG19(ZooModel):
    """VGG-19 (DL4J `zoo/model/VGG19.java`)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                         self.num_classes, self.input_shape, self.seed)


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


# ----------------------------------------------------------------- GoogLeNet
@dataclasses.dataclass
class GoogLeNet(ZooModel):
    """GoogLeNet / Inception-v1 (DL4J `zoo/model/GoogLeNet.java`), without
    the auxiliary classifier heads (DL4J omits them too)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    def _inception(self, g, name, inp, c1, c3r, c3, c5r, c5, pp):
        g.add_layer(f"{name}_1x1",
                    ConvolutionLayer(n_out=c1, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="relu"), inp)
        g.add_layer(f"{name}_3x3r",
                    ConvolutionLayer(n_out=c3r, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="relu"), inp)
        g.add_layer(f"{name}_3x3",
                    ConvolutionLayer(n_out=c3, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu"), f"{name}_3x3r")
        g.add_layer(f"{name}_5x5r",
                    ConvolutionLayer(n_out=c5r, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="relu"), inp)
        g.add_layer(f"{name}_5x5",
                    ConvolutionLayer(n_out=c5, kernel=(5, 5),
                                     convolution_mode="same",
                                     activation="relu"), f"{name}_5x5r")
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(1, 1),
                                     convolution_mode="same"), inp)
        g.add_layer(f"{name}_poolproj",
                    ConvolutionLayer(n_out=pp, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="relu"), f"{name}_pool")
        g.add_vertex(f"{name}_out", MergeVertex(),
                     f"{name}_1x1", f"{name}_3x3", f"{name}_5x5",
                     f"{name}_poolproj")
        return f"{name}_out"

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Nesterovs(1e-2, momentum=0.9))
                          .weight_init("relu"))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        g.add_layer("stem_conv",
                    ConvolutionLayer(n_out=64, kernel=(7, 7), stride=(2, 2),
                                     convolution_mode="same",
                                     activation="relu"), "input")
        g.add_layer("stem_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                     convolution_mode="same"), "stem_conv")
        g.add_layer("stem_lrn", LocalResponseNormalization(), "stem_pool")
        g.add_layer("stem2_red",
                    ConvolutionLayer(n_out=64, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="relu"), "stem_lrn")
        g.add_layer("stem2_conv",
                    ConvolutionLayer(n_out=192, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu"), "stem2_red")
        g.add_layer("stem2_lrn", LocalResponseNormalization(), "stem2_conv")
        g.add_layer("stem2_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                     convolution_mode="same"), "stem2_lrn")
        x = self._inception(g, "inc3a", "stem2_pool", 64, 96, 128, 16, 32, 32)
        x = self._inception(g, "inc3b", x, 128, 128, 192, 32, 96, 64)
        g.add_layer("pool3", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                              convolution_mode="same"), x)
        x = self._inception(g, "inc4a", "pool3", 192, 96, 208, 16, 48, 64)
        x = self._inception(g, "inc4b", x, 160, 112, 224, 24, 64, 64)
        x = self._inception(g, "inc4c", x, 128, 128, 256, 24, 64, 64)
        x = self._inception(g, "inc4d", x, 112, 144, 288, 32, 64, 64)
        x = self._inception(g, "inc4e", x, 256, 160, 320, 32, 128, 128)
        g.add_layer("pool4", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                              convolution_mode="same"), x)
        x = self._inception(g, "inc5a", "pool4", 256, 160, 320, 32, 128, 128)
        x = self._inception(g, "inc5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("output",
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"), "dropout")
        g.set_outputs("output")
        return g.build()


# ----------------------------------------------------------------- Darknet19
@dataclasses.dataclass
class Darknet19(ZooModel):
    """Darknet-19 classification backbone (DL4J `zoo/model/Darknet19.java`)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    seed: int = 123

    @staticmethod
    def _dn_conv(b, n_out, kernel):
        b.layer(ConvolutionLayer(n_out=n_out, kernel=kernel,
                                 convolution_mode="same",
                                 activation="identity", has_bias=False))
        b.layer(BatchNormalization())
        b.layer(ActivationLayer(activation="leakyrelu", alpha=0.1))

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-3, momentum=0.9))
             .weight_init("relu")
             .list())
        plan = [(32,), "M", (64,), "M", (128, 64, 128), "M",
                (256, 128, 256), "M", (512, 256, 512, 256, 512), "M",
                (1024, 512, 1024, 512, 1024)]
        for item in plan:
            if item == "M":
                b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            else:
                for i, n in enumerate(item):
                    k = (3, 3) if (len(item) == 1 or i % 2 == 0) else (1, 1)
                    self._dn_conv(b, n, k)
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel=(1, 1),
                                 convolution_mode="same",
                                 activation="identity"))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent", n_in=self.num_classes))
        b.set_input_type(InputType.convolutional(*self.input_shape))
        return b.build()


# ---------------------------------------------------------------- YOLO family
def _yolo_backbone(g, prefix, inp, plan):
    x = inp
    for i, item in enumerate(plan):
        name = f"{prefix}{i}"
        if item == "M":
            g.add_layer(name, SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                        x)
        else:
            n_out, k = item
            g.add_layer(f"{name}_conv",
                        ConvolutionLayer(n_out=n_out, kernel=(k, k),
                                         convolution_mode="same",
                                         activation="identity",
                                         has_bias=False), x)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            g.add_layer(name, ActivationLayer(activation="leakyrelu",
                                              alpha=0.1), f"{name}_bn")
        x = name
    return x


@dataclasses.dataclass
class TinyYOLO(ZooModel):
    """Tiny YOLO v2 (DL4J `zoo/model/TinyYOLO.java`): Darknet-tiny backbone +
    Yolo2OutputLayer head with 5 anchor boxes on a 13x13 grid."""
    num_classes: int = 20
    input_shape: Tuple[int, int, int] = (416, 416, 3)
    seed: int = 123
    anchors: Tuple[Tuple[float, float], ...] = (
        (1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11), (16.62, 10.52))

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Adam(1e-3))
                          .weight_init("relu"))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        plan = [(16, 3), "M", (32, 3), "M", (64, 3), "M", (128, 3), "M",
                (256, 3), "M", (512, 3), (1024, 3), (1024, 3)]
        x = _yolo_backbone(g, "b", "input", plan)
        n_b = len(self.anchors)
        g.add_layer("det",
                    ConvolutionLayer(n_out=n_b * (5 + self.num_classes),
                                     kernel=(1, 1), convolution_mode="same",
                                     activation="identity"), x)
        g.add_layer("yolo", Yolo2OutputLayer(anchors=self.anchors,
                                             n_classes=self.num_classes),
                    "det")
        g.set_outputs("yolo")
        return g.build()


@dataclasses.dataclass
class YOLO2(ZooModel):
    """YOLO v2 (DL4J `zoo/model/YOLO2.java`): Darknet-19 backbone with the
    passthrough route omitted in DL4J's published config too."""
    num_classes: int = 80
    input_shape: Tuple[int, int, int] = (608, 608, 3)
    seed: int = 123
    anchors: Tuple[Tuple[float, float], ...] = (
        (0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
        (7.88282, 3.52778), (9.77052, 9.16828))

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Adam(1e-3))
                          .weight_init("relu"))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        plan = [(32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M",
                (256, 3), (128, 1), (256, 3), "M",
                (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
                (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
                (1024, 3), (1024, 3)]
        x = _yolo_backbone(g, "b", "input", plan)
        n_b = len(self.anchors)
        g.add_layer("det",
                    ConvolutionLayer(n_out=n_b * (5 + self.num_classes),
                                     kernel=(1, 1), convolution_mode="same",
                                     activation="identity"), x)
        g.add_layer("yolo", Yolo2OutputLayer(anchors=self.anchors,
                                             n_classes=self.num_classes),
                    "det")
        g.set_outputs("yolo")
        return g.build()


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


# ------------------------------------------------------- InceptionResNetV1
@dataclasses.dataclass
class InceptionResNetV1(ZooModel):
    """Inception-ResNet v1 (DL4J `zoo/model/InceptionResNetV1.java`), the
    FaceNet backbone. Reduced-depth faithful shape: stem + 5x block35 +
    reduction-A + 10x block17 + reduction-B + 5x block8 + avgpool + head."""
    num_classes: int = 1001
    input_shape: Tuple[int, int, int] = (160, 160, 3)
    seed: int = 123
    embedding_size: int = 128

    def _conv(self, g, name, inp, n_out, kernel, stride=(1, 1), pad="same"):
        g.add_layer(f"{name}_c",
                    ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                     convolution_mode=pad,
                                     activation="identity", has_bias=False),
                    inp)
        g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_c")
        g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_bn")
        return name

    def _block35(self, g, name, inp, scale=0.17):
        b0 = self._conv(g, f"{name}_b0", inp, 32, (1, 1))
        b1 = self._conv(g, f"{name}_b1a", inp, 32, (1, 1))
        b1 = self._conv(g, f"{name}_b1b", b1, 32, (3, 3))
        b2 = self._conv(g, f"{name}_b2a", inp, 32, (1, 1))
        b2 = self._conv(g, f"{name}_b2b", b2, 32, (3, 3))
        b2 = self._conv(g, f"{name}_b2c", b2, 32, (3, 3))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
        g.add_layer(f"{name}_up",
                    ConvolutionLayer(n_out=256, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
        return name

    def _block17(self, g, name, inp, scale=0.10):
        b0 = self._conv(g, f"{name}_b0", inp, 128, (1, 1))
        b1 = self._conv(g, f"{name}_b1a", inp, 128, (1, 1))
        b1 = self._conv(g, f"{name}_b1b", b1, 128, (1, 7))
        b1 = self._conv(g, f"{name}_b1c", b1, 128, (7, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
        g.add_layer(f"{name}_up",
                    ConvolutionLayer(n_out=896, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
        return name

    def _block8(self, g, name, inp, scale=0.20, relu=True):
        b0 = self._conv(g, f"{name}_b0", inp, 192, (1, 1))
        b1 = self._conv(g, f"{name}_b1a", inp, 192, (1, 1))
        b1 = self._conv(g, f"{name}_b1b", b1, 192, (1, 3))
        b1 = self._conv(g, f"{name}_b1c", b1, 192, (3, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
        g.add_layer(f"{name}_up",
                    ConvolutionLayer(n_out=1792, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        if relu:
            g.add_layer(name, ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name
        return f"{name}_add"

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Adam(1e-3))
                          .weight_init("relu"))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        x = self._conv(g, "stem1", "input", 32, (3, 3), (2, 2), "truncate")
        x = self._conv(g, "stem2", x, 32, (3, 3), (1, 1), "truncate")
        x = self._conv(g, "stem3", x, 64, (3, 3))
        g.add_layer("stem_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), x)
        x = self._conv(g, "stem4", "stem_pool", 80, (1, 1))
        x = self._conv(g, "stem5", x, 192, (3, 3), (1, 1), "truncate")
        x = self._conv(g, "stem6", x, 256, (3, 3), (2, 2), "truncate")
        for i in range(5):
            x = self._block35(g, f"b35_{i}", x)
        # reduction-A
        ra0 = self._conv(g, "redA_b0", x, 384, (3, 3), (2, 2), "truncate")
        ra1 = self._conv(g, "redA_b1a", x, 192, (1, 1))
        ra1 = self._conv(g, "redA_b1b", ra1, 192, (3, 3))
        ra1 = self._conv(g, "redA_b1c", ra1, 256, (3, 3), (2, 2), "truncate")
        g.add_layer("redA_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), x)
        g.add_vertex("redA", MergeVertex(), ra0, ra1, "redA_pool")
        x = "redA"
        for i in range(10):
            x = self._block17(g, f"b17_{i}", x)
        # reduction-B
        rb0 = self._conv(g, "redB_b0a", x, 256, (1, 1))
        rb0 = self._conv(g, "redB_b0b", rb0, 384, (3, 3), (2, 2), "truncate")
        rb1 = self._conv(g, "redB_b1a", x, 256, (1, 1))
        rb1 = self._conv(g, "redB_b1b", rb1, 256, (3, 3), (2, 2), "truncate")
        rb2 = self._conv(g, "redB_b2a", x, 256, (1, 1))
        rb2 = self._conv(g, "redB_b2b", rb2, 256, (3, 3))
        rb2 = self._conv(g, "redB_b2c", rb2, 256, (3, 3), (2, 2), "truncate")
        g.add_layer("redB_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), x)
        g.add_vertex("redB", MergeVertex(), rb0, rb1, rb2, "redB_pool")
        x = "redB"
        for i in range(5):
            x = self._block8(g, f"b8_{i}", x)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "avgpool")
        g.add_layer("output",
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"), "bottleneck")
        g.set_outputs("output")
        return g.build()


@dataclasses.dataclass
class FaceNetNN4Small2(InceptionResNetV1):
    """FaceNet (DL4J `zoo/model/FaceNetNN4Small2.java`): the embedding
    variant — same backbone, 128-d L2-normalized embedding head trained
    with center-loss in DL4J; here softmax + embedding bottleneck."""
    num_classes: int = 1001
    input_shape: Tuple[int, int, int] = (96, 96, 3)
    embedding_size: int = 128


# ---------------------------------------------------------------------- UNet
@dataclasses.dataclass
class UNet(ZooModel):
    """U-Net (DL4J `zoo/model/UNet.java`): encoder/decoder with skip merges,
    sigmoid pixel head."""
    num_classes: int = 1
    input_shape: Tuple[int, int, int] = (128, 128, 3)
    seed: int = 123

    def _double_conv(self, g, name, inp, n_out):
        g.add_layer(f"{name}_c1",
                    ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu"), inp)
        g.add_layer(f"{name}_c2",
                    ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu"), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        g = (GraphBuilder(NeuralNetConfiguration.Builder()
                          .seed(self.seed)
                          .updater(Adam(1e-4))
                          .weight_init("relu"))
             .add_inputs("input")
             .set_input_types(InputType.convolutional(*self.input_shape)))
        widths = (64, 128, 256, 512)
        skips = []
        x = "input"
        for i, w in enumerate(widths):
            x = self._double_conv(g, f"enc{i}", x, w)
            skips.append(x)
            g.add_layer(f"down{i}", SubsamplingLayer(kernel=(2, 2),
                                                     stride=(2, 2)), x)
            x = f"down{i}"
        x = self._double_conv(g, "mid", x, 1024)
        for i, w in reversed(list(enumerate(widths))):
            g.add_layer(f"up{i}", Upsampling2D(size=(2, 2)), x)
            g.add_layer(f"upc{i}",
                        ConvolutionLayer(n_out=w, kernel=(2, 2),
                                         convolution_mode="same",
                                         activation="relu"), f"up{i}")
            g.add_vertex(f"cat{i}", MergeVertex(), skips[i], f"upc{i}")
            x = self._double_conv(g, f"dec{i}", f"cat{i}", w)
        g.add_layer("head",
                    ConvolutionLayer(n_out=self.num_classes, kernel=(1, 1),
                                     convolution_mode="same",
                                     activation="sigmoid"), x)
        g.add_layer("loss", CnnLossLayer(loss="xent", activation="identity"),
                    "head")
        g.set_outputs("loss")
        return g.build()


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
