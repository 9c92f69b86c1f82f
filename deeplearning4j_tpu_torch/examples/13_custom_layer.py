"""Authoring a custom layer (the DL4J SameDiff custom-layer workflow):
define plain functions of tensors, drop the layer into a normal config,
train — the gradient comes from autograd, as SameDiff layers derive
theirs. Run: python -m deeplearning4j_tpu_torch.examples.13_custom_layer
[--device cpu]"""
import numpy as np
import torch

from deeplearning4j_tpu_torch.examples._common import cli, device_of
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import OutputLayer, SameDiffLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam


def maxout_params(generator, input_type, dtype):
    """A maxout layer: k linear pieces, elementwise max."""
    f_in, k, f_out = input_type.shape[0], 3, 16
    return {"W": torch.randn((k, f_in, f_out), generator=generator,
                             dtype=dtype) * (2.0 / f_in) ** 0.5,
            "b": torch.zeros((k, f_out), dtype=dtype)}


def maxout_forward(params, x, train):
    pieces = torch.einsum("bf,kfo->bko", x, params["W"]) + params["b"]
    return pieces.amax(dim=1)


def maxout_type(input_type):
    return InputType.feed_forward(16)


def main(epochs=40, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(0)
    centers = rs.randn(3, 6) * 3
    y = np.repeat(np.arange(3), 60)
    X = (centers[y] + rs.randn(180, 6)).astype("float32")
    Y = np.eye(3, dtype="float32")[y]

    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-2))
            .list()
            .layer(SameDiffLayer(define_params=maxout_params,
                                 forward=maxout_forward,
                                 out_type=maxout_type))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    net.fit((X, Y), epochs=epochs, batch_size=60)
    acc = net.evaluate((X, Y)).accuracy()
    print(f"maxout custom layer accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    cli(main)
