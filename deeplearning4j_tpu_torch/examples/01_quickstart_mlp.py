"""Quickstart: configure -> init -> fit -> evaluate -> save/load.

Mirrors dl4j-examples tutorials 01/03/04 (MultiLayerNetwork basics,
logistic regression, feed-forward) on synthetic blob data.
Run: python -m deeplearning4j_tpu_torch.examples.01_quickstart_mlp
[--device cpu]
"""
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.examples._common import cli, device_of, host
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.train.listeners import ScoreIterationListener
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)


def make_data(n=300, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(3, 4) * 4
    X = np.concatenate([centers[i] + rs.randn(n // 3, 4)
                        for i in range(3)]).astype("float32")
    Y = np.eye(3, dtype="float32")[np.repeat(np.arange(3), n // 3)]
    return X, Y


def main(epochs=30, tmpdir=None, device=None):
    dev = device_of(device)
    tmpdir = tmpdir or tempfile.gettempdir()
    X, Y = make_data()
    conf = (NeuralNetConfiguration.Builder()
            .seed(42)
            .updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    net.set_listeners(ScoreIterationListener(10))
    net.fit(ArrayDataSetIterator(X, Y, batch_size=50), epochs=epochs)
    ev = net.evaluate(ArrayDataSetIterator(X, Y, batch_size=50))
    print(f"accuracy: {ev.accuracy():.3f}")
    path = f"{tmpdir}/quickstart_mlp.zip"
    save_model(net, path)
    net2 = load_model(path, device=dev)
    assert np.allclose(host(net.output(X[:4])), host(net2.output(X[:4])))
    print(f"saved + reloaded {path}")
    return ev.accuracy()


if __name__ == "__main__":
    cli(main)
