"""ComputationGraph: multi-branch DAG with a merge vertex (tutorial 01's
graph half). Run: python -m
deeplearning4j_tpu_torch.examples.02_computation_graph [--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.examples._common import cli, device_of, host
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.network import GraphBuilder
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam


def main(epochs=25, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(1)
    X = rs.randn(240, 6).astype("float32")
    y = (X @ rs.randn(6) > 0).astype(int)
    Y = np.eye(2, dtype="float32")[y]

    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(5)
                      .updater(Adam(1e-2)))
         .add_inputs("in").set_input_types(InputType.feed_forward(6)))
    g.add_layer("wide", DenseLayer(n_out=16, activation="relu"), "in")
    g.add_layer("deep1", DenseLayer(n_out=12, activation="relu"), "in")
    g.add_layer("deep2", DenseLayer(n_out=12, activation="relu"), "deep1")
    g.add_vertex("merge", MergeVertex(), "wide", "deep2")
    g.add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"), "merge")
    g.set_outputs("out")

    net = ComputationGraph(g.build(), device=dev).init()
    net.fit(ArrayDataSetIterator(X, Y, batch_size=40), epochs=epochs)
    acc = (host(net.output(X)).argmax(1) == y).mean()
    print(f"wide&deep accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    cli(main)
