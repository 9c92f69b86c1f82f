"""Data-parallel training over the ranks of a process group
(ParallelWrapper — the dl4j-parallel-wrapper quickstart). Launched alone
it trains in a one-rank group; under a launcher every rank runs it (one
process per card, e.g. ``torchrun --nproc-per-node 4``).
Run: python -m deeplearning4j_tpu_torch.examples.08_parallel_training
[--device cpu]
"""
import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.examples._common import (
    cli, device_of, process_group,
)
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import (
    MeshConfig, ParallelWrapper, TrainingMode, build_mesh,
)


def main(epochs=10, mode=TrainingMode.SYNC_GRADIENTS, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(6)
    centers = rs.randn(4, 6) * 3
    X = np.concatenate([centers[i] + rs.randn(64, 6)
                        for i in range(4)]).astype("float32")
    Y = np.eye(4, dtype="float32")[np.repeat(np.arange(4), 64)]

    conf = (NeuralNetConfiguration.Builder().seed(8).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6))
            .build())
    with process_group(dev):
        net = MultiLayerNetwork(conf, device=dev).init()
        mesh = build_mesh(MeshConfig())     # every rank on the "data" axis
        wrapper = ParallelWrapper(net, mesh=mesh, mode=mode)
        wrapper.fit(ArrayDataSetIterator(X, Y, batch_size=64),
                    epochs=epochs)
        ev = net.evaluate(ArrayDataSetIterator(X, Y, batch_size=64))
    print(f"{mesh.shape} {TrainingMode(mode).value}: "
          f"accuracy {ev.accuracy():.3f}")
    return ev.accuracy()


if __name__ == "__main__":
    cli(main)
