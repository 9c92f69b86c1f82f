"""ZeRO/FSDP memory-sharded data-parallel training (no DL4J analog; see
`parallel/zero.py`).

`zero_stage=1` keeps the optimizer state dim-0-sharded over the "data"
ranks (each holds 1/N of Adam's moments); `zero_stage=3` shards the
parameters too. The training math is that of plain SYNC_GRADIENTS: the
gradients are reduce-scattered, each rank updates its piece, and the
pieces are all-gathered. Launched alone it trains in a one-rank group
(nothing to split); under a launcher every rank runs it.
Run: python -m deeplearning4j_tpu_torch.examples.16_zero_fsdp_training
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
from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_leaves
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, sharded_fraction,
)


def main(epochs=10, zero_stage=3, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(11)
    centers = rs.randn(4, 8) * 3
    X = np.concatenate([centers[i] + rs.randn(64, 8)
                        for i in range(4)]).astype("float32")
    Y = np.eye(4, dtype="float32")[np.repeat(np.arange(4), 64)]

    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    with process_group(dev):
        net = MultiLayerNetwork(conf, device=dev).init()
        shapes = [tuple(t.shape) for t in tree_leaves(net.params)]
        wrapper = ParallelWrapper(net, zero_stage=zero_stage)
        wrapper.fit(ArrayDataSetIterator(X, Y, batch_size=64),
                    epochs=epochs)

        # the memory story: most optimizer-state bytes live split N ways
        frac = sharded_fraction(net.opt_state, wrapper.mesh)
        n = wrapper.mesh.shape["data"]
        ev = net.evaluate(ArrayDataSetIterator(X, Y, batch_size=64))
    print(f"zero_stage={zero_stage} over {n} ranks: "
          f"{frac * 100:.0f}% of optimizer bytes shardable, "
          f"accuracy {ev.accuracy():.3f}")
    # after fit the params are whole again — serialization/eval unchanged
    assert [tuple(t.shape) for t in tree_leaves(net.params)] == shapes
    return ev.accuracy()


if __name__ == "__main__":
    cli(main)
