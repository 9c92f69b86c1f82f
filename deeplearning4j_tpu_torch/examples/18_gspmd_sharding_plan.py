"""One mesh, one step: the ShardingPlan (`parallel/plan.py`).

DP x TP x ZeRO as a CONFIG CHOICE in the default `fit()` — no trainer
subclasses, no transports. The plan declares a ("data", "model") mesh
over the process group's ranks, a per-kernel PartitionSpec rule table
(Megatron column-parallel here) and a ZeRO stage; the fit runs the
reduce-scatter / all-gather schedule and the model group's collectives
the plan implies. Launched alone it trains in a one-rank group; with an
even number of ranks the model degree is 2, as in the JAX example.
Run: python -m deeplearning4j_tpu_torch.examples.18_gspmd_sharding_plan
[--device cpu]

The train CLI's ``--mesh`` gives the same without code.
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
    ShardingPlan, ShardingRules, use_mesh,
)
from deeplearning4j_tpu_torch.parallel.distributed import process_count
from deeplearning4j_tpu_torch.parallel.plan import _split_shape


def build_net(device):
    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def main(epochs=10, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(11)
    centers = rs.randn(4, 8) * 3
    X = np.concatenate([centers[i] + rs.randn(64, 8)
                        for i in range(4)]).astype("float32")
    Y = np.eye(4, dtype="float32")[np.repeat(np.arange(4), 64)]
    data = lambda: ArrayDataSetIterator(X, Y, batch_size=64)  # noqa: E731

    with process_group(dev):
        # DP x Megatron-TP x ZeRO-1 in one declaration. data=-1 means "all
        # remaining ranks" — change the numbers, never the code below.
        model = 2 if process_count() % 2 == 0 else 1
        plan = ShardingPlan(data=-1, model=model,
                            rules=ShardingRules.megatron(),
                            zero_stage=1)

        net = build_net(dev)
        net.fit(data(), epochs=epochs, plan=plan)       # explicit form
        w = net.params["0"]["W"]
        spec = plan.param_spec("0/W", w)
        print(f"kernel 0/W: global {tuple(w.shape)}, per-rank piece "
              f"{tuple(_split_shape(tuple(w.shape), spec, plan.mesh()))}, "
              f"spec {spec}")
        acc = net.evaluate((X, Y)).accuracy()
        print(f"train accuracy: {acc:.3f}")

        # process-wide form: unchanged scripts pick the plan up
        plan3 = ShardingPlan(data=-1, zero_stage=3)
        with use_mesh(plan3):
            net2 = build_net(dev)
            net2.fit(data(), epochs=epochs)             # plain call, ZeRO-3
        w2 = net2.params["0"]["W"]
        piece = _split_shape(tuple(w2.shape), plan3.param_spec("0/W", w2),
                             plan3.mesh())
        print(f"zero3 kernel 0/W piece per rank: {tuple(piece)} "
              "(stored 1/N between steps: models larger than one card)")
    return acc


if __name__ == "__main__":
    cli(main)
