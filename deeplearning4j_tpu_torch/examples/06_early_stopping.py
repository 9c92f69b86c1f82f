"""Early stopping on a held-out iterator (tutorial 09).
Run: python -m deeplearning4j_tpu_torch.examples.06_early_stopping
[--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.examples._common import cli, device_of
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.train.earlystopping import (
    DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
    MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition,
)


def main(max_epochs=60, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(4)
    centers = rs.randn(3, 5) * 3
    X = np.concatenate([centers[i] + rs.randn(80, 5)
                        for i in range(3)]).astype("float32")
    Y = np.eye(3, dtype="float32")[np.repeat(np.arange(3), 80)]
    perm = rs.permutation(240)
    X, Y = X[perm], Y[perm]
    train = ArrayDataSetIterator(X[:180], Y[:180], batch_size=60)
    val = ArrayDataSetIterator(X[180:], Y[180:], batch_size=60)

    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(5e-3))
            .list()
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(5))
            .build())
    es = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(val),
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(max_epochs),
            ScoreImprovementEpochTerminationCondition(5),
        ])
    result = EarlyStoppingTrainer(
        es, MultiLayerNetwork(conf, device=dev), train).fit()
    print(f"stopped at epoch {result.total_epochs} "
          f"(best epoch {result.best_model_epoch}, "
          f"best score {result.best_model_score:.4f}); "
          f"reason: {result.termination_reason}")
    return result


if __name__ == "__main__":
    cli(main)
