"""Anomaly detection via autoencoder reconstruction error (tutorial 05).
Train on normal data only; outliers reconstruct poorly.
Run: python -m deeplearning4j_tpu_torch.examples.05_autoencoder_anomaly
[--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.examples._common import cli, device_of, host
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam


def main(epochs=60, device=None):
    dev = device_of(device)
    rs = np.random.RandomState(2)
    normal = rs.randn(400, 8).astype("float32") @ \
        rs.randn(8, 8).astype("float32") * 0.3     # correlated normal data
    outliers = rs.uniform(-4, 4, (20, 8)).astype("float32")

    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=3, activation="tanh"))    # bottleneck
            .layer(OutputLayer(n_out=8, activation="identity", loss="mse"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    net.fit((normal, normal), epochs=epochs, batch_size=100)

    def recon_err(X):
        R = host(net.output(X))
        return ((R - X) ** 2).mean(axis=1)

    e_norm, e_out = recon_err(normal), recon_err(outliers)
    thresh = np.percentile(e_norm, 99)
    detected = (e_out > thresh).mean()
    print(f"normal err {e_norm.mean():.4f}, outlier err {e_out.mean():.4f}, "
          f"outliers flagged at p99 threshold: {detected:.0%}")
    return detected


if __name__ == "__main__":
    cli(main)
