"""LeNet-style CNN on the handwritten digits scikit-learn bundles (a copy
sits beside the examples; tutorial 07's conv role, zoo LeNet config).
Run: python -m deeplearning4j_tpu_torch.examples.03_cnn_digits
[--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.examples._common import (
    cli, device_of, load_digits,
)
from deeplearning4j_tpu_torch.models.zoo import LeNet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def main(epochs=3, n_train=1500, device=None):
    dev = device_of(device)
    images, target = load_digits()
    X8 = images.astype("float32") / 16.0
    X = np.pad(np.repeat(np.repeat(X8, 3, axis=1), 3, axis=2),
               ((0, 0), (2, 2), (2, 2)))[..., None]
    Y = np.eye(10, dtype="float32")[target]
    net = MultiLayerNetwork(LeNet().conf(), device=dev).init()
    net.fit(ArrayDataSetIterator(X[:n_train], Y[:n_train], batch_size=100),
            epochs=epochs)
    ev = net.evaluate(ArrayDataSetIterator(X[n_train:], Y[n_train:],
                                           batch_size=99))
    print(f"holdout accuracy after {epochs} epochs: {ev.accuracy():.3f}")
    print(ev.stats())
    return ev.accuracy()


if __name__ == "__main__":
    cli(main, epochs=6)
