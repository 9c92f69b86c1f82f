"""Migrating a trained DL4J artifact (and going back).

The reference saves models with `ModelSerializer.writeModel(net, file,
true)` — a zip of configuration.json + coefficients.bin +
updaterState.bin [+ normalizer.bin]. This example round-trips that
format end to end:

  1. train a model here and export it as a DL4J-format zip
     (`save_dl4j_model`), normalizer included;
  2. re-import it (`restore_multilayer_network` + `restore_normalizer`)
     — forward outputs identical, updater state intact;
  3. RESUME training on the imported artifact (the point of carrying
     updater state across).

Run: python -m deeplearning4j_tpu_torch.examples.15_dl4j_artifact_migration
[--device cpu]
"""
import os
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.data.normalization import (
    NormalizerStandardize,
)
from deeplearning4j_tpu_torch.examples._common import cli, device_of, host
from deeplearning4j_tpu_torch.modelimport import (
    add_normalizer_to_model, restore_multilayer_network,
    restore_normalizer, save_dl4j_model,
)
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam


def make_data(n=240, seed=0):
    rs = np.random.RandomState(seed)
    X = np.concatenate([rs.randn(n // 2, 6) * 2 + 3,
                        rs.randn(n // 2, 6) * 2 - 3]).astype("float32")
    Y = np.zeros((n, 2), "float32")
    Y[:n // 2, 0] = 1
    Y[n // 2:, 1] = 1
    return X, Y


def main(epochs=6, tmpdir=None, device=None):
    dev = device_of(device)
    tmpdir = tmpdir or tempfile.gettempdir()
    X, Y = make_data()
    norm = NormalizerStandardize().fit(
        ArrayDataSetIterator(X, Y, batch_size=60))

    conf = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(5e-2))
            .list()
            .layer(DenseLayer(n_out=12, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    it = ArrayDataSetIterator(X, Y, batch_size=60)
    it.set_pre_processor(norm)
    net.fit(it, epochs=epochs)

    # --- export in the reference's on-disk format ------------------------
    path = os.path.join(tmpdir, "migrated_model.zip")
    save_dl4j_model(net, path, save_updater=True)
    add_normalizer_to_model(path, norm)

    # --- a DL4J-side user (or this side, later) re-imports it -----------
    net2 = restore_multilayer_network(path, device=dev)
    norm2 = restore_normalizer(path)
    probe = X[:8]
    a = host(net.output(norm.transform(probe)))
    b = host(net2.output(norm2.transform(probe)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    # --- and training RESUMES (updater state travelled too) -------------
    it2 = ArrayDataSetIterator(X, Y, batch_size=60)
    it2.set_pre_processor(norm2)
    net2.fit(it2, epochs=2)
    acc = net2.evaluate(it2).accuracy()
    print(f"imported artifact resumed training; accuracy={acc:.3f}")
    return acc


if __name__ == "__main__":
    cli(main)
