"""Import a Keras model and keep training it here (KerasModelImport
quickstart). Needs keras and h5py; where either is missing it raises
saying so. Run: python -m deeplearning4j_tpu_torch.examples.09_keras_import
[--device cpu]"""
import os
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.examples._common import cli, device_of, host

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")


def _needs():
    missing = []
    for name in ("keras", "h5py"):
        try:
            __import__(name)
        except ImportError:
            missing.append(name)
    if missing:
        raise RuntimeError(
            f"example 09 needs {' and '.join(missing)} (the Keras model is "
            "written and read as an HDF5 file), which this Python does "
            "not have")


def main(tmpdir=None, device=None):
    dev = device_of(device)
    _needs()
    import keras

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    tmpdir = tmpdir or tempfile.gettempdir()
    m = keras.Sequential([
        keras.layers.Input((10,)),
        keras.layers.Dense(24, activation="relu"),
        keras.layers.Dropout(0.1),
        keras.layers.Dense(3, activation="softmax"),
    ])
    path = f"{tmpdir}/keras_example.h5"
    m.save(path)
    net = KerasModelImport.import_keras_sequential_model_and_weights(
        path, device=dev)
    x = np.random.RandomState(0).randn(4, 10).astype("float32")
    np.testing.assert_allclose(host(net.output(x)), np.asarray(m(x)),
                               atol=1e-5)
    print("imported with exact forward parity; fine-tuning...")
    rs = np.random.RandomState(1)
    X = rs.randn(90, 10).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 90)]
    net.fit((X, Y), epochs=3, batch_size=30)
    print("score after fine-tune:", round(net.score(), 4))
    return net


if __name__ == "__main__":
    cli(main)
