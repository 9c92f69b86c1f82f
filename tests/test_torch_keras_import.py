"""The port's Keras importer (`modelimport/keras.py`) against the JAX
package's and against live Keras models.

- Every case of `tests/test_keras_import.py` runs against the port
  (`_torch_reference_cases.port_cases`, networks on the CPU). Each archive
  a case writes is imported by both packages: the parameters (and layer
  state) bitwise equal, and every `output()` the case asks for before the
  network trains within 1e-5 of the reference's, besides the case's own
  check against Keras.
- The three cases that drive a mapped layer through JAX directly
  (LocallyConnected1D/2D, LRN) are rewritten here on the port's layers.
- A JSON config imports without h5py; an archive without h5py raises
  naming it, also through the serving registry (`ModelLoadError`), and
  `.h5` sources serve through `load_servable`.
"""
import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
keras = pytest.importorskip("keras")

from _torch_reference_cases import port_cases, run_case  # noqa: E402
from deeplearning4j_tpu.modelimport import keras as RK  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras as PK  # noqa: E402

_JAX_CASES = ("test_locally_connected_config_import",
              "test_locally_connected_2d_math", "test_lrn_config_mapping")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _imported_by_both(path, sequential):
    """Import `path` with both packages; the port's network comes back
    with its `output` checked against the reference's until it trains."""
    if sequential:
        ref = RK.KerasModelImport.import_keras_sequential_model_and_weights(
            path)
        net = PK.KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")
    else:
        ref = RK.KerasModelImport.import_keras_model_and_weights(path)
        net = PK.KerasModelImport.import_keras_model_and_weights(
            path, device="cpu")
    p, r = _leaves(net.params), _leaves(ref.params)
    assert p.keys() == r.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    ps, rs = _leaves(net.state), _leaves(ref.state)
    for k in rs:
        np.testing.assert_array_equal(ps[k], rs[k], err_msg=k)
    live = {"on": True}
    port_output, port_fit = net.output, net.fit

    def output(*xs, **kw):
        y = port_output(*xs, **kw)
        if live["on"]:
            np.testing.assert_allclose(_np(_first(y)),
                                       np.asarray(_first(ref.output(*xs))),
                                       rtol=1e-5, atol=1e-5)
        return y

    def fit(*a, **kw):
        live["on"] = False
        return port_fit(*a, **kw)
    net.output, net.fit = output, fit
    return net


_REF = port_cases("tests/test_keras_import.py", extra_subs=(
    ("KerasModelImport.import_keras_sequential_model_and_weights(",
     "_both_sequential("),
    ("KerasModelImport.import_keras_model_and_weights(", "_both_any(")))
_REF._both_sequential = lambda p: _imported_by_both(p, True)
_REF._both_any = lambda p: _imported_by_both(p, False)
_REF.keras = keras
REFERENCE_CASES = [n for n in sorted(vars(_REF))
                   if n.startswith("test_") and n not in _JAX_CASES]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case(name, request):
    run_case(_REF, name, request)


# ------------------------------------------ the JAX-driven cases, rewritten
def _init(layer, input_type, seed):
    return layer.init(torch.Generator().manual_seed(seed), input_type,
                      torch.float32)


def test_locally_connected_config_import():
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    layer, loader = PK._map_layer(
        "LocallyConnected1D",
        {"filters": 4, "kernel_size": [3], "strides": [1],
         "padding": "valid", "activation": "linear", "use_bias": True},
        False, sequence=True)
    params, state = _init(layer, InputType.recurrent(2, 6), 0)
    assert tuple(params["W"].shape) == (4, 3 * 2, 4)   # (ot, k*c, f)
    rs = np.random.RandomState(19)
    W = rs.randn(4, 6, 4).astype("float32")
    b = rs.randn(4, 4).astype("float32")
    loader(params, state, [W, b])
    x = rs.randn(2, 6, 2).astype("float32")
    y, _ = layer.apply(params, state, torch.from_numpy(x))
    want = np.zeros((2, 4, 4), np.float32)
    for o in range(4):
        patch = x[:, o:o + 3, :].reshape(2, -1)
        want[:, o, :] = patch @ W[o] + b[o]
    np.testing.assert_allclose(_np(y), want, atol=1e-5)


def test_locally_connected_2d_math():
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    layer, loader = PK._map_layer(
        "LocallyConnected2D",
        {"filters": 3, "kernel_size": [2, 2], "strides": [1, 1],
         "padding": "valid", "activation": "linear", "use_bias": True},
        False)
    params, state = _init(layer, InputType.convolutional(4, 5, 2), 1)
    oh, ow = 3, 4
    assert tuple(params["W"].shape) == (oh * ow, 2 * 2 * 2, 3)
    rs = np.random.RandomState(20)
    W = rs.randn(oh * ow, 8, 3).astype("float32")
    b = rs.randn(oh, ow, 3).astype("float32")
    loader(params, state, [W, b])
    x = rs.randn(2, 4, 5, 2).astype("float32")
    y, _ = layer.apply(params, state, torch.from_numpy(x))
    want = np.zeros((2, oh, ow, 3), np.float32)
    for i in range(oh):
        for j in range(ow):
            patch = x[:, i:i + 2, j:j + 2, :].reshape(2, -1)
            want[:, i, j, :] = patch @ W[i * ow + j] + b[i, j]
    np.testing.assert_allclose(_np(y), want, atol=1e-5)


def test_lrn_config_mapping():
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    layer, loader = PK._map_layer(
        "LRN", {"k": 1.0, "n": 3, "alpha": 0.01, "beta": 0.5}, False)
    ref, _ = RK._map_layer(
        "LRN", {"k": 1.0, "n": 3, "alpha": 0.01, "beta": 0.5}, False)
    assert loader is None
    assert (layer.k, layer.n, layer.alpha, layer.beta) \
        == (ref.k, ref.n, ref.alpha, ref.beta)
    params, state = _init(layer, InputType.convolutional(4, 4, 6), 0)
    x = np.random.RandomState(25).randn(2, 4, 4, 6).astype("float32")
    y, _ = layer.apply(params, state, torch.from_numpy(x))
    assert tuple(y.shape) == x.shape and bool(torch.isfinite(y).all())


def test_weight_of_the_wrong_shape_raises():
    layer, loader = PK._map_layer(
        "Dense", {"units": 3, "activation": "relu"}, False)
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    params, state = _init(layer, InputType.feed_forward(4), 0)
    with pytest.raises(ValueError, match="does not fit"):
        loader(params, state, [np.zeros((5, 3), np.float32)])


# ------------------------------------------------------- h5py, the registry
def _vgg_like_config():
    """A Sequential config in Keras's JSON, written by hand (no Keras)."""
    def conv(n, name):
        return {"class_name": "Conv2D", "config": {
            "name": name, "filters": n, "kernel_size": [3, 3],
            "strides": [1, 1], "padding": "same", "activation": "relu",
            "use_bias": True}}
    return {"class_name": "Sequential", "config": {"name": "tiny", "layers": [
        {"class_name": "InputLayer",
         "config": {"batch_shape": [None, 8, 8, 3], "name": "in"}},
        conv(4, "c1"),
        {"class_name": "MaxPooling2D", "config": {
            "name": "p1", "pool_size": [2, 2], "strides": [2, 2],
            "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        {"class_name": "Dense", "config": {"name": "d", "units": 5,
                                           "activation": "softmax"}}]}}


def test_configuration_import_needs_no_h5py(tmp_path, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump(_vgg_like_config(), f)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    net = PK.KerasModelImport.import_keras_model_configuration(
        path, device="cpu")
    ref = RK.KerasModelImport.import_keras_model_configuration(path)
    assert [type(l).__name__ for l in net.conf.layers] \
        == [type(l).__name__ for l in ref.conf.layers]
    net.init()
    assert tuple(net.output(np.zeros((2, 8, 8, 3), np.float32)).shape) \
        == (2, 5)
    # an archive without h5py: raises naming it, in the importer and in
    # the serving registry
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelLoadError, load_servable,
    )
    h5 = tmp_path / "m.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n")
    with pytest.raises(ImportError, match="h5py"):
        PK.KerasModelImport.import_keras_model_and_weights(str(h5),
                                                           device="cpu")
    with pytest.raises(ModelLoadError, match="h5py"):
        load_servable(str(h5), device="cpu")


@pytest.fixture(scope="module")
def mlp_h5(tmp_path_factory):
    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(3, activation="softmax"),
    ])
    path = str(tmp_path_factory.mktemp("keras") / "m.h5")
    m.save(path)
    return path, m


@pytest.mark.parametrize("suffix", [".h5", ".keras"])
def test_registry_serves_keras_archives(mlp_h5, suffix, tmp_path):
    """`load_servable` takes `.h5`/`.keras` sources onto the registry's
    device (an HDF5 archive under either suffix, as the reference reads
    both through h5py)."""
    import shutil

    from deeplearning4j_tpu_torch.serving import ModelRegistry
    path, model = mlp_h5
    src = str(tmp_path / f"m{suffix}")
    shutil.copy(path, src)
    reg = ModelRegistry(device="cpu")
    reg.deploy("k", src)
    served = reg.get("k")
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    net = served.versions[served.active].model
    assert net.device.type == "cpu"
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(model(x)),
                               atol=1e-5)
    ref = RK.KerasModelImport.import_keras_model_and_weights(src)
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(ref.output(x)),
                               rtol=1e-5, atol=1e-5)


def test_import_defaults_to_cuda(mlp_h5):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PK.KerasModelImport.import_keras_model_and_weights(mlp_h5[0])
