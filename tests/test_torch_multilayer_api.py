"""The four public methods of the port's MultiLayerNetwork that the
reference has and the port lacked: `feed_forward`, `summary`,
`params_flat`, `set_params_flat`. Each is held to the reference on one
zip written by the reference (weights perturbed off their init).

Tolerances: activations f32 atol 1e-5 (convolution and dense layers of a
few units, the layers' existing tolerance); the flat vector bitwise
(a reordering or a cast would show); outputs after `set_params_flat`
atol 1e-5 against the reference and bitwise against the port itself.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import load_model

ATOL = 1e-5


def _conf(dropout=None):
    return (JNNC.Builder().seed(5).updater(JAdam(1e-3)).list()
            .layer(jconv.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                          activation="relu"))
            .layer(jnorm.BatchNormalization())
            .layer(jconv.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(jff.DenseLayer(n_out=7, activation="tanh",
                                  dropout=dropout))
            .layer(jff.DropoutLayer(0.5) if dropout else
                   jff.DenseLayer(n_out=6, activation="sigmoid"))
            .layer(jff.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.convolutional(8, 8, 2)).build())


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jnet = JMLN(_conf()).init()
    rs = np.random.RandomState(3)
    jnet.set_params_flat(np.asarray(jnet.params_flat())
                         + rs.randn(jnet.num_params()).astype("float32") * 0.1)
    path = str(tmp_path_factory.mktemp("mln") / "net.zip")
    jax_save(jnet, path)
    return jnet, path


def _x(seed=0):
    return np.random.RandomState(seed).randn(5, 8, 8, 2).astype("float32")


def test_feed_forward_matches_the_reference(nets):
    jnet, path = nets
    pnet = load_model(path, device="cpu")
    assert isinstance(pnet, MultiLayerNetwork)
    acts = pnet.feed_forward(_x())
    jacts = jnet.feed_forward(_x())
    assert len(acts) == len(jacts) == 6
    for a, b in zip(acts, jacts):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    torch.testing.assert_close(acts[-1], pnet.output(_x()), rtol=0, atol=0)


def test_params_flat_order_and_values_match_the_reference(nets):
    jnet, path = nets
    pnet = load_model(path, device="cpu")
    flat = pnet.params_flat()
    assert flat.dtype == torch.float32
    assert pnet.num_params() == jnet.num_params() == flat.numel()
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jnet.params_flat()))


def test_set_params_flat_round_trip(nets):
    jnet, path = nets
    pnet = load_model(path, device="cpu")
    x = _x(1)
    before = pnet.output(x).clone()
    pnet.set_params_flat(pnet.params_flat())
    torch.testing.assert_close(pnet.output(x), before, rtol=0, atol=0)
    new = (np.asarray(jnet.params_flat())
           * np.float32(0.9)).astype("float32")
    pnet.set_params_flat(new)
    np.testing.assert_array_equal(pnet.params_flat().numpy(), new)
    jnet2 = JMLN(_conf()).init()
    jnet2.set_params_flat(new)
    jnet2.state = jnet.state
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet2.output(x)), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="flat vector"):
        pnet.set_params_flat(np.concatenate([new, new[:1]]))


def test_summary_matches_the_reference(nets):
    jnet, path = nets
    pnet = load_model(path, device="cpu")
    text = pnet.summary()
    assert text == jnet.summary()
    assert f"{jnet.num_params():,}" in text.splitlines()[-1]
    fresh = MultiLayerNetwork(load_model(path, device="cpu").conf,
                              device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        fresh.summary()


def test_train_mode_feed_forward_draws_dropout_noise(tmp_path):
    jnet = JMLN(_conf(dropout=0.5)).init()
    jax_save(jnet, str(tmp_path / "drop.zip"))
    pnet = load_model(str(tmp_path / "drop.zip"), device="cpu")
    x = _x(2)
    ev = pnet.feed_forward(x)
    a = pnet.feed_forward(x, train=True,
                          rng=torch.Generator().manual_seed(11))
    b = pnet.feed_forward(x, train=True,
                          rng=torch.Generator().manual_seed(11))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    # the dense layer's input dropout and the DropoutLayer: about half
    # the units are zero in train mode, none in eval
    assert not torch.equal(a[3], ev[3]) and not torch.equal(a[4], ev[4])
    zeros = float((a[4] == 0).float().mean())
    assert 0.3 < zeros < 0.7 and float((ev[4] == 0).float().mean()) == 0.0
    # without a generator each call draws fresh noise
    c = pnet.feed_forward(x, train=True)
    d = pnet.feed_forward(x, train=True)
    assert not torch.equal(c[4], d[4])
    # the layers before the first dropout are unchanged in train mode
    # except batch norm, which normalizes with the batch's statistics
    torch.testing.assert_close(a[0], ev[0], rtol=0, atol=0)
