"""The port's `nn/regularization.py` against the JAX package: the dropout
objects, weight noise and constraints, and their wiring into both fit
steps.

Noise comes from other random streams than the reference's (a
`torch.Generator`, not a JAX key), so it is held to the reference by its
distribution: keep rates, the moments of its output on the same large
input, and its masks' expectations, never element by element.
Constraints are deterministic and are held elementwise (f32 atol 1e-6),
and so are three `fit` steps of a constrained network (losses rtol
1e-5, parameters atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import regularization as jreg
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.conf.base import layer_to_dict as jax_layer_to_dict
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.nn import regularization as preg
from deeplearning4j_tpu_torch.nn.conf.base import InputType, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

N = 200_000


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _moments(a):
    a = np.asarray(a, np.float64)
    return a.mean(), a.std()


@pytest.mark.parametrize("name,kw", [
    ("Dropout", dict(p=0.3)), ("AlphaDropout", dict(p=0.1)),
    ("GaussianDropout", dict(rate=0.2)), ("GaussianNoise", dict(stddev=0.3)),
    ("SpatialDropout", dict(p=0.4))])
def test_dropout_objects_match_by_distribution(name, kw):
    x = np.random.RandomState(0).randn(N // 50, 5, 10).astype("float32")
    jy = getattr(jreg, name)(**kw).apply(jnp.asarray(x),
                                         jax.random.PRNGKey(1))
    py = getattr(preg, name)(**kw).apply(torch.from_numpy(x), _gen(1))
    (jm, js), (pm, ps) = _moments(jy), _moments(py.numpy())
    assert abs(jm - pm) < 0.01 and abs(js - ps) < 0.01
    # reproducible from the generator, and not the identity
    again = getattr(preg, name)(**kw).apply(torch.from_numpy(x), _gen(1))
    assert torch.equal(py, again) and not torch.equal(py, torch.from_numpy(x))


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_dropout_keep_rate_and_inverted_scale(p):
    x = torch.ones(N)
    y = preg.Dropout(p=p).apply(x, _gen(2))
    kept = (y != 0).double().mean().item()
    assert abs(kept - (1 - p)) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - p)))
    assert abs(y.double().mean().item() - 1.0) < 0.01   # expectation kept


def test_spatial_dropout_drops_whole_channels():
    x = torch.ones(400, 3, 4, 20)
    y = preg.SpatialDropout(p=0.5).apply(x, _gen(3))
    per_channel = y.permute(0, 3, 1, 2).reshape(400, 20, -1)
    assert bool(((per_channel == 0).all(-1) |
                 (per_channel == 2.0).all(-1)).all())
    assert abs((per_channel[..., 0] == 0).double().mean().item() - 0.5) < 0.03


def test_alpha_dropout_keeps_selu_moments():
    x = torch.randn(N, generator=_gen(4))
    y = preg.AlphaDropout(p=0.2).apply(x, _gen(5))
    assert abs(y.mean().item()) < 0.02 and abs(y.std().item() - 1.0) < 0.02


@pytest.mark.parametrize("to_bias", [False, True])
def test_drop_connect_masks_weights_and_spares_biases(to_bias):
    params = {"W": torch.ones(300, 300), "b": torch.ones(300)}
    out = preg.DropConnect(p=0.3, apply_to_bias=to_bias).transform(
        params, _gen(6))
    kept = (out["W"] != 0).double().mean().item()
    assert abs(kept - 0.7) < 0.01
    assert abs(out["W"].double().mean().item() - 1.0) < 0.01
    assert torch.equal(out["b"], params["b"]) != to_bias


@pytest.mark.parametrize("additive", [True, False])
def test_weight_noise_matches_by_distribution(additive):
    w = np.full((400, 500), 2.0, np.float32)
    jl = jreg.WeightNoise(stddev=0.1, additive=additive)
    pl = preg.WeightNoise(stddev=0.1, additive=additive)
    jo = jl.transform({"W": jnp.asarray(w), "b": jnp.zeros(3)},
                      jax.random.PRNGKey(0))
    po = pl.transform({"W": torch.from_numpy(w), "b": torch.zeros(3)},
                      _gen(7))
    (jm, js), (pm, ps) = _moments(jo["W"]), _moments(po["W"].numpy())
    assert abs(jm - pm) < 0.005 and abs(js - ps) < 0.005
    assert torch.equal(po["b"], torch.zeros(3))


@pytest.mark.parametrize("name,kw", [
    ("MaxNormConstraint", dict(max_norm=1.5)),
    ("MinMaxNormConstraint", dict(min_norm=0.5, max_norm=1.2, rate=0.7)),
    ("NonNegativeConstraint", {}), ("UnitNormConstraint", {})])
@pytest.mark.parametrize("shape", [(6, 4), (3, 3, 2, 5), (7,)])
def test_constraints_project_as_the_reference(name, kw, shape):
    w = np.random.RandomState(1).randn(*shape).astype("float32")
    jw = getattr(jreg, name)(**kw).project(jnp.asarray(w))
    pw = getattr(preg, name)(**kw).project(torch.from_numpy(w))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("to_bias", [False, True])
def test_apply_constraints_in_place_and_bias_rule(to_bias):
    layer = pff.DenseLayer(n_out=3, constraints=(
        preg.NonNegativeConstraint(apply_to_bias=to_bias),))
    params = {"0": {"W": -torch.ones(2, 3), "b": -torch.ones(3)}}
    w = params["0"]["W"]
    preg.apply_constraints({"0": layer}, params)
    assert params["0"]["W"] is w and bool((w == 0).all())
    assert bool((params["0"]["b"] == 0).all()) == to_bias


@pytest.mark.parametrize("obj", [
    jreg.Dropout(p=0.2), jreg.AlphaDropout(), jreg.GaussianDropout(),
    jreg.GaussianNoise(), jreg.SpatialDropout(), jreg.DropConnect(p=0.1),
    jreg.WeightNoise(additive=False), jreg.MaxNormConstraint(max_norm=3.0),
    jreg.MinMaxNormConstraint(), jreg.NonNegativeConstraint(),
    jreg.UnitNormConstraint(apply_to_bias=True)])
def test_config_objects_read_from_the_reference_json(obj):
    port = layer_from_dict(jax_layer_to_dict(obj))
    assert type(port).__name__ == type(obj).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(obj)


def test_layer_dropout_field_takes_objects_and_refuses_others():
    x = torch.ones(64, 100)
    layer = pff.DenseLayer(n_out=4, dropout=preg.GaussianNoise(stddev=0.5))
    y = layer.maybe_dropout_input(x, True, _gen(8))
    assert abs(y.std().item() - 0.5) < 0.02
    assert torch.equal(layer.maybe_dropout_input(x, False, _gen(8)), x)
    bad = pff.DenseLayer(n_out=4, dropout={"@class": "Dropout"})
    with pytest.raises(TypeError, match="IDropout"):
        bad.maybe_dropout_input(x, True, _gen(8))


# ---------------------------------------------------- wired into the fits
def _conf(nnc, ff, input_type, updater, **layer_kw):
    return (nnc.Builder().seed(1).updater(updater).list()
            .layer(ff.DenseLayer(n_out=8, activation="tanh", **layer_kw))
            .layer(ff.OutputLayer(n_out=3))
            .set_input_type(input_type.feed_forward(5)).build())


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(24, 5).astype("float32"),
            np.eye(3, dtype="float32")[rs.randint(0, 3, 24)])


def test_constrained_fit_matches_jax(tmp_path):
    jnet = JMLN(_conf(JNNC, jff, JInputType, JSgd(0.5), constraints=(
        jreg.MaxNormConstraint(max_norm=0.6),
        jreg.NonNegativeConstraint(apply_to_bias=True)))).init()
    path = str(tmp_path / "c.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    X, Y = _data()
    jc, pc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    pnet.set_listeners(pc)
    jnet.fit((X, Y), batch_size=8, scan_steps=1, prefetch=False)
    pnet.fit((X, Y), batch_size=8)
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-5)
    for p, j in zip(tree_leaves(pnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-6)
    w = pnet.params["0"]["W"]
    assert bool((w >= 0).all()) and \
        float(torch.sqrt((w * w).sum(0)).max()) <= 0.6 + 1e-6


@pytest.mark.parametrize("kw", [
    dict(weight_noise=preg.DropConnect(p=0.3)),
    dict(weight_noise=preg.WeightNoise(stddev=0.2)),
    dict(dropout=preg.AlphaDropout(p=0.2))])
def test_noisy_fit_draws_from_the_epoch_generator(kw):
    conf = _conf(NeuralNetConfiguration, pff, InputType, Sgd(0.1), **kw)
    X, Y = _data(1)
    runs = []
    for _ in range(2):
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.fit((X, Y), batch_size=8)
        runs.append(tree_leaves(net.params))
    clean = MultiLayerNetwork(_conf(NeuralNetConfiguration, pff, InputType,
                                    Sgd(0.1)), device="cpu").init()
    clean.fit((X, Y), batch_size=8)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert any(not torch.allclose(a, b) for a, b in
               zip(runs[0], tree_leaves(clean.params)))
    # inference never draws noise
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert torch.equal(net.output(X), net.output(X))
