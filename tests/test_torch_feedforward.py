"""The port's feed-forward layers (`nn/layers/feedforward.py`, all twelve
classes) against the JAX package.

Each layer gets the reference's parameters moved off their init
constants, as numpy; the forward and the gradients of sum(y * g) with
respect to the parameters and the input (`jax.grad` against autograd)
must agree. Then an MLP on iris through DenseLayer and OutputLayer: the
same `output()` from one zip, and 10 `fit` steps. Tolerances: layers f32
atol 1e-5, rtol 1e-4 (the same f32 math in other orders); the fit's
losses rtol 1e-4 and parameters atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import check_layer, perturbed, to_torch
from deeplearning4j_tpu.data.fetchers import IrisDataSetIterator as JIris
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.conf.base import layer_to_dict
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.data.fetchers import IrisDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.base import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

FF = JInputType.feed_forward


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _pair(name, **kw):
    return getattr(jff, name)(**kw), getattr(pff, name)(**kw)


@pytest.mark.parametrize("kw", [
    dict(n_out=7, activation="tanh"), dict(n_out=5, has_bias=False),
    dict(n_out=6, activation="relu", bias_init=0.3)])
def test_dense_layer(kw):
    jl, pl = _pair("DenseLayer", **kw)
    params, _ = perturbed(jl, FF(9))
    check_layer(jl, pl, params, _x(4, 9))
    assert pl.output_type(FF(9)).to_dict() == FF(kw["n_out"]).to_dict()


def test_element_wise_multiplication_layer():
    jl, pl = _pair("ElementWiseMultiplicationLayer", activation="sigmoid")
    params, _ = perturbed(jl, FF(6))
    check_layer(jl, pl, params, _x(3, 6))
    with pytest.raises(ValueError, match="n_in == n_out"):
        pff.ElementWiseMultiplicationLayer(n_out=4).init(torch.Generator(),
                                                         FF(6))


@pytest.mark.parametrize("ids_shape", [(5,), (5, 1)])
def test_embedding_layer(ids_shape):
    jl, pl = _pair("EmbeddingLayer", n_out=4, n_in=11, has_bias=True)
    params, _ = perturbed(jl, FF(1))
    ids = np.random.RandomState(0).randint(0, 11, ids_shape)
    check_layer(jl, pl, params, ids.astype("float32"))
    with pytest.raises(ValueError, match="outside"):
        pl.apply(to_torch(params), {}, torch.tensor([[11.0]]))


@pytest.mark.parametrize("activation,alpha", [
    ("relu", None), ("leakyrelu", 0.2), ("elu", 0.5), ("softmax", None)])
def test_activation_layer(activation, alpha):
    jl, pl = _pair("ActivationLayer", activation=activation, alpha=alpha)
    check_layer(jl, pl, {}, _x(3, 8))
    assert not pl.has_params()


def test_dropout_layer_is_identity_in_inference_and_draws_in_training():
    jl, pl = _pair("DropoutLayer", dropout=0.25)
    check_layer(jl, pl, {}, _x(3, 8))
    x = torch.ones(400, 50)
    y, _ = pl.apply({}, {}, x, train=True,
                    generator=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    y2, _ = pl.apply({}, {}, x, train=True,
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


@pytest.mark.parametrize("activation,loss", [
    ("softmax", "mcxent"), ("sigmoid", "xent"), ("identity", "mse")])
def test_output_layer_forward_score_and_gradients(activation, loss):
    jl, pl = _pair("OutputLayer", n_out=5, activation=activation, loss=loss)
    params, _ = perturbed(jl, FF(7))
    x = _x(6, 7)
    check_layer(jl, pl, params, x)
    labels = np.eye(5, dtype="float32")[[0, 1, 2, 3, 4, 0]]
    jp = jax.tree_util.tree_map(jax.numpy.asarray, params)

    def jscore(p, xx):
        return jl.score(p, xx, labels, rng=None)

    js, (jgp, jgx) = jax.value_and_grad(jscore, argnums=(0, 1))(
        jp, jax.numpy.asarray(x))
    tp = to_torch(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    s = pl.score(tp, tx, torch.from_numpy(labels))
    grads = torch.autograd.grad(s, tree_leaves(tp) + [tx])
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-5)
    for g, r in zip(grads, jax.tree_util.tree_leaves(jgp) + [jgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-4)


def test_center_loss_output_layer_score():
    jl, pl = _pair("CenterLossOutputLayer", n_out=4, lambda_=0.5)
    params, _ = perturbed(jl, FF(6))
    x = _x(5, 6)
    check_layer(jl, pl, params, x)
    labels = np.eye(4, dtype="float32")[[0, 1, 2, 3, 1]]
    js = jl.score(jax.tree_util.tree_map(jax.numpy.asarray, params),
                  jax.numpy.asarray(x), labels)
    ps = pl.score(to_torch(params), torch.from_numpy(x),
                  torch.from_numpy(labels))
    np.testing.assert_allclose(ps.item(), float(js), rtol=1e-5)


def test_loss_layer():
    jl, pl = _pair("LossLayer", activation="sigmoid", loss="xent")
    x = _x(4, 3)
    check_layer(jl, pl, {}, x)
    labels = (np.random.RandomState(1).rand(4, 3) > 0.5).astype("float32")
    np.testing.assert_allclose(
        pl.score({}, torch.from_numpy(x), torch.from_numpy(labels)).item(),
        float(jl.score({}, x, labels)), rtol=1e-5)


def test_autoencoder_encoder_and_pretrain_score():
    jl, pl = _pair("AutoEncoder", n_out=4, corruption_level=0.0)
    params, _ = perturbed(jl, FF(6))
    x = _x(5, 6)
    check_layer(jl, pl, params, x)
    js = jl.pretrain_score(jax.tree_util.tree_map(jax.numpy.asarray, params),
                           jax.numpy.asarray(x), None)
    ps = pl.pretrain_score(to_torch(params), torch.from_numpy(x))
    np.testing.assert_allclose(ps.item(), float(js), rtol=1e-5)
    assert sorted(params) == ["W", "b", "vb"]


def test_repeat_vector():
    jl, pl = _pair("RepeatVector", n=3)
    check_layer(jl, pl, {}, _x(2, 5))
    assert pl.output_type(FF(5)).shape == (3, 5)


@pytest.mark.parametrize("dims,shape", [((2, 1), (2, 3, 4)),
                                        ((1, 3, 2), (2, 3, 4, 5))])
def test_permute_layer(dims, shape):
    jl, pl = _pair("PermuteLayer", dims=dims)
    check_layer(jl, pl, {}, _x(*shape))


@pytest.mark.parametrize("target", [(4, 6), (2, -1, 3), (24,)])
def test_reshape_layer(target):
    jl, pl = _pair("ReshapeLayer", target=target)
    check_layer(jl, pl, {}, _x(2, 6, 4))
    it = JInputType.recurrent(4, 6)
    assert pl.output_type(it).to_dict() == jl.output_type(it).to_dict()
    with pytest.raises(ValueError, match="Reshape"):
        pff.ReshapeLayer(target=(5, 5)).apply({}, {}, torch.zeros(2, 6, 4))


@pytest.mark.parametrize("name", [
    "DenseLayer", "ElementWiseMultiplicationLayer", "EmbeddingLayer",
    "ActivationLayer", "DropoutLayer", "OutputLayer", "CenterLossOutputLayer",
    "LossLayer", "AutoEncoder", "RepeatVector", "PermuteLayer",
    "ReshapeLayer"])
def test_config_serde_and_init_tree_match(name):
    kw = {"n_out": 4} if "n_out" in getattr(jff, name).__dataclass_fields__ \
        else {}
    jl = getattr(jff, name)(**kw)
    pl = layer_from_dict(layer_to_dict(jl))
    assert type(pl) is getattr(pff, name)
    it = FF(4) if name != "PermuteLayer" else JInputType.recurrent(4, 3)
    jp, _ = jl.init(jax.random.PRNGKey(0), it)
    pp, _ = pl.init(torch.Generator().manual_seed(0), it)
    assert jax.tree_util.tree_map(np.shape, jp) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), pp)


# --------------------------------------------------------------- iris MLP
def _iris_conf(builder_cls, layers_mod, updater):
    return (builder_cls.Builder().seed(3).updater(updater).l2(1e-3).list()
            .layer(layers_mod.DenseLayer(n_out=16, activation="relu"))
            .layer(layers_mod.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers_mod.OutputLayer(n_out=3))
            .set_input_type(FF(4)).build())


def test_iris_mlp_output_and_ten_fit_steps_match_jax(tmp_path):
    jnet = JMLN(_iris_conf(JNNC, jff, JAdam(1e-2))).init()
    path = str(tmp_path / "mlp.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    X = next(iter(JIris(batch_size=150))).features
    np.testing.assert_allclose(pnet.output(X).numpy(),
                               np.asarray(jnet.output(X)), atol=1e-6)
    jc, pc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    pnet.set_listeners(pc)
    jnet.fit(JIris(batch_size=30), epochs=2, scan_steps=1, prefetch=False)
    pnet.fit(IrisDataSetIterator(batch_size=30), epochs=2)
    assert len(pc.scores) == len(jc.scores) == 10
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-4)
    for p, j in zip(tree_leaves(pnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)
