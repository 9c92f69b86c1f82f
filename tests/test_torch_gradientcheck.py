"""The port's gradientcheck against the JAX package's, on the CPU.

Each case is a reference network saved to a zip and loaded by the port;
both packages' `check_gradients` run on it with one seed (f64 central
differences against autodiff, the reference's relative-error rule and
entry sampling). Their verdicts must agree: the same pass or fail, the
same number of entries checked, both worst relative errors under the
threshold when passing; and where a layer's backward is wrong on purpose
(a tanh whose gradient is doubled, in each framework), both fail on the
same entries. The cases are the recurrent ones of
tests/test_gradientcheck.py:207-249,478, the graph's per-input masks
(tests/test_graph_rnn.py:119), and the VAE and YOLO ones of
tests/test_gradientcheck.py:302- (a VAE under a softmax head, a conv
backbone under the YOLOv2 loss, and the ELBO itself by central
differences with its noise fixed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.gradientcheck import check_gradients as j_check
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    GraphBuilder as JGB, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers import samediff as jsd
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch import gradientcheck as pgc
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import samediff as psd
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, params_from_numpy,
)


def _rnn_data(seed=12345, n=3, t=5, f=4, c=2):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, t, f).astype("float32")
    Y = np.eye(c, dtype="float32")[rs.randint(0, c, (n, t))]
    mask = np.ones((n, t), "float32")
    mask[1, 3:] = 0
    mask[2, 2:] = 0
    return X, Y, mask


def _net(layers):
    lb = JNNC.Builder().seed(0).updater(JSgd(1e-2)).list()
    for layer in layers:
        lb = lb.layer(layer)
    return JMLN(lb.set_input_type(JIT.recurrent(4, 5)).build()).init()


def _head():
    return jl.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")


CASES = {
    "graves_lstm_unmasked": (lambda: _net([jl.GravesLSTM(n_out=5), _head()]),
                             "none"),
    "graves_lstm_masked": (lambda: _net([jl.GravesLSTM(n_out=5), _head()]),
                           "features"),
    "graves_bidirectional_unmasked": (
        lambda: _net([jl.GravesBidirectionalLSTM(n_out=4), _head()]), "none"),
    "graves_bidirectional_masked": (
        lambda: _net([jl.GravesBidirectionalLSTM(n_out=4), _head()]),
        "features"),
    "simple_rnn_bidirectional": (
        lambda: _net([jl.Bidirectional(layer=jl.SimpleRnn(n_out=4)),
                      _head()]), "features"),
    "lstm_last_time_step": (
        lambda: _net([jl.LastTimeStep(layer=jl.LSTM(n_out=5)),
                      jl.OutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent")]), "features_ff"),
    "lstm_global_pooling": (
        lambda: _net([jl.LSTM(n_out=5),
                      jl.GlobalPoolingLayer(pooling_type="avg"),
                      jl.OutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent")]), "features_ff"),
    "rnn_loss_label_masked": (
        lambda: _net([jl.LSTM(n_out=4),
                      jl.RnnLossLayer(activation="identity", loss="mse")]),
        "labels"),
    "gru_reset_after": (lambda: _net([jl.GRU(n_out=5), _head()]),
                        "features"),
    "gru_classic": (lambda: _net([jl.GRU(n_out=5, reset_after=False),
                                  _head()]), "features"),
}


def _inputs(data):
    X, Y, mask = _rnn_data()
    if data == "features_ff":
        Y = np.eye(2, dtype="float32")[np.random.RandomState(1).randint(
            0, 2, 3)]
    if data == "labels":
        Y = np.random.RandomState(2).rand(3, 5, 4).astype("float32")
        lmask = np.ones((3, 5), "float32")
        lmask[:, -2:] = 0
        return X, Y, None, lmask
    return X, Y, (None if data == "none" else mask), None


def _verdicts(jnet, pnet, X, Y, fm, lm, **kw):
    jres = j_check(jnet, X, Y, features_mask=fm, labels_mask=lm,
                   max_per_param=8, **kw)
    pres = pgc.check_gradients(pnet, X, Y, features_mask=fm, labels_mask=lm,
                               max_per_param=8, **kw)
    return jres, pres


@pytest.mark.parametrize("name", sorted(CASES))
def test_verdicts_agree_with_the_reference(tmp_path, name):
    make, data = CASES[name]
    jnet = make()
    path = str(tmp_path / "gc.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    X, Y, fm, lm = _inputs(data)
    jres, pres = _verdicts(jnet, pnet, X, Y, fm, lm)
    assert jres.passed and pres.passed, (pres.worst_param,
                                         pres.max_rel_error, pres.failures)
    assert pres.n_params_checked == jres.n_params_checked
    assert pres.max_rel_error <= pgc.DEFAULT_MAX_REL_ERROR
    # a threshold nothing meets: both fail
    jres, pres = _verdicts(jnet, pnet, X, Y, fm, lm, max_rel_error=1e-14,
                           min_abs_error=0.0)
    assert not jres.passed and not pres.passed
    assert pres.n_params_checked == jres.n_params_checked
    # the check leaves the model as it was
    assert pnet._compute_dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tree_leaves(pnet.params))


def _np_params(seed=3):
    rs = np.random.RandomState(seed)
    return {"W": (0.5 * rs.randn(4, 6)).astype("float32")}


def _j_bad_tanh():
    @jax.custom_vjp
    def f(x):
        return jnp.tanh(x)

    def fwd(x):
        y = jnp.tanh(x)
        return y, y

    def bwd(y, g):
        return (2.0 * g * (1 - y * y),)       # twice the true gradient

    f.defvjp(fwd, bwd)
    return f


class _BadTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 2.0 * g * (1 - y * y)          # twice the true gradient


@pytest.mark.parametrize("wrong", [False, True], ids=["right", "wrong"])
def test_a_wrong_backward_fails_on_the_same_entries(wrong):
    """A SameDiffLayer whose backward is deliberately wrong in each
    framework: both checks fail, on the same entries."""
    jt = _j_bad_tanh() if wrong else jnp.tanh
    pt = _BadTanh.apply if wrong else torch.tanh
    jlayer = jsd.SameDiffLayer(
        define_params=lambda k, it, dt: jax.tree_util.tree_map(
            jnp.asarray, _np_params()),
        forward=lambda p, x, train: jt(x @ p["W"]),
        out_type=lambda it: JIT(it.kind, (it.shape[0], 6)))
    player = psd.SameDiffLayer(
        define_params=lambda g, it, dt: {
            k: torch.from_numpy(v) for k, v in _np_params().items()},
        forward=lambda p, x, train: pt(x @ p["W"]),
        out_type=lambda it: InputType(it.kind, (it.shape[0], 6)))
    jnet = JMLN(JNNC.Builder().seed(0).updater(JSgd(1e-2)).list()
                .layer(jlayer).layer(_head())
                .set_input_type(JIT.recurrent(4, 5)).build()).init()
    pnet = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2)).list()
        .layer(player).layer(prec.RnnOutputLayer(
            n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(4, 5)).build(),
        device="cpu").init()
    pnet.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu",
        template=pnet.params)
    X, Y, mask = _rnn_data(seed=7)
    jres, pres = _verdicts(jnet, pnet, X, Y, mask, None)
    assert pres.passed == jres.passed == (not wrong)
    assert pres.n_params_checked == jres.n_params_checked == 8 + 8 + 2
    assert sorted(f[0] for f in pres.failures) == \
        sorted(f[0] for f in jres.failures)
    if wrong:
        assert all(f[0].startswith("0/W") for f in pres.failures)
        np.testing.assert_allclose(
            sorted(f[3] for f in pres.failures),
            sorted(f[3] for f in jres.failures), rtol=1e-6)


def test_graph_per_input_masks(tmp_path):
    """tests/test_graph_rnn.py:119: two sequence inputs with different
    masks, each through its own LSTM to its own head."""
    t = 5
    g = (JGB(JNNC.Builder().seed(0).updater(JSgd(1e-2)))
         .add_inputs("a", "b")
         .set_input_types(JIT.recurrent(3, t), JIT.recurrent(4, t)))
    g.add_layer("lstm_a", jl.LSTM(n_out=6), "a")
    g.add_layer("lstm_b", jl.LSTM(n_out=6), "b")
    g.add_layer("out_a", jl.RnnOutputLayer(n_out=2), "lstm_a")
    g.add_layer("out_b", jl.RnnOutputLayer(n_out=2), "lstm_b")
    g.set_outputs("out_a", "out_b")
    path = str(tmp_path / "g.zip")
    jnet = JCG(g.build()).init()
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    rs = np.random.RandomState(1)
    xa = rs.randn(4, t, 3).astype("float32")
    xb = rs.randn(4, t, 4).astype("float32")
    ya = np.eye(2, dtype="float32")[rs.randint(0, 2, (4, t))]
    yb = np.eye(2, dtype="float32")[rs.randint(0, 2, (4, t))]
    ma = np.ones((4, t), np.float32)
    ma[:, 3:] = 0
    mb = np.ones((4, t), np.float32)
    jres, pres = _verdicts(jnet, pnet, (xa, xb), (ya, yb), (ma, mb), None)
    assert jres.passed and pres.passed, pres.failures[:3]
    assert pres.n_params_checked == jres.n_params_checked


# ----------------------------------------------------------- VAE and YOLO
def _ff_net(layers, input_type):
    lb = JNNC.Builder().seed(0).updater(JSgd(1e-2)).list()
    for layer in layers:
        lb = lb.layer(layer)
    return JMLN(lb.set_input_type(input_type).build()).init()


def _vae_supervised():
    rs = np.random.RandomState(5)
    X = rs.randn(6, 5).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 6)]
    return _ff_net([jl.VariationalAutoencoder(n_out=3,
                                              encoder_layer_sizes=(6,),
                                              decoder_layer_sizes=(6,)),
                    jl.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent")],
                   JIT.feed_forward(5)), X, Y, 1e-3


def _yolo_loss():
    """tests/test_gradientcheck.py's test_gc_yolo_loss: a conv backbone
    and the YOLOv2 loss head, 2 anchors, 2 classes, two labelled boxes."""
    rs = np.random.RandomState(6)
    X = rs.rand(2, 4, 4, 3).astype("float32")
    Y = np.zeros((2, 2, 2, 6), "float32")
    Y[0, 0, 0] = [0.1, 0.1, 0.9, 0.9, 1, 0]
    Y[1, 1, 1] = [1.2, 1.2, 1.9, 1.8, 0, 1]
    return _ff_net([jl.ConvolutionLayer(n_out=2 * 7, kernel=(3, 3),
                                        stride=(2, 2),
                                        convolution_mode="same",
                                        activation="identity"),
                    jl.Yolo2OutputLayer(anchors=((1.0, 1.0), (0.5, 0.5)),
                                        n_classes=2)],
                   JIT.convolutional(4, 4, 3)), X, Y, 2e-3


@pytest.mark.parametrize("case", [_vae_supervised, _yolo_loss],
                         ids=["vae_supervised", "yolo_loss"])
def test_vae_and_yolo_verdicts_agree_with_the_reference(tmp_path, case):
    """The reference's VAE and YOLO cases (tests/test_gradientcheck.py:302-)
    through both packages' checks, from one zip."""
    jnet, X, Y, tol = case()
    path = str(tmp_path / "gc.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    jres, pres = _verdicts(jnet, pnet, X, Y, None, None, max_rel_error=tol)
    assert jres.passed and pres.passed, (pres.worst_param,
                                         pres.max_rel_error, pres.failures)
    assert pres.n_params_checked == jres.n_params_checked
    jres, pres = _verdicts(jnet, pnet, X, Y, None, None, max_rel_error=1e-14,
                           min_abs_error=0.0)
    assert not jres.passed and not pres.passed


def test_vae_pretrain_elbo_central_differences():
    """The reparameterized ELBO itself (the reference's
    test_gc_vae_pretrain_elbo, VaeGradientCheckTests): with the noise
    fixed the loss is deterministic, and autograd's gradient of every
    parameter leaf agrees with central differences in f64 (4 seeded
    entries a leaf, relative error under 1e-3)."""
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoder
    from deeplearning4j_tpu_torch.nn.updaters import tree_map
    layer = VariationalAutoencoder(n_out=3, encoder_layer_sizes=(6,),
                                   decoder_layer_sizes=(6,), num_samples=2)
    params, _ = layer.init(torch.Generator().manual_seed(0),
                           InputType.feed_forward(5), torch.float64)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.rand(4, 5))
    eps = [torch.from_numpy(rs.randn(4, 3)) for _ in range(2)]

    def loss(p):
        return layer.pretrain_score(p, x, eps=eps)

    live = tree_map(lambda t: t.clone().requires_grad_(True), params)
    grads = torch.autograd.grad(loss(live), tree_leaves(live))
    checked = 0
    for (path, leaf), g in zip(pgc._leaves_with_path(params), grads):
        for flat_i in rs.choice(leaf.numel(), min(4, leaf.numel()),
                                replace=False):
            def at(delta):
                bumped = leaf.clone()
                bumped.view(-1)[flat_i] += delta
                return float(loss(pgc._set_leaf(params, path, bumped)))
            num = (at(1e-6) - at(-1e-6)) / 2e-6
            ana = float(g.reshape(-1)[flat_i])
            denom = abs(num) + abs(ana)
            assert denom < 1e-8 or abs(num - ana) / denom < 1e-3, \
                ("/".join(path), flat_i, ana, num)
            checked += 1
    assert checked == 4 * 8
