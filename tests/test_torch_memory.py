"""The port's memory reports (`util/memory.py`, both containers'
`memory_report`) against the JAX package's.

- The analytic part is the reference's: on the same zip, every row
  (parameters, optimizer state, activations, working bytes) and every
  total equal the reference's report, for LeNet with Adam (clipped and
  not), Sgd, and a ResNet-50 graph; the reference's own structural checks
  hold.
- The measured part runs one training forward and backward on zeros with
  no update; on the CPU there is no allocator peak, so `compiled` is None,
  a warning names the gap and `xla_analysis_unavailable_total{kind=
  "memory"}` counts it, as the reference does on a backend without
  memory analysis. The probe leaves the network bitwise unchanged
  (parameters, optimizer and layer state, its generator, its counters),
  with dropout and batch norm in it. The card's checks (the measured
  peak, within 2x) are in tests/test_torch_cuda.py.
"""
import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.util.serialization import load_model as jax_load
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd, tree_leaves
from deeplearning4j_tpu_torch.util import memory as memory_mod
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)


def _lenet(updater=None, clip=None):
    b = NeuralNetConfiguration.Builder().seed(0).updater(updater or Adam(1e-3))
    if clip:
        b = b.grad_clip_norm(clip)
    return (b.list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=120, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())


@pytest.fixture(autouse=True)
def _clean_registries():
    monitor.REGISTRY.reset()
    jmonitor.REGISTRY.reset()
    yield
    monitor.REGISTRY.reset()
    jmonitor.REGISTRY.reset()


def _rows(rep):
    return [(r.name, r.layer_type, r.params_bytes, r.updater_state_bytes,
             r.activation_bytes, r.working_bytes) for r in rep.layers]


def _same_report(mine, ref):
    assert _rows(mine) == _rows(ref)
    for attr in ("input_bytes", "total_params_bytes", "total_updater_bytes",
                 "total_activation_bytes", "total_train_bytes",
                 "total_inference_bytes"):
        assert getattr(mine, attr) == getattr(ref, attr), attr


# ------------------------------------------------------- the analytic part
def test_memory_report_analytic_structure():
    net = MultiLayerNetwork(_lenet(), device="cpu").init()
    rep = net.memory_report(batch_size=16, with_compiled=False)
    assert len(rep.layers) == 6
    conv1 = rep.layers[0]
    assert conv1.params_bytes == 520 * 4
    assert conv1.updater_state_bytes == 2 * conv1.params_bytes
    assert conv1.activation_bytes == 16 * 24 * 24 * 20 * 4
    assert rep.total_params_bytes == net.num_params() * 4
    assert "analytic train total" in rep.summary()


def test_memory_report_sgd_has_no_updater_state():
    net = MultiLayerNetwork(_lenet(updater=Sgd(0.1)), device="cpu").init()
    rep = net.memory_report(batch_size=8, with_compiled=False)
    assert rep.total_updater_bytes == 0


@pytest.mark.parametrize("case", ["adam", "adam_clipped", "sgd"])
def test_the_analytic_rows_are_the_references(case, tmp_path):
    """A clipped Adam is a chain whose state is keyed "0", "1" — the keys
    of a two-layer network's parameters, which the attribution must not
    take for them."""
    conf = {"adam": _lenet(), "adam_clipped": _lenet(clip=1.0),
            "sgd": _lenet(updater=Sgd(0.1))}[case]
    path = save_model(MultiLayerNetwork(conf, device="cpu").init(),
                      str(tmp_path / "m.zip"))
    mine = load_model(path, device="cpu").memory_report(
        batch_size=16, with_compiled=False)
    ref = jax_load(path).memory_report(batch_size=16, with_compiled=False)
    _same_report(mine, ref)


def test_memory_report_graph_is_the_references():
    net = ComputationGraph(ResNet50(num_classes=10,
                                    input_shape=(32, 32, 3)).conf(),
                           device="cpu").init()
    rep = net.memory_report(batch_size=4, with_compiled=False)
    assert rep.total_params_bytes == net.num_params() * 4
    names = [r.name for r in rep.layers]
    assert "stem_conv" in names and "output" in names
    assert rep.total_train_bytes > rep.total_inference_bytes
    from deeplearning4j_tpu.models import ResNet50 as JResNet50
    jnet = JCG(JResNet50(num_classes=10, input_shape=(32, 32, 3)).conf())
    # the reference's init() of a deep graph is slow: its report needs only
    # the shapes, so it reads the port's parameters and optimizer state
    jnet.params = jax_tree(net.params)
    jnet.state = jax_tree(net.state)
    jnet.opt_state = _optax_like(net)
    ref = jnet.memory_report(batch_size=4, with_compiled=False)
    _same_report(rep, ref)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _optax_like(net):
    """The reference attributes optimizer state by walking optax's tuples
    for dicts keyed like the parameters: Nesterovs' one trace mirrors the
    parameter tree."""
    return ({"count": np.zeros((), np.int32)},
            {"trace": jax_tree(net.params)})


# -------------------------------------------------------- the measured part
def test_the_cpu_has_no_peak_and_counts_it(caplog):
    net = MultiLayerNetwork(_lenet(), device="cpu").init()
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        rep = net.memory_report(batch_size=8, with_compiled=True)
    assert rep.compiled is None
    assert rep.compiled_total_bytes is None
    assert rep.total_train_bytes > 0
    assert any("measured step memory unavailable" in r.message
               for r in caplog.records)
    ctr = monitor.REGISTRY.collect("xla_analysis_unavailable_total")
    assert ctr is not None and ctr.value(kind="memory") == 1
    assert "measured step" not in rep.summary()


def _state_of(net):
    return ([t.clone() for t in tree_leaves(net.params)],
            [t.clone() for t in tree_leaves(net.opt_state)],
            [t.clone() for t in tree_leaves(net.state)],
            None if net._dropout_gen is None
            else net._dropout_gen.get_state().clone(),
            (net.iteration_count, net.epoch_count, net._score))


def _assert_unchanged(before, after):
    for a, b in zip(before[:3], after[:3]):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (before[3] is None and after[3] is None) \
        or torch.equal(before[3], after[3])
    assert before[4] == after[4]


def test_the_probe_step_leaves_the_network_bitwise_unchanged():
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu", dropout=0.5))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rs = np.random.RandomState(0)
    net.fit((rs.randn(32, 6).astype("float32"),
             np.eye(3, dtype="float32")[rs.randint(0, 3, 32)]),
            batch_size=16)
    before = _state_of(net)
    loss, grads, struct = memory_mod.probe_step(net, 8)
    assert np.isfinite(float(loss)) and struct[0].shape == (8, 6)
    assert [g.shape for g in tree_leaves(grads)] == [
        p.shape for p in tree_leaves(net.params)]
    net.memory_report(batch_size=8)
    _assert_unchanged(before, _state_of(net))


def test_the_probe_step_on_a_graph_and_an_lm():
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    lm = model_by_name("TransformerLM", vocab_size=32, seq_length=16,
                       n_layers=1, n_embd=16, n_heads=2,
                       attention_impl="flash").init(device="cpu")
    before = _state_of(lm)
    loss, _, struct = memory_mod.probe_step(lm, 2)
    assert struct[0].shape == (2, 16, 1) and struct[1].shape == (2, 16, 32)
    assert np.isfinite(float(loss))
    _assert_unchanged(before, _state_of(lm))
    g = ComputationGraph(ResNet50(num_classes=4,
                                  input_shape=(32, 32, 3)).conf(),
                         device="cpu").init()
    loss, _, struct = memory_mod.probe_step(g, 1)
    assert struct[0][0].shape == (1, 32, 32, 3)
    assert struct[1][0].shape == (1, 4)
    assert np.isfinite(float(loss))
