"""The port's transfer learning and FrozenLayerWrapper against the JAX
package, on the CPU.

Each case loads one reference zip into both packages and applies the same
surgery to each: the built configs serialize to the same JSON, retained
parameters are copies of the source's, and new or re-initialized layers
have the reference's shapes. To compare training, the reference's built
parameters are loaded into the port's built network; then a few Adam
steps agree within 1e-5 (f32), frozen parameters do not move at all, and
the reference's updaterState.bin passes through the port byte for byte.
A frozen LSTM keeps its streaming state (tests/test_training_extras.py:
545).
"""
import io
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator as JArrIt
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.graph_vertices import MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf.network import (
    GraphBuilder as JGB, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.updaters import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import transferlearning as ptl
from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, params_from_numpy, save_model,
)


def _blobs(n=120, f=6, c=3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(c, f) * 3
    y = np.repeat(np.arange(c), n // c)
    X = (centers[y] + rs.randn(len(y), f)).astype("float32")
    return X, np.eye(c, dtype="float32")[y]


def _mlp_conf(bn=False):
    lb = (JNNC.Builder().seed(4).updater(JAdam(1e-2)).list()
          .layer(jl.DenseLayer(n_out=12, activation="relu")))
    if bn:
        lb = lb.layer(jl.BatchNormalization())
    return (lb.layer(jl.DenseLayer(n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(6)).build())


def _pair(tmp_path, net, name="src.zip"):
    """The reference net and its port, loaded from one zip."""
    path = str(tmp_path / name)
    jax_save(net, path)
    return jax_load(path), load_model(path, device="cpu")


def _adopt(pnet, jnet):
    """Give the port's built net the reference's built parameters."""
    pnet.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu",
        template=pnet.params)
    pnet.state = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.state), "cpu",
        template=pnet.state)
    pnet._build_optimizer()


def _close(pnet, jnet, atol=1e-5):
    pleaves = tree_leaves(pnet.params)
    jleaves = jax.tree_util.tree_leaves(jnet.params)
    assert len(pleaves) == len(jleaves)
    for p, j in zip(pleaves, jleaves):
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=atol, rtol=0)


def _updater_bytes(path):
    return zipfile.ZipFile(path).read("updaterState.bin")


def _state_round_trip(tmp_path, jnet):
    """The reference's updaterState.bin read by the port and written back
    is byte-identical."""
    j_zip, p_zip = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jax_save(jnet, j_zip)
    save_model(load_model(j_zip, device="cpu"), p_zip)
    assert _updater_bytes(p_zip) == _updater_bytes(j_zip)


def test_freeze_and_replace_head_trains_as_the_reference(tmp_path):
    """tests/test_training_extras.py:91, held to the reference."""
    X, Y = _blobs()
    jsrc, psrc = _pair(tmp_path, JMLN(_mlp_conf()).init())
    Y5 = np.eye(5, dtype="float32")[np.random.RandomState(3).randint(
        0, 5, len(X))]

    def surgery(tl, ftc, sgd, out):
        return (tl(jsrc if tl is jtl.TransferLearning else psrc)
                .fine_tune_configuration(ftc(updater=sgd(5e-2), l2=1e-3))
                .set_feature_extractor(1).remove_output_layer()
                .add_layer(out(n_out=5, activation="softmax",
                               loss="mcxent")).build())

    jnew = surgery(jtl.TransferLearning, jtl.FineTuneConfiguration, JSgd,
                   jl.OutputLayer)
    pnew = surgery(ptl.TransferLearning, ptl.FineTuneConfiguration, Sgd,
                   pl.OutputLayer)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert pnew.device == psrc.device
    assert type(pnew.layers[0]).__name__ == "FrozenLayerWrapper"
    assert torch.equal(pnew.params["0"]["W"], psrc.params["0"]["W"])
    assert pnew.params["0"]["W"] is not psrc.params["0"]["W"]
    _adopt(pnew, jnew)
    frozen = [pnew.params[k]["W"].clone() for k in ("0", "1")]
    jnew.fit(JArrIt(X, Y5, batch_size=40), epochs=2, prefetch=False)
    pnew.fit(ArrayDataSetIterator(X, Y5, batch_size=40), epochs=2)
    assert pnew.iteration_count == jnew.iteration_count == 6
    _close(pnew, jnew)
    assert all(torch.equal(pnew.params[k]["W"], w)
               for k, w in zip(("0", "1"), frozen))
    np.testing.assert_allclose(pnew.score(), jnew.score(), rtol=1e-5)
    _state_round_trip(tmp_path, jnew)
    # the source is untouched and still usable
    assert torch.isfinite(psrc.output(X[:4])).all()


def test_n_out_replace_through_batch_norm(tmp_path):
    """tests/test_training_extras.py:115,521: the width reaches past the
    batch norm down to the next projection."""
    jsrc, psrc = _pair(tmp_path, JMLN(_mlp_conf(bn=True)).init())
    jnew = jtl.TransferLearning(jsrc).n_out_replace(0, 20).build()
    pnew = ptl.TransferLearning(psrc).n_out_replace(0, 20).build()
    assert pnew.conf.to_json() == jnew.conf.to_json()
    for p, j in zip(tree_leaves(pnew.params),
                    jax.tree_util.tree_leaves(jnew.params)):
        assert tuple(p.shape) == tuple(j.shape)
    assert tuple(pnew.params["2"]["W"].shape) == (20, 8)
    assert torch.equal(pnew.params["3"]["W"], psrc.params["3"]["W"])
    X, _ = _blobs(n=12)
    assert tuple(pnew.output(X).shape) == (12, 3)


def test_transfer_learning_helper_matches_the_reference(tmp_path):
    """tests/test_training_extras.py:131: featurize through the frozen
    body, train the head on the features, write it back."""
    X, Y = _blobs()
    jsrc, psrc = _pair(tmp_path, JMLN(_mlp_conf()).init())
    jh, ph = jtl.TransferLearningHelper(jsrc, 1), \
        ptl.TransferLearningHelper(psrc, 1)
    feats = ph.featurize(X)
    assert tuple(feats.shape) == (len(X), 8)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jh.featurize(X)),
                               atol=1e-5, rtol=0)
    jh.fit_featurized(np.asarray(jh.featurize(X)), Y, epochs=3,
                      batch_size=40)
    ph.fit_featurized(feats, Y, epochs=3, batch_size=40)
    _close(ph.head, jh.head)
    full = ph.unfrozen_network()
    assert full.device == psrc.device
    torch.testing.assert_close(full.output(X[:8]), ph.head.output(
        feats[:8].numpy()), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="no trainable head"):
        ptl.TransferLearningHelper(psrc, 2)


def test_frozen_lstm_keeps_streaming_state_and_its_params(tmp_path):
    """tests/test_training_extras.py:545, then a tbptt fit: the frozen
    LSTM does not move, the head trains as the reference's, and the
    updater state passes byte for byte."""
    conf = (JNNC.Builder().seed(5).updater(JAdam(1e-2)).list()
            .layer(jl.LSTM(n_out=8))
            .layer(jl.RnnOutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(JIT.recurrent(3, 6)).tbptt(3).build())
    jsrc, psrc = _pair(tmp_path, JMLN(conf).init())
    jfrozen = jtl.TransferLearning(jsrc).set_feature_extractor(0).build()
    frozen = ptl.TransferLearning(psrc).set_feature_extractor(0).build()
    assert frozen.conf.to_json() == jfrozen.conf.to_json()
    rs = np.random.RandomState(1)
    x = rs.randn(4, 6, 3).astype("float32")
    y = np.eye(2, dtype="float32")[rs.randint(0, 2, (4, 6))]
    full = frozen.output(x)
    frozen.rnn_clear_previous_state()
    stepped = torch.cat([frozen.rnn_time_step(x[:, t:t + 1])
                         for t in range(6)], dim=1)
    torch.testing.assert_close(stepped, full, atol=1e-5, rtol=0)
    assert set(frozen._rnn_carries) == {"0"}
    _adopt(frozen, jfrozen)
    lstm = {k: v.clone() for k, v in frozen.params["0"].items()}
    jfrozen.fit(JArrIt(x, y, batch_size=4), epochs=2, prefetch=False)
    frozen.fit(ArrayDataSetIterator(x, y, batch_size=4), epochs=2)
    assert frozen.iteration_count == jfrozen.iteration_count == 4
    assert all(torch.equal(frozen.params["0"][k], v)
               for k, v in lstm.items())
    _close(frozen, jfrozen)
    assert list(frozen.opt_state["inner_states"]) == ["__global__",
                                                      "__noop__"]
    _state_round_trip(tmp_path, jfrozen)
    buf = io.BytesIO()
    save_model(frozen, buf, atomic=False)
    assert zipfile.ZipFile(buf).read("updaterState.bin")


def _graph_src(merge=False):
    g = (JGB(JNNC.Builder().seed(1).updater(JAdam(1e-2)))
         .add_inputs("in").set_input_types(JIT.feed_forward(6)))
    g.add_layer("torso1", jl.DenseLayer(n_out=16, activation="relu"), "in")
    g.add_layer("torso2", jl.DenseLayer(n_out=12, activation="relu"),
                "torso1")
    last = "torso2"
    if merge:
        g.add_vertex("m", JMerge(), "torso1", "torso2")
        last = "m"
    g.add_layer("head", jl.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), last)
    g.set_outputs("head")
    return JCG(g.build()).init()


def test_graph_freeze_and_swap_head_trains_as_the_reference(tmp_path):
    """tests/test_training_extras.py:374, held to the reference."""
    X, Y = _blobs()
    jsrc, psrc = _pair(tmp_path, _graph_src())

    def surgery(tlg, src, out):
        return (tlg(src).set_feature_extractor("torso2")
                .remove_vertex_and_connections("head")
                .add_layer("new_head", out(n_out=2, activation="softmax",
                                           loss="mcxent"), "torso2")
                .set_outputs("new_head").build())

    jnew = surgery(jtl.TransferLearningGraph, jsrc, jl.OutputLayer)
    pnew = surgery(ptl.TransferLearningGraph, psrc, pl.OutputLayer)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert torch.equal(pnew.params["torso1"]["W"], psrc.params["torso1"]["W"])
    _adopt(pnew, jnew)
    torso = pnew.params["torso1"]["W"].clone()
    Y2 = np.eye(2, dtype="float32")[(Y.argmax(1) >= 1).astype(int)]
    jnew.fit((X, Y2), epochs=3)
    pnew.fit((X, Y2), epochs=3)
    _close(pnew, jnew)
    assert torch.equal(pnew.params["torso1"]["W"], torso)
    _state_round_trip(tmp_path, jnew)


def test_graph_n_out_replace_and_validation(tmp_path):
    """tests/test_training_extras.py:421,462: the width passes through
    the merge to the head; unknown names and a vertex without n_out
    fail; a fully frozen graph still trains nothing."""
    jsrc, psrc = _pair(tmp_path, _graph_src(merge=True))
    jnew = jtl.TransferLearningGraph(jsrc).n_out_replace("torso1", 20) \
        .build()
    pnew = ptl.TransferLearningGraph(psrc).n_out_replace("torso1", 20) \
        .build()
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert tuple(pnew.params["head"]["W"].shape) == (32, 3)
    assert tuple(pnew.params["torso2"]["W"].shape) == (20, 12)
    with pytest.raises(ValueError, match="unknown vertex"):
        ptl.TransferLearningGraph(psrc).set_feature_extractor("t1").build()
    with pytest.raises(ValueError, match="no n_out"):
        ptl.TransferLearningGraph(psrc).n_out_replace("m", 20).build()
    with pytest.raises(ValueError, match="already retained"):
        ptl.TransferLearningGraph(psrc).add_layer(
            "head", pl.OutputLayer(n_out=2), "m").build()
    with pytest.raises(TypeError):
        ptl.TransferLearningGraph(psrc.params)
    frozen = ptl.TransferLearningGraph(psrc).set_feature_extractor("head") \
        .build()
    X, Y = _blobs(n=12)
    before = [t.clone() for t in tree_leaves(frozen.params)]
    frozen.fit((X, Y), epochs=2)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(frozen.params)))
