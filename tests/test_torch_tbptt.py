"""Truncated BPTT and rnn_time_step in both containers, against the JAX
package and against the port's own standard paths, on the CPU.

- tbptt: the iteration count (one per chunk), three chunks of Adam
  updates from one zip equal to the reference's (parameters atol 1e-5,
  scores rtol 1e-5), with a masked tail that crosses a chunk boundary
  (the carry after it is zero), rank-2 labels left unsliced, and tbptt
  bitwise equal to standard backprop when one chunk covers the sequence;
  the graph's checks on its sequence inputs.
- rnn_time_step: one step and several at a time equal output() (atol
  1e-5) and the reference's stream; clearing restarts it.
- Gradient checkpointing on and off bitwise equal for an LSTM, standard
  and tbptt; an LSTM's chunked fit (the CUDA-graph path's loop, eager
  here) bitwise equal to per-call steps.
- The zoo's TextGenerationLSTM: the reference's JSON, output and tbptt
  fit from one zip.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator as JArrIt
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    GraphBuilder as JGB, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as pzoo
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

REF = types.SimpleNamespace(nnc=JNNC, gb=JGB, it=JIT, L=jl, U=jupd,
                            mln=JMLN, cg=JCG)
PORT = types.SimpleNamespace(nnc=NeuralNetConfiguration, gb=GraphBuilder,
                             it=InputType, L=pl, U=pupd,
                             mln=MultiLayerNetwork, cg=ComputationGraph)


def _seq_data(n=64, t=8, f=3, nc=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, t, f)).astype(np.float32)
    labels = (X.sum((1, 2)) > 0).astype(int)
    Y = np.tile(np.eye(nc, dtype=np.float32)[labels][:, None, :], (1, t, 1))
    return X, Y


def _mln_conf(ns, t=8, tbptt=None, remat=False, two_layers=False, seed=3,
              dropout=0.0):
    b = ns.nnc.Builder().seed(seed).updater(ns.U.Adam(1e-2))
    if remat:
        b = b.gradient_checkpointing()
    lb = b.list().layer(ns.L.LSTM(n_out=8, dropout=dropout))
    if two_layers:
        lb = lb.layer(ns.L.GravesLSTM(n_out=6))
    lb = lb.layer(ns.L.RnnOutputLayer(n_out=2)) \
        .set_input_type(ns.it.recurrent(3, t))
    if tbptt:
        lb = lb.tbptt(tbptt)
    return lb.build()


def _graph_conf(ns, t=8, tbptt=None, seed=3, two_layers=False):
    g = (ns.gb(ns.nnc.Builder().seed(seed).updater(ns.U.Adam(1e-2)))
         .add_inputs("in").set_input_types(ns.it.recurrent(3, t)))
    g.add_layer("lstm", ns.L.LSTM(n_out=8), "in")
    last = "lstm"
    if two_layers:
        g.add_layer("gru", ns.L.GRU(n_out=6), "lstm")
        last = "gru"
    g.add_layer("out", ns.L.RnnOutputLayer(n_out=2), last)
    g.set_outputs("out")
    if tbptt:
        g.backprop_type("tbptt", tbptt, tbptt)
    return g.build()


def _port_net(kind, **kw):
    if kind == "mln":
        return MultiLayerNetwork(_mln_conf(PORT, **kw), device="cpu").init()
    return ComputationGraph(_graph_conf(PORT, **kw), device="cpu").init()


def _fit(net, kind, X, Y, epochs=1, batch=32, fm=None, lm=None, **kw):
    lst = CollectScoresIterationListener()
    net.set_listeners(lst)
    if kind == "mln":
        net.fit(ArrayDataSetIterator(X, Y, batch_size=batch,
                                     features_mask=fm, labels_mask=lm),
                epochs=epochs, **kw)
    else:
        net.fit(MultiDataSet((X,), (Y,), None if fm is None else (fm,),
                             None if lm is None else (lm,)),
                epochs=epochs, **kw)
    return [s for _, s in lst.scores]


def _bitwise(a, b):
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close_to_ref(pnet, jnet, atol=1e-5):
    pleaves = tree_leaves(pnet.params)
    jleaves = jax.tree_util.tree_leaves(jnet.params)
    assert len(pleaves) == len(jleaves)
    for p, j in zip(pleaves, jleaves):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=atol, rtol=0)


# ------------------------------------------------------------------ tbptt
def test_mln_tbptt_counts_one_iteration_per_chunk():
    """tests/test_multilayer.py:190: 2 batches x 2 chunks x 5 epochs."""
    X, Y = _seq_data(t=8)
    net = _port_net("mln", tbptt=4)
    scores = _fit(net, "mln", X, Y, epochs=5)
    assert net.iteration_count == len(scores) == 20
    assert scores[-1] < scores[0]


def test_graph_tbptt_counts_one_iteration_per_chunk():
    """tests/test_graph_rnn.py:38: 1 batch x 2 chunks x 5 epochs."""
    X, Y = _seq_data(t=8)
    net = _port_net("graph", tbptt=4)
    scores = _fit(net, "graph", X, Y, epochs=5)
    assert net.iteration_count == len(scores) == 10
    assert scores[-1] < scores[0]


def _masked_tail(n=8, t=12):
    """Rows 0-3 valid for 6 steps: the mask ends inside the second chunk
    of 4, and the third chunk is all masked for them."""
    m = np.ones((n, t), np.float32)
    m[:4, 6:] = 0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_three_tbptt_chunks_match_the_reference(tmp_path, kind, masked):
    """One batch of T = 12 in chunks of 4 from one zip: three Adam steps,
    each chunk from the last one's detached carry."""
    make = JMLN if kind == "mln" else JCG
    conf = (_mln_conf if kind == "mln" else _graph_conf)(
        REF, t=12, tbptt=4, two_layers=True)
    path = str(tmp_path / "rnn.zip")
    jax_save(make(conf).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = _seq_data(n=8, t=12, seed=4)
    m = _masked_tail() if masked else None
    jlst = JCollect()
    jnet.set_listeners(jlst)
    if kind == "mln":
        jnet.fit(JArrIt(X, Y, batch_size=8, features_mask=m,
                        labels_mask=m), prefetch=False)
    else:
        jnet.fit(JMDS((X,), (Y,), None if m is None else (m,),
                      None if m is None else (m,)))
    scores = _fit(pnet, kind, X, Y, batch=8, fm=m, lm=m)
    assert pnet.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(scores, [s for _, s in jlst.scores],
                               rtol=1e-5)
    _close_to_ref(pnet, jnet)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_masked_tail_zeroes_the_carry_across_the_chunk_boundary(kind):
    net = _port_net(kind, t=12, tbptt=4, two_layers=True)
    X, Y = _seq_data(n=8, t=12, seed=4)
    m = _masked_tail()
    carries, seen = {}, []
    for t0 in range(0, 12, 4):
        x, fm = torch.from_numpy(X[:, t0:t0 + 4]), torch.from_numpy(
            m[:, t0:t0 + 4])
        if kind == "mln":
            _, _, carries = net._forward(net.params, net.state, x, False,
                                         fmask=fm, carries=carries)
        else:
            _, _, carries, _ = net._forward(net.params, net.state, (x,),
                                            False, fmasks=(fm,),
                                            carries=carries)
        seen.append(carries)
    assert len(seen[1]) == 2                      # both recurrent layers
    for carry in seen[1].values():
        leaves = carry if isinstance(carry, tuple) else (carry,)
        for c in leaves:
            assert float(c[:4].abs().max()) == 0.0     # masked tail: zero
            assert float(c[4:].abs().max()) > 0.0


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_tbptt_equals_standard_when_one_chunk_covers_the_sequence(kind):
    """tests/test_graph_rnn.py:53, here bitwise: the first chunk starts
    from the zero carry, which is the standard forward's state."""
    X, Y = _seq_data(n=16, t=4)
    a, b = _port_net(kind, t=4, tbptt=4), _port_net(kind, t=4)
    sa = _fit(a, kind, X, Y, batch=16)
    sb = _fit(b, kind, X, Y, batch=16)
    assert sa == sb and _bitwise(a, b)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_rank2_labels_are_not_sliced(tmp_path, kind):
    """A LastTimeStep head with one label per sequence: each chunk scores
    its last step against the whole (B, C) label, even when C equals T
    (the graph slices by rank, as DL4J does)."""
    t = 8

    def conf(ns):
        if kind == "mln":
            return (ns.nnc.Builder().seed(1).updater(ns.U.Adam(1e-2)).list()
                    .layer(ns.L.LastTimeStep(layer=ns.L.LSTM(n_out=6)))
                    .layer(ns.L.OutputLayer(n_out=t, activation="softmax",
                                            loss="mcxent"))
                    .set_input_type(ns.it.recurrent(3, t)).tbptt(4)
                    .build())
        g = (ns.gb(ns.nnc.Builder().seed(1).updater(ns.U.Adam(1e-2)))
             .add_inputs("in").set_input_types(ns.it.recurrent(3, t)))
        g.add_layer("last", ns.L.LastTimeStep(layer=ns.L.LSTM(n_out=6)),
                    "in")
        g.add_layer("out", ns.L.OutputLayer(n_out=t, activation="softmax",
                                            loss="mcxent"), "last")
        g.set_outputs("out")
        g.backprop_type("tbptt", 4, 4)
        return g.build()

    path = str(tmp_path / "last.zip")
    jax_save((JMLN if kind == "mln" else JCG)(conf(REF)).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    rs = np.random.RandomState(2)
    X = rs.randn(8, t, 3).astype(np.float32)
    Y = np.eye(t, dtype=np.float32)[rs.randint(0, t, 8)]
    if kind == "mln":
        jnet.fit(JArrIt(X, Y, batch_size=8), prefetch=False)
    else:
        jnet.fit(JMDS((X,), (Y,)))
    _fit(pnet, kind, X, Y, batch=8)
    assert pnet.iteration_count == jnet.iteration_count == 2
    _close_to_ref(pnet, jnet)


def test_tbptt_ignores_scan_steps_and_refuses_accumulation():
    """tbptt never scans (the reference's rule): scan_steps=4 runs the
    same per-call chunk steps."""
    X, Y = _seq_data(t=8)
    a, b = _port_net("mln", tbptt=4), _port_net("mln", tbptt=4)
    assert _fit(a, "mln", X, Y) == _fit(b, "mln", X, Y, scan_steps=4)
    assert _bitwise(a, b) and not b._step_graphs
    with pytest.raises(ValueError, match="accumulate_steps does not apply"):
        _fit(a, "mln", X, Y, accumulate_steps=2)
    with pytest.raises(ValueError, match="accumulate_steps does not apply"):
        _fit(_port_net("graph", tbptt=4), "graph", X, Y, accumulate_steps=2)


def test_graph_tbptt_checks_its_sequence_inputs():
    ff = (GraphBuilder(NeuralNetConfiguration.Builder().updater(
        pupd.Sgd(0.1))).add_inputs("in")
        .set_input_types(InputType.feed_forward(3)))
    ff.add_layer("out", pl.OutputLayer(n_out=2), "in")
    ff.set_outputs("out")
    ff.backprop_type("tbptt", 4, 4)
    net = ComputationGraph(ff.build(), device="cpu").init()
    with pytest.raises(ValueError, match="at least one RNN"):
        net.fit(MultiDataSet((np.zeros((2, 3), np.float32),),
                             (np.eye(2, dtype=np.float32),)))
    two = (GraphBuilder(NeuralNetConfiguration.Builder().updater(
        pupd.Sgd(0.1))).add_inputs("a", "b")
        .set_input_types(InputType.recurrent(3, 6), InputType.recurrent(3, 5)))
    two.add_layer("la", pl.LSTM(n_out=4), "a")
    two.add_layer("lb", pl.LSTM(n_out=4), "b")
    two.add_layer("oa", pl.RnnOutputLayer(n_out=2), "la")
    two.add_layer("ob", pl.RnnOutputLayer(n_out=2), "lb")
    two.set_outputs("oa", "ob")
    two.backprop_type("tbptt", 4, 4)
    net = ComputationGraph(two.build(), device="cpu").init()
    xa, ya = _seq_data(n=2, t=6)
    xb, yb = _seq_data(n=2, t=5)
    with pytest.raises(ValueError, match="share one sequence length"):
        net.fit(MultiDataSet((xa, xb), (ya, yb)))


# ---------------------------------------------------------- rnn_time_step
@pytest.fixture(scope="module")
def stream_nets(tmp_path_factory):
    """Both containers from reference zips (two recurrent layers each)."""
    d = tmp_path_factory.mktemp("stream")
    out = {}
    for kind, make, conf in (
            ("mln", JMLN, _mln_conf(REF, t=6, two_layers=True)),
            ("graph", JCG, _graph_conf(REF, t=6, two_layers=True))):
        path = str(d / f"{kind}.zip")
        jax_save(make(conf).init(), path)
        out[kind] = (jax_load(path), load_model(path, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_rnn_time_step_matches_output_and_the_reference(stream_nets, kind):
    """tests/test_multilayer.py:207 and tests/test_graph_rnn.py:67,152."""
    jnet, pnet = stream_nets[kind]
    X, _ = _seq_data(n=4, t=6)
    full = pnet.output(X)
    np.testing.assert_allclose(full.numpy(), np.asarray(jnet.output(X)),
                               atol=1e-5, rtol=0)
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    outs = []
    for t in range(6):
        y = pnet.rnn_time_step(X[:, t, :])
        assert tuple(y.shape) == (4, 2)
        np.testing.assert_allclose(
            y.numpy(), np.asarray(jnet.rnn_time_step(X[:, t, :])),
            atol=1e-5, rtol=0)
        outs.append(y)
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-5,
                               rtol=0)
    # several steps at a time leave the stream after them
    pnet.rnn_clear_previous_state()
    first = pnet.rnn_time_step(X[:, :4])
    rest = pnet.rnn_time_step(X[:, 4:])
    assert tuple(first.shape) == (4, 4, 2)
    torch.testing.assert_close(torch.cat([first, rest], 1), full,
                               atol=1e-5, rtol=0)
    # clearing restarts the stream
    pnet.rnn_clear_previous_state()
    torch.testing.assert_close(pnet.rnn_time_step(X[:, 0, :]), outs[0],
                               atol=1e-6, rtol=0)


def test_streaming_state_can_enter_training():
    """rnn_time_step runs under no_grad, not inference_mode: its state
    is an ordinary tensor, and a fit between calls works."""
    net = _port_net("mln", t=6)
    X, Y = _seq_data(n=4, t=6)
    net.rnn_time_step(X[:, :3])
    h, c = net._rnn_carries["0"]
    assert not h.is_inference() and not h.requires_grad
    net.fit((X, Y), batch_size=4)
    _, _, carries = net._forward(net.params, net.state,
                                 torch.from_numpy(X[:, 3:]), False,
                                 carries=net._rnn_carries)
    assert tuple(carries["0"][0].shape) == (4, 8)
    assert tuple(net.rnn_time_step(X[:, 3]).shape) == (4, 2)


# ------------------------------------------------- remat and chunked fit
@pytest.mark.parametrize("tbptt", [None, 4], ids=["standard", "tbptt"])
def test_remat_on_and_off_are_bitwise_equal_for_an_lstm(tbptt):
    """tests/test_remat.py:66: the recompute replays the same ops (and the
    carry is a checkpoint argument)."""
    rs = np.random.RandomState(3)
    X = rs.rand(24, 12, 3).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (24, 12))]
    nets = [MultiLayerNetwork(_mln_conf(PORT, t=12, tbptt=tbptt, remat=r,
                                        two_layers=True, dropout=0.2),
                              device="cpu").init() for r in (False, True)]
    scores = [_fit(n, "mln", X, Y, batch=12, epochs=2) for n in nets]
    assert scores[0] == scores[1] and _bitwise(*nets)


def test_lstm_chunked_fit_is_bitwise_the_per_call_fit():
    """The loop the card replays as a CUDA graph, run eagerly here."""
    X, Y = _seq_data(n=96, t=8)
    a = MultiLayerNetwork(_mln_conf(PORT, dropout=0.3), device="cpu").init()
    b = MultiLayerNetwork(_mln_conf(PORT, dropout=0.3), device="cpu").init()
    assert _fit(a, "mln", X, Y, epochs=2) == _fit(b, "mln", X, Y, epochs=2,
                                                  scan_steps=2)
    assert _bitwise(a, b)


# ------------------------------------------------------ TextGenerationLSTM
def test_text_generation_lstm_matches_the_reference(tmp_path):
    """tests/test_zoo.py:78 at 120 steps: the config JSON, output() and
    three tbptt chunks (50, 50, 20) from one zip."""
    kw = dict(total_unique_characters=12, max_length=120, units=8)
    assert pzoo.TextGenerationLSTM(**kw).conf().to_json() == \
        jzoo.TextGenerationLSTM(**kw).conf().to_json()
    assert pzoo.model_by_name("textgenerationlstm").max_length == 40
    path = str(tmp_path / "tg.zip")
    jax_save(jzoo.TextGenerationLSTM(**kw).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    rs = np.random.RandomState(0)
    x = np.eye(12, dtype=np.float32)[rs.randint(0, 12, (2, 120))]
    y = np.eye(12, dtype=np.float32)[rs.randint(0, 12, (2, 120))]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5, rtol=0)
    jnet.fit(JArrIt(x, y, batch_size=2), prefetch=False)
    pnet.fit(DataSet(x, y))
    assert pnet.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=1e-5)
    _close_to_ref(pnet, jnet)
    init = pzoo.TextGenerationLSTM(**kw).init(device="cpu")
    assert init.conf.backprop_type == "tbptt" and init.device.type == "cpu"
    assert dataclasses.asdict(pzoo.TextGenerationLSTM()) == {
        "total_unique_characters": 47, "max_length": 40, "units": 256,
        "seed": 123}
