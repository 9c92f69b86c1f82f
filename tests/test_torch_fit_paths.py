"""The port's fit paths against the JAX package and against its own
per-call path: scan-of-K, gradient accumulation, model-reading listeners,
per-layer updaters and frozen layers (multi_transform and its
updaterState.bin), gradient checkpointing, attention-probability dropout,
the containers' evaluate*, and the paths that still raise.

On the CPU the chunked fit runs eager steps (the CUDA graph path is held
to the per-call path on the card by tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: the port against itself is bitwise (same math, same dropout
stream); against the reference f32 Sgd atol 1e-6, f32 Adam atol 1e-5,
f64 with batch norm atol 1e-10; dropout by its distribution (5 sigma);
evaluation metrics equal (AUC rtol 1e-5 for f32 scores summed in other
orders).
"""
import dataclasses
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.iterator import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    GraphBuilder as JGB, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.nn import step_graph
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import attention as pattn
from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
from deeplearning4j_tpu_torch.nn.layers import normalization as pnorm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)


def _blobs(n=250, nf=4, nc=3, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, nf).astype("float32")
    Y = np.eye(nc, dtype="float32")[rs.randint(0, nc, n)]
    return X, Y


def _mlp(nnc, ff, it, updater, seed=7, **dense_kw):
    return (nnc.Builder().seed(seed).updater(updater).list()
            .layer(ff.DenseLayer(n_out=16, activation="relu", **dense_kw))
            .layer(ff.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(it.feed_forward(4)).build())


def _graph(nnc, gb, ff, norm, it, updater, bn=False, **dense_kw):
    g = (gb(nnc.Builder().seed(9).updater(updater))
         .add_inputs("in").set_input_types(it.feed_forward(4)))
    g.add_layer("d", ff.DenseLayer(n_out=12, activation="tanh",
                                   **dense_kw), "in")
    last = "d"
    if bn:
        g.add_layer("bn", norm.BatchNormalization(), "d")
        last = "bn"
    g.add_layer("out", ff.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), last)
    g.set_outputs("out")
    return g.build()


def _port_mlp(**kw):
    return MultiLayerNetwork(_mlp(NeuralNetConfiguration, pff, InputType,
                                  kw.pop("updater", pupd.Sgd(1e-2)), **kw),
                             device="cpu").init()


def _port_graph(**kw):
    return ComputationGraph(_graph(
        NeuralNetConfiguration, GraphBuilder, pff, pnorm, InputType,
        kw.pop("updater", pupd.Sgd(1e-2)), **kw), device="cpu").init()


def _equal(a, b):
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close_to_ref(pnet, jnet, atol):
    pl = tree_leaves(pnet.params)
    jl = jax.tree_util.tree_leaves(jnet.params)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=atol, rtol=0)


def _fit(net, scores=True, **kw):
    lst = CollectScoresIterationListener()
    net.set_listeners(lst)
    X, Y = _blobs()
    net.fit(ArrayDataSetIterator(X, Y, batch_size=64), epochs=3, **kw)
    return [s for _, s in lst.scores]


# ----------------------------------------------------------------- scan
@pytest.mark.parametrize("make", [_port_mlp, _port_graph])
def test_scan_fit_matches_per_call_bitwise_with_dropout(make):
    """Mirrors tests/test_multilayer.py:322,342 and test_graph_rnn.py:165:
    250 samples in batches of 64 give 3 per epoch, so K=2 leaves a
    ragged chunk; dropout 0.5 draws from the one epoch stream."""
    a, b = make(dropout=0.5), make(dropout=0.5)
    sa, sb = _fit(a), _fit(b, scan_steps=2)
    assert a.iteration_count == b.iteration_count == 9
    assert sa == sb
    assert _equal(a, b)


def test_scan_steps_default_and_env(monkeypatch):
    monkeypatch.delenv("DL4J_CUDA_SCAN_STEPS", raising=False)
    assert step_graph.default_scan_steps() == 1
    monkeypatch.setenv("DL4J_CUDA_SCAN_STEPS", "7")
    assert step_graph.default_scan_steps() == 7
    monkeypatch.setenv("DL4J_CUDA_SCAN_STEPS", "4")
    a, b = _port_mlp(dropout=0.5), _port_mlp(dropout=0.5)
    _fit(b)                                     # scan of 4 from the env
    monkeypatch.setenv("DL4J_CUDA_SCAN_STEPS", "1")
    _fit(a)
    assert _equal(a, b)


def _ref_mlp_zip(tmp_path, updater, **kw):
    net = JMLN(_mlp(JNNC, jff, JIT, updater, **kw)).init()
    path = str(tmp_path / "mlp.zip")
    jax_save(net, path)
    return path


def test_port_scan_matches_reference_scan_in_f32(tmp_path):
    """Two chunks of K=3 (and a ragged one) on each side, from one zip."""
    path = _ref_mlp_zip(tmp_path, jupd.Sgd(5e-2))
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = _blobs(n=448)
    jnet.fit(JArrayIt(X, Y, batch_size=64), epochs=1, scan_steps=3,
             prefetch=False)
    pnet.fit(ArrayDataSetIterator(X, Y, batch_size=64), scan_steps=3)
    assert pnet.iteration_count == jnet.iteration_count == 7
    _close_to_ref(pnet, jnet, 1e-6)
    np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=1e-6)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_port_scan_matches_the_reference_with_batch_norm_in_f64(tmp_path,
                                                               x64):
    """The reference's scan cannot trace this net in f64 (its f32
    batch-norm state comes out of a step as f64, and lax.scan refuses the
    carry), so the port's scan is held to the reference's per-call steps,
    which scan promises to equal."""
    conf = dataclasses.replace(
        _graph(JNNC, JGB, jff, jnorm, JIT,
               jupd.Nesterovs(learning_rate=0.05, momentum=0.9), bn=True),
        dtype="float64")
    path = str(tmp_path / "g.zip")
    jax_save(JCG(conf).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = (a.astype("float64") for a in _blobs(n=96))
    jnet.fit(JArrayIt(X, Y, batch_size=16), scan_steps=1)
    pnet.fit(ArrayDataSetIterator(X, Y, batch_size=16), scan_steps=2)
    assert pnet.iteration_count == jnet.iteration_count == 6
    _close_to_ref(pnet, jnet, 1e-10)
    for p, j in zip(tree_leaves(pnet.state),
                    jax.tree_util.tree_leaves(jnet.state)):
        assert p.dtype == torch.float64
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-10)


def test_model_reading_listener_forces_per_call():
    """Mirrors tests/test_multilayer.py:360: a reads_model listener sees,
    at each iteration_done, the params of exactly that step."""
    class Snap(CollectScoresIterationListener):
        reads_model = True

        def __init__(self):
            super().__init__()
            self.params = []

        def iteration_done(self, model, iteration, *a, **k):
            super().iteration_done(model, iteration, *a, **k)
            self.params.append([t.clone() for t in
                                tree_leaves(model.params)])

    a, b = _port_mlp(), _port_mlp()
    sa, sb = Snap(), Snap()
    X, Y = _blobs()
    a.set_listeners(sa)
    b.set_listeners(sb)
    a.fit(ArrayDataSetIterator(X, Y, batch_size=64))
    b.fit(ArrayDataSetIterator(X, Y, batch_size=64), scan_steps=2)
    assert len(sb.params) == 3
    for pa, pb in zip(sa.params, sb.params):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


# ---------------------------------------------------------- accumulate
def _acc_data(n=64):
    rs = np.random.RandomState(3)
    X = rs.randn(n, 4).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, n)]
    return X, Y


@pytest.mark.parametrize("make", [_port_mlp, _port_graph])
def test_accumulation_equals_big_batch(make):
    """Mirrors tests/test_multilayer.py:434,484: 4 micro-batches of 16
    accumulated equal one step on a batch of 64."""
    X, Y = _acc_data()
    a, b = make(updater=pupd.Sgd(1e-1)), make(updater=pupd.Sgd(1e-1))
    a.fit(ArrayDataSetIterator(X, Y, batch_size=16), accumulate_steps=4,
          epochs=2)
    b.fit(ArrayDataSetIterator(X, Y, batch_size=64), epochs=2)
    assert a.iteration_count == b.iteration_count == 2
    for la, lb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_ragged_tail_accumulates_with_the_correct_mean():
    """Mirrors tests/test_multilayer.py:449: 6 micro-batches with K=4 are
    two steps, equal to per-call steps on batches of 64 and 32."""
    X, Y = _acc_data(96)
    a, b = _port_mlp(updater=pupd.Sgd(1e-1)), _port_mlp(
        updater=pupd.Sgd(1e-1))
    lst = CollectScoresIterationListener()
    a.set_listeners(lst)
    a.fit(ArrayDataSetIterator(X, Y, batch_size=16), accumulate_steps=4)
    assert a.iteration_count == 2 and len(lst.scores) == 2
    b.fit(ArrayDataSetIterator(X[:64], Y[:64], batch_size=64))
    b.fit(ArrayDataSetIterator(X[64:], Y[64:], batch_size=32))
    for la, lb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_accumulation_matches_the_reference(tmp_path):
    path = _ref_mlp_zip(tmp_path, jupd.Adam(1e-2))
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = _acc_data(96)
    jnet.fit(JArrayIt(X, Y, batch_size=16), accumulate_steps=4, epochs=2,
             prefetch=False)
    pnet.fit(ArrayDataSetIterator(X, Y, batch_size=16), accumulate_steps=4,
             epochs=2)
    assert pnet.iteration_count == jnet.iteration_count == 4
    _close_to_ref(pnet, jnet, 1e-5)
    np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=1e-5)


def test_accumulate_and_scan_are_mutually_exclusive():
    X, Y = _acc_data(32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port_mlp().fit((X, Y), batch_size=16, accumulate_steps=2,
                        scan_steps=2)


# ---------------------------------------------- updaters and frozen layers
def _override_mlp(nnc, ff, it, upd):
    return (nnc.Builder().seed(3).updater(upd.Sgd(0.1)).grad_clip_norm(1.0)
            .list()
            .layer(ff.DenseLayer(n_out=8, activation="tanh", frozen=True))
            .layer(ff.DenseLayer(n_out=8, activation="tanh",
                                 updater=upd.Adam(1e-2)))
            .layer(ff.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(it.feed_forward(4)).build())


def test_per_layer_updaters_and_frozen_layers_match_multi_transform(
        tmp_path):
    """Five steps against optax.multi_transform; the frozen layer does not
    move (tests/test_multilayer.py:277); updaterState.bin moves byte for
    byte both ways."""
    jnet = JMLN(_override_mlp(JNNC, jff, JIT, jupd)).init()
    path = str(tmp_path / "o.zip")
    jax_save(jnet, path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    frozen = pnet.params["0"]["W"].clone()
    X, Y = _blobs(n=160)
    jnet.fit(JArrayIt(X, Y, batch_size=32), prefetch=False)
    pnet.fit(ArrayDataSetIterator(X, Y, batch_size=32))
    assert pnet.iteration_count == 5
    _close_to_ref(pnet, jnet, 1e-5)
    assert torch.equal(pnet.params["0"]["W"], frozen)
    assert list(pnet.opt_state["inner_states"]) == [
        "__global__", "__noop__", "layer_1"]
    # byte-identical both ways: the reference's state written by the port
    # and the port's read back by the reference
    j_zip, p_zip = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jax_save(jnet, j_zip)
    loaded = load_model(j_zip, device="cpu")
    save_model(loaded, p_zip)
    read = lambda p: zipfile.ZipFile(p).read("updaterState.bin")
    assert read(p_zip) == read(j_zip)
    back = jax_load(p_zip)
    jax_save(back, str(tmp_path / "j2.zip"))
    assert read(str(tmp_path / "j2.zip")) == read(j_zip)


def test_graph_frozen_vertex_and_vertex_updater():
    conf = _graph(NeuralNetConfiguration, GraphBuilder, pff, pnorm,
                  InputType, pupd.Sgd(0.1))
    vs = dict(conf.vertices)
    vs["d"] = dataclasses.replace(vs["d"], vertex=dataclasses.replace(
        vs["d"].vertex, frozen=True))
    vs["out"] = dataclasses.replace(vs["out"], vertex=dataclasses.replace(
        vs["out"].vertex, updater=pupd.Adam(1e-2)))
    net = ComputationGraph(dataclasses.replace(conf, vertices=vs),
                           device="cpu").init()
    w = net.params["d"]["W"].clone()
    out_w = net.params["out"]["W"].clone()
    X, Y = _blobs(n=64)
    net.fit(ArrayDataSetIterator(X, Y, batch_size=32), scan_steps=2)
    assert torch.equal(net.params["d"]["W"], w)
    assert not torch.equal(net.params["out"]["W"], out_w)
    assert list(net.opt_state["inner_states"]) == ["__global__", "__noop__",
                                                   "v_out"]


# ---------------------------------------------- gradient checkpointing
def _remat(net_fn, **kw):
    nets = []
    for remat in (False, True):
        net = net_fn()
        net.conf = dataclasses.replace(net.conf,
                                       gradient_checkpointing=remat)
        _fit(net, **kw)
        nets.append(net)
    return nets


@pytest.mark.parametrize("make", [_port_mlp, _port_graph])
def test_checkpointing_trains_identically(make):
    """Mirrors tests/test_remat.py:52,90: with dropout on, the recompute
    draws the forward's masks, so the result is bitwise the same."""
    a, b = _remat(lambda: make(dropout=0.3), scan_steps=2)
    assert _equal(a, b)


LM = dict(vocab_size=32, seq_length=16, n_layers=2, n_embd=16, n_heads=2,
          mlp_ratio=2, attention_impl="flash", block_size=8, seed=3)


def _tokens(n, t, vocab, seed):
    rs = np.random.RandomState(seed)
    seq = rs.randint(0, vocab, (n, t + 1))
    return (seq[:, :t, None].astype("float32"),
            np.eye(vocab, dtype="float32")[seq[:, 1:]])


def test_checkpointing_lm_with_dropout_trains_identically():
    """Mirrors tests/test_remat.py:119 on the LM, with its residual and
    attention-probability dropout on."""
    X, Y = _tokens(8, 16, 32, seed=1)
    nets = []
    for remat in (False, True):
        net = model_by_name("TransformerLM", dropout=0.2, **LM).init(
            device="cpu")
        net.conf = dataclasses.replace(net.conf,
                                       gradient_checkpointing=remat)
        net.fit((X, Y), batch_size=4, epochs=2)
        nets.append(net)
    assert _equal(*nets)


def test_checkpointing_matches_the_reference(tmp_path):
    jconf = dataclasses.replace(_mlp(JNNC, jff, JIT, jupd.Adam(1e-2)),
                                gradient_checkpointing=True)
    path = str(tmp_path / "r.zip")
    jax_save(JMLN(jconf).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    assert pnet.conf.gradient_checkpointing
    X, Y = _blobs(n=128)
    jnet.fit(JArrayIt(X, Y, batch_size=32), prefetch=False)
    pnet.fit(ArrayDataSetIterator(X, Y, batch_size=32))
    _close_to_ref(pnet, jnet, 1e-5)


# ------------------------------------------------- attention dropout
def test_attention_probability_dropout_by_its_distribution():
    mha = pattn.MultiHeadAttention(n_out=16, n_heads=2, use_rope=False,
                                   attention_dropout=0.25,
                                   attention_impl="flash")
    p, _ = mha.init(torch.Generator().manual_seed(0),
                    InputType.recurrent(16, 64))
    x = torch.randn(4, 64, 16, generator=torch.Generator().manual_seed(1))
    eval_y = mha.apply(p, {}, x)[0]
    # eval mode, and training without a generator, are the dropout-free
    # output
    assert torch.equal(mha.apply(p, {}, x, train=True)[0], eval_y)
    no_drop = dataclasses.replace(mha, attention_dropout=0.0)
    assert torch.allclose(no_drop.apply(p, {}, x)[0], eval_y, atol=1e-6)
    # the kept share of the probability weights is 1 - p within 5 sigma,
    # and kept weights are scaled by 1 / (1 - p)
    q, k, v = (torch.randn(4, 64, 2, 8, generator=torch.Generator()
                           .manual_seed(s)) for s in (2, 3, 4))
    ones = torch.ones_like(v)
    g = torch.Generator().manual_seed(5)
    out = pattn.dot_product_attention(q, k, ones, dropout=0.25, generator=g)
    # with V = 1 each output is the row sum of the dropped weights
    rows = out[..., 0]
    assert abs(rows.mean().item() - 1.0) < 5 * rows.std().item() / \
        rows.numel() ** 0.5
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8 ** 0.5, -1)
    g = torch.Generator().manual_seed(5)
    kept = pattn.uniform(w.shape, g, w.device) < 0.75
    share = kept.float().mean().item()
    n = kept.numel()
    assert abs(share - 0.75) < 5 * (0.75 * 0.25 / n) ** 0.5
    # training differs from eval, and one generator state repeats
    t1 = mha.apply(p, {}, x, train=True,
                   generator=torch.Generator().manual_seed(9))[0]
    t2 = mha.apply(p, {}, x, train=True,
                   generator=torch.Generator().manual_seed(9))[0]
    assert torch.equal(t1, t2) and not torch.allclose(t1, eval_y)


# ------------------------------------------------------------- evaluate
@pytest.mark.parametrize("method", ["evaluate", "evaluate_roc_multi_class",
                                    "evaluate_regression"])
def test_evaluate_matches_the_reference(tmp_path, method):
    path = _ref_mlp_zip(tmp_path, jupd.Sgd(0.1))
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = _blobs(n=96)
    jev = getattr(jnet, method)(JArrayIt(X, Y, batch_size=32))
    pev = getattr(pnet, method)(ArrayDataSetIterator(X, Y, batch_size=32))
    if method == "evaluate":
        assert pev.accuracy() == jev.accuracy()
        np.testing.assert_array_equal(pev.confusion.matrix,
                                      jev.confusion.matrix)
        assert pev.f1() == pytest.approx(jev.f1(), rel=1e-12)
    elif method == "evaluate_roc_multi_class":
        for c in range(3):
            np.testing.assert_allclose(pev.calculate_auc(c),
                                       jev.calculate_auc(c), rtol=1e-5)
    else:
        np.testing.assert_allclose(pev.mean_squared_error(0),
                                   jev.mean_squared_error(0), rtol=1e-5)


def test_graph_evaluate_and_roc_match_the_reference(tmp_path):
    jconf = _graph(JNNC, JGB, jff, jnorm, JIT, jupd.Sgd(0.1))
    jconf = dataclasses.replace(jconf, vertices={
        **jconf.vertices, "out": dataclasses.replace(
            jconf.vertices["out"], vertex=jff.OutputLayer(
                n_out=1, activation="sigmoid", loss="xent"))})
    path = str(tmp_path / "g.zip")
    jax_save(JCG(jconf).init(), path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, _ = _blobs(n=40)
    Y = (X[:, :1] > 0).astype("float32")
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
    jroc = jnet.evaluate_roc(JMDS((X,), (Y,)), batch_size=16)
    proc = pnet.evaluate_roc(MultiDataSet((X,), (Y,)), batch_size=16)
    np.testing.assert_allclose(proc.calculate_auc(), jroc.calculate_auc(),
                               rtol=1e-6)
    # Evaluation of the 3-class softmax graph (the reference's Evaluation
    # does not take a one-column sigmoid output)
    jax_save(JCG(_graph(JNNC, JGB, jff, jnorm, JIT, jupd.Sgd(0.1))).init(),
             path)
    jnet, pnet = jax_load(path), load_model(path, device="cpu")
    X, Y = _blobs(n=40)
    jev = jnet.evaluate(JMDS((X,), (Y,)), batch_size=16)
    pev = pnet.evaluate(MultiDataSet((X,), (Y,)), batch_size=16)
    assert pev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(pev.confusion.matrix, jev.confusion.matrix)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("case,item", [("tbptt", "A.7"), ("plan", "A.15"),
                                       ("rnn_time_step", "A.7")])
def test_what_still_raises_names_its_roadmap_item(container, case, item):
    """Sharding plans train now (a plan must be a ShardingPlan). tbptt and
    rnn_time_step (item A.7) are ported: on these feed-forward nets the
    multilayer network chunks the (B, 4) features as the reference does
    (one chunk of the default 20 covers them, so tbptt equals the
    standard fit), the graph refuses tbptt without a sequence input, and
    rnn_time_step returns output()'s values."""
    net = _port_mlp() if container == "mln" else _port_graph()
    X, Y = _blobs(n=32)
    if case == "plan":
        # sharding plans train now (tests/test_torch_plan.py): anything
        # but a ShardingPlan is refused, and a one-rank plan is bitwise
        # the plain fit
        from deeplearning4j_tpu_torch.parallel import ShardingPlan
        with pytest.raises(TypeError, match="ShardingPlan"):
            net.fit(ArrayDataSetIterator(X, Y, batch_size=16), plan=object())
        plain = _port_mlp() if container == "mln" else _port_graph()
        plain.fit(ArrayDataSetIterator(X, Y, batch_size=16))
        net.fit(ArrayDataSetIterator(X, Y, batch_size=16),
                plan=ShardingPlan(zero_stage=3))
        assert _equal(net, plain) and net.score() == plain.score()
    elif case == "tbptt":
        net.conf = dataclasses.replace(net.conf, backprop_type="tbptt")
        if container == "graph":
            with pytest.raises(ValueError, match="at least one RNN"):
                net.fit(ArrayDataSetIterator(X, Y, batch_size=16))
            return
        std = _port_mlp()
        for n in (net, std):
            n.fit(ArrayDataSetIterator(X, Y, batch_size=16))
        assert net.iteration_count == std.iteration_count == 2
        assert _equal(net, std)
    else:
        out = net.rnn_time_step(X)
        torch.testing.assert_close(out, net.output(X))
