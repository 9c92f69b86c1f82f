"""The port's ComputationGraph slice against the JAX package: every graph
vertex, `ComputationGraphConfiguration` (JSON and YAML both ways, the
topological order), mask routing, and `ComputationGraph` itself (output
from one zip each way, fit steps, score, params_flat, summary, the
checkpoint with its updaterState.bin both ways, constraints, and the
paths that still raise).

Tolerances: vertices f32 atol 1e-6, rtol 1e-5 (elementwise math);
graph outputs atol 1e-5; fit losses rtol 1e-4 and parameters atol 1e-5
(a few Adam steps of f32 noise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.models.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu.nn import regularization as jreg
from deeplearning4j_tpu.nn.conf import graph_vertices as jgv
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    ComputationGraphConfiguration as JCGC, GraphBuilder as JGB,
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as pgv
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd, tree_leaves
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, restore_computation_graph, save_model,
)

VTOL = dict(atol=1e-6, rtol=1e-5)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# ------------------------------------------------------------- vertices
VERTEX_CASES = [
    ("MergeVertex", {}, [(2, 3), (2, 4)]),
    ("MergeVertex", {}, [(2, 5, 3), (2, 5, 2)]),
    ("MergeVertex", {}, [(2, 3, 4, 2), (2, 3, 4, 3)]),
    ("ElementWiseVertex", dict(op="add"), [(2, 4)] * 3),
    ("ElementWiseVertex", dict(op="subtract"), [(2, 4)] * 2),
    ("ElementWiseVertex", dict(op="product"), [(2, 3, 4)] * 3),
    ("ElementWiseVertex", dict(op="max"), [(2, 4)] * 3),
    ("ElementWiseVertex", dict(op="average"), [(2, 4)] * 2),
    ("SubsetVertex", dict(from_idx=1, to_idx=3), [(2, 6)]),
    ("SubsetVertex", dict(from_idx=0, to_idx=1), [(2, 3, 3, 4)]),
    ("StackVertex", {}, [(2, 4), (3, 4)]),
    ("UnstackVertex", dict(from_idx=1, stack_size=3), [(6, 4)]),
    ("ReshapeVertex", dict(new_shape=(2, 6), kind="rnn"), [(3, 12)]),
    ("ScaleVertex", dict(scale=-2.5), [(2, 4)]),
    ("ShiftVertex", dict(shift=0.7), [(2, 4)]),
    ("L2NormalizeVertex", {}, [(3, 5)]),
    ("L2Vertex", {}, [(3, 2, 4), (3, 2, 4)]),
    ("LastTimeStepVertex", {}, [(2, 5, 3)]),
    ("DuplicateToTimeSeriesVertex", {}, [(2, 3), (2, 6, 4)]),
    ("ReverseTimeSeriesVertex", {}, [(2, 5, 3)]),
    ("PoolHelperVertex", {}, [(2, 4, 5, 3)]),
]


def _input_type(shape, jax_side):
    it = JIT if jax_side else InputType
    if len(shape) == 2:
        return it.feed_forward(shape[1])
    if len(shape) == 3:
        return it.recurrent(shape[2], shape[1])
    return it.convolutional(*shape[1:])


@pytest.mark.parametrize("name,kw,shapes", VERTEX_CASES)
def test_vertex_forward_gradients_and_type(name, kw, shapes):
    jv, pv = getattr(jgv, name)(**kw), getattr(pgv, name)(**kw)
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    jy = jv.apply(*map(jnp.asarray, xs))
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    y = pv.apply(*txs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **VTOL)
    g = _x(*jy.shape, seed=9)
    jgrads = jax.grad(lambda *a: (jv.apply(*a) * g).sum(),
                      argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    tgrads = torch.autograd.grad((y * torch.from_numpy(g)).sum(), txs,
                                 allow_unused=True)
    for t, r in zip(tgrads, jgrads):
        t = torch.zeros(r.shape) if t is None else t
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **VTOL)
    jt = jv.output_type(*(_input_type(s, True) for s in shapes))
    pt = pv.output_type(*(_input_type(s, False) for s in shapes))
    assert pt.to_dict() == jt.to_dict()
    assert not pv.has_params()


@pytest.mark.parametrize("name,kw,shapes", [
    c for c in VERTEX_CASES if c[0] in (
        "MergeVertex", "DuplicateToTimeSeriesVertex", "StackVertex",
        "UnstackVertex", "ReverseTimeSeriesVertex", "ElementWiseVertex")])
@pytest.mark.parametrize("which", ["none", "first", "all"])
def test_vertex_mask_propagation(name, kw, shapes, which):
    jv, pv = getattr(jgv, name)(**kw), getattr(pgv, name)(**kw)
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    rs = np.random.RandomState(3)
    masks = []
    for i, x in enumerate(xs):
        on = which == "all" or (which == "first" and i == 0)
        masks.append((rs.rand(*x.shape[:2]) > 0.3).astype("float32")
                     if on and x.ndim >= 2 else None)
    jt = jv.output_type(*(_input_type(s, True) for s in shapes))
    pt = pv.output_type(*(_input_type(s, False) for s in shapes))
    jm = JCG._vertex_out_mask(jv, masks, xs, jt)
    pm = ComputationGraph._vertex_out_mask(
        pv, [None if m is None else torch.from_numpy(m) for m in masks],
        [torch.from_numpy(x) for x in xs], pt)
    assert (jm is None) == (pm is None)
    if jm is not None:
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


# ------------------------------------------------------ configuration
def _small_graph(nnc, gb, ff, rec, gv, it, net_updater, **dense_kw):
    """Two inputs (a masked sequence and a vector), the vertices that
    route masks, two outputs (a per-step head and a classifier)."""
    g = (gb(nnc.Builder().seed(5).updater(net_updater).l2(1e-3))
         .add_inputs("seq", "vec")
         .set_input_types(it.recurrent(3, 5), it.feed_forward(4)))
    g.add_vertex("rev", gv.ReverseTimeSeriesVertex(), "seq")
    g.add_vertex("last", gv.LastTimeStepVertex(), "seq")
    g.add_vertex("merge_ff", gv.MergeVertex(), "last", "vec")
    g.add_layer("dense", ff.DenseLayer(n_out=6, activation="tanh",
                                       **dense_kw), "merge_ff")
    g.add_vertex("scaled", gv.ScaleVertex(scale=0.5), "dense")
    g.add_vertex("dup", gv.DuplicateToTimeSeriesVertex(), "scaled", "seq")
    g.add_vertex("merge_seq", gv.MergeVertex(), "rev", "dup")
    g.add_layer("out_seq", rec.RnnOutputLayer(n_out=2), "merge_seq")
    g.add_layer("out_ff", ff.OutputLayer(n_out=3), "dense")
    g.set_outputs("out_seq", "out_ff")
    return g.build()


def _jax_small(**kw):
    return _small_graph(JNNC, JGB, jff, jrec, jgv, JIT, JAdam(1e-2), **kw)


def _port_small(**kw):
    from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
    return _small_graph(NeuralNetConfiguration, GraphBuilder, pff, prec,
                        pgv, InputType, Adam(1e-2), **kw)


def _resnet_conf(**kw):
    return JResNet50(num_classes=10, input_shape=(32, 32, 3), **kw).conf()


@pytest.mark.parametrize("make", [_jax_small, _resnet_conf,
                                  lambda: _resnet_conf(
                                      space_to_depth_stem=True)])
def test_reference_json_reads_in_the_port_and_writes_back_equal(make):
    ref = make()
    port = ComputationGraphConfiguration.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict()
    assert JCGC.from_json(port.to_json()) == ref
    assert port.topological_order() == ref.topological_order()
    assert list(port.vertices) == list(ref.vertices)


def test_yaml_both_ways():
    ref = _jax_small()
    port = ComputationGraphConfiguration.from_yaml(ref.to_yaml())
    assert port.to_dict() == ref.to_dict()
    assert JCGC.from_yaml(port.to_yaml()) == ref


def test_builder_gives_the_reference_config():
    assert _port_small().to_dict() == _jax_small().to_dict()


def test_topological_order_is_the_reference_s_for_any_insertion_order():
    ref = _jax_small()
    names = list(ref.vertices)
    rs = np.random.RandomState(0)
    for _ in range(5):
        order = [names[i] for i in rs.permutation(len(names))]
        shuffled = dataclasses.replace(
            ref, vertices={n: ref.vertices[n] for n in order})
        port = ComputationGraphConfiguration.from_json(shuffled.to_json())
        assert port.topological_order() == shuffled.topological_order()
    bad = ComputationGraphConfiguration.from_json(dataclasses.replace(
        ref, vertices={"a": dataclasses.replace(ref.vertices["dense"],
                                                inputs=("b",)),
                       "b": dataclasses.replace(ref.vertices["dense"],
                                                inputs=("a",))}).to_json())
    with pytest.raises(ValueError, match="cycle"):
        bad.topological_order()


# ----------------------------------------------------- ComputationGraph
def _batch(n=6, seed=1):
    rs = np.random.RandomState(seed)
    seq = rs.randn(n, 5, 3).astype("float32")
    vec = rs.randn(n, 4).astype("float32")
    mask = np.ones((n, 5), "float32")
    mask[0, 3:] = 0.0
    mask[2, 1:] = 0.0
    y_seq = np.eye(2, dtype="float32")[rs.randint(0, 2, (n, 5))]
    y_ff = np.eye(3, dtype="float32")[rs.randint(0, 3, n)]
    return seq, vec, mask, y_seq, y_ff


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    net = JCG(_jax_small()).init()
    rs = np.random.RandomState(0)
    net.params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype("float32"),
        net.params)
    path = str(tmp_path_factory.mktemp("graph") / "g.zip")
    jax_save(net, path)
    return path


def test_output_from_one_zip_matches(jax_zip):
    jnet, pnet = jax_load(jax_zip), load_model(jax_zip, device="cpu")
    assert isinstance(pnet, ComputationGraph)
    seq, vec, *_ = _batch()
    for a, b in zip(pnet.output(seq, vec), jnet.output(seq, vec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    acts = pnet.feed_forward(seq, vec)
    jacts = jnet.feed_forward(seq, vec)
    for name in ("rev", "merge_seq", "dense", "out_ff"):
        np.testing.assert_allclose(acts[name].numpy(),
                                   np.asarray(jacts[name]), atol=1e-5)


def test_fit_steps_with_masks_match(jax_zip):
    jnet, pnet = jax_load(jax_zip), load_model(jax_zip, device="cpu")
    seq, vec, mask, y_seq, y_ff = _batch()
    mds = [((seq[i:i + 2], vec[i:i + 2]), (y_seq[i:i + 2], y_ff[i:i + 2]),
            (mask[i:i + 2], None)) for i in (0, 2, 4)]
    jc, pc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    pnet.set_listeners(pc)
    jnet.fit([JMDS(f, l, m, None) for f, l, m in mds], epochs=2,
             scan_steps=1)
    pnet.fit([MultiDataSet(f, l, m, None) for f, l, m in mds], epochs=2)
    assert len(pc.scores) == len(jc.scores) == 6
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-4)
    for p, j in zip(tree_leaves(pnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)
    assert pnet.iteration_count == 6 and pnet.epoch_count == 2
    assert pnet.score() == pc.scores[-1][1]
    f, l, _ = mds[0]
    np.testing.assert_allclose(pnet.score(MultiDataSet(f, l)),
                               jnet.score(JMDS(f, l)), rtol=1e-4)
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-5)


def test_checkpoint_and_updater_state_both_ways(jax_zip, tmp_path):
    jnet, pnet = jax_load(jax_zip), load_model(jax_zip, device="cpu")
    seq, vec, mask, y_seq, y_ff = _batch()
    batch = ((seq, vec), (y_seq, y_ff), (mask, None))
    jnet.fit(JMDS(*batch, None), scan_steps=1)
    pnet.fit(MultiDataSet(*batch, None))
    # the port's zip, with its optimizer state, loads in the reference
    # and the reference's in the port; one more step on each agrees
    p_zip, j_zip = str(tmp_path / "p.zip"), str(tmp_path / "j.zip")
    save_model(pnet, p_zip)
    jax_save(jnet, j_zip)
    j_from_p = jax_load(p_zip)
    p_from_j = restore_computation_graph(j_zip, device="cpu")
    assert j_from_p.iteration_count == p_from_j.iteration_count == 1
    j_from_p.fit(JMDS(*batch, None), scan_steps=1)
    p_from_j.fit(MultiDataSet(*batch, None))
    for p, j in zip(tree_leaves(p_from_j.params),
                    jax.tree_util.tree_leaves(j_from_p.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)
    for a, b in zip(p_from_j.output(seq, vec), j_from_p.output(seq, vec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_params_flat_round_trip_num_params_and_summary(jax_zip):
    jnet, pnet = jax_load(jax_zip), load_model(jax_zip, device="cpu")
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary() == jnet.summary()
    flat = pnet.params_flat()
    pnet.set_params_flat(flat * 2)
    np.testing.assert_allclose(pnet.params_flat().numpy(), flat.numpy() * 2)
    assert list(pnet.params) == list(jnet.params)


def test_fit_takes_a_dataset_an_array_pair_and_an_iterator():
    conf = (GraphBuilder(NeuralNetConfiguration.Builder().seed(1)
                         .updater(Sgd(0.1)))
            .add_inputs("in").set_input_types(InputType.feed_forward(4))
            .add_layer("h", pff.DenseLayer(n_out=5, activation="relu"), "in")
            .add_layer("out", pff.OutputLayer(n_out=2), "h")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    X = _x(8, 4)
    Y = np.eye(2, dtype="float32")[np.arange(8) % 2]
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    net.fit((X, Y))
    net.fit(DataSet(X, Y))
    net.fit(ArrayDataSetIterator(X, Y, batch_size=4), epochs=2)
    assert net.iteration_count == 6 and net.epoch_count == 4
    assert net.output(X).shape == (8, 2)


def test_constraints_and_weight_noise_are_wired_into_the_graph_step():
    kw = dict(constraints=(jreg.MaxNormConstraint(max_norm=0.5),))
    jnet = JCG(_jax_small(**kw)).init()
    pconf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    pnet = ComputationGraph(pconf, device="cpu").init()
    from deeplearning4j_tpu_torch.util.serialization import params_from_numpy
    pnet.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu",
        template=pnet.params)
    seq, vec, mask, y_seq, y_ff = _batch()
    jnet.fit(JMDS((seq, vec), (y_seq, y_ff), (mask, None)), scan_steps=1)
    pnet.fit(MultiDataSet((seq, vec), (y_seq, y_ff), (mask, None)))
    w = pnet.params["dense"]["W"]
    np.testing.assert_allclose(w.numpy(), np.asarray(jnet.params["dense"]["W"]),
                               atol=1e-5)
    assert float(torch.sqrt((w * w).sum(0)).max()) <= 0.5 + 1e-6
    from deeplearning4j_tpu_torch.nn import regularization as preg
    from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
    noisy = ComputationGraph(_small_graph(
        NeuralNetConfiguration, GraphBuilder, pff, prec, pgv, InputType,
        Sgd(0.1), weight_noise=preg.DropConnect(p=0.5)), device="cpu").init()
    before = noisy.output(seq, vec)
    noisy.fit(MultiDataSet((seq, vec), (y_seq, y_ff), (mask, None)))
    assert np.isfinite(noisy.score())
    assert not torch.allclose(before[1], noisy.output(seq, vec)[1])


@pytest.mark.parametrize("case", ["scan", "accumulate", "plan", "tbptt",
                                  "checkpointing", "frozen", "updater"])
def test_paths_not_yet_ported_raise_and_name_the_roadmap(case):
    kw = {}
    if case == "frozen":
        kw = dict(frozen=True)
    elif case == "updater":
        kw = dict(updater=Adam(1e-3))
    conf = _port_small(**kw)
    if case == "tbptt":
        conf = dataclasses.replace(conf, backprop_type="tbptt")
    elif case == "checkpointing":
        conf = dataclasses.replace(conf, gradient_checkpointing=True)
    net = ComputationGraph(conf, device="cpu").init()
    seq, vec, mask, y_seq, y_ff = _batch()
    fit_kw = {"scan": dict(scan_steps=4), "accumulate":
              dict(accumulate_steps=2), "plan": dict(plan=object())
              }.get(case, {})
    mds = MultiDataSet((seq, vec), (y_seq, y_ff))
    if case == "plan":
        # sharding plans train now (tests/test_torch_plan.py): anything
        # but a ShardingPlan is refused; a one-rank plan is bitwise the
        # plain fit
        from deeplearning4j_tpu_torch.parallel import ShardingPlan
        with pytest.raises(TypeError, match="ShardingPlan"):
            net.fit(mds, **fit_kw)
        std = ComputationGraph(conf, device="cpu").init()
        net.fit([mds, mds], plan=ShardingPlan())
        std.fit([mds, mds])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(net.params), tree_leaves(std.params)))
    elif case == "tbptt":
        # tbptt trains now (ROADMAP A.7 is ported): one chunk covers T = 5,
        # so it equals the standard fit bitwise (tests/test_torch_tbptt.py
        # holds tbptt to the reference)
        std = ComputationGraph(_port_small(), device="cpu").init()
        net.fit([mds, mds])
        std.fit([mds, mds])
        assert net.iteration_count == std.iteration_count == 2
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(net.params), tree_leaves(std.params)))
    else:
        # the A.6 paths train now (tests/test_torch_fit_paths.py holds
        # them to the reference)
        net.fit([mds, mds], **fit_kw)
        assert np.isfinite(net.score()) and net.iteration_count >= 1
    net.output(seq, vec)                          # inference still works


@pytest.mark.parametrize("method", ["evaluate", "evaluate_roc",
                                    "evaluate_roc_multi_class",
                                    "rnn_time_step"])
def test_evaluation_and_streaming_raise(method):
    net = ComputationGraph(_port_small(), device="cpu").init()
    seq, vec, mask, y_seq, y_ff = _batch()
    if method == "rnn_time_step":
        # streaming is ported (ROADMAP A.7): with no recurrent vertex, a
        # whole sequence streams to output()'s values
        outs = getattr(net, method)(seq, vec)
        for a, b in zip(outs, net.output(seq, vec)):
            torch.testing.assert_close(a, b)
        return
    # evaluation is ported: the first output, mask-padded steps excluded
    ev = getattr(net, method)(MultiDataSet((seq, vec), (y_seq, y_ff),
                                           None, (mask, None)))
    assert ev is not None


def test_graph_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ComputationGraph(_port_small())
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50(num_classes=10, input_shape=(32, 32, 3)).init()


def test_bf16_compute_keeps_f32_master_weights_and_matches_the_reference():
    """Under compute_dtype bfloat16 the params are cast inside the step,
    labels go to bf16, the score sums in f32, and the master weights and
    the optimizer state stay f32 (bf16 tolerance 3e-2)."""
    def conf(nnc, gb, ff, gv, conv, norm, it, updater):
        g = (gb(nnc.Builder().seed(2).updater(updater).l2(1e-3)
                .compute_dtype("bfloat16"))
             .add_inputs("img").set_input_types(it.convolutional(8, 8, 3)))
        g.add_layer("c1", conv.ConvolutionLayer(
            n_out=8, kernel=(3, 3), convolution_mode="same"), "img")
        g.add_layer("bn", norm.BatchNormalization(), "c1")
        g.add_layer("r", ff.ActivationLayer(activation="relu"), "bn")
        g.add_layer("c2", conv.ConvolutionLayer(
            n_out=8, kernel=(3, 3), convolution_mode="same"), "r")
        g.add_vertex("add", gv.ElementWiseVertex(op="add"), "c2", "r")
        g.add_layer("pool", conv.GlobalPoolingLayer(pooling_type="avg"),
                    "add")
        g.add_layer("out", ff.OutputLayer(n_out=4), "pool")
        return g.set_outputs("out").build()

    from deeplearning4j_tpu.nn.layers import convolution as jconv
    from deeplearning4j_tpu.nn.layers import normalization as jnorm
    from deeplearning4j_tpu_torch.nn.layers import convolution as pconv
    from deeplearning4j_tpu_torch.nn.layers import normalization as pnorm
    jnet = JCG(conf(JNNC, JGB, jff, jgv, jconv, jnorm, JIT,
                    JAdam(1e-2))).init()
    pnet = ComputationGraph(conf(NeuralNetConfiguration, GraphBuilder, pff,
                                 pgv, pconv, pnorm, InputType, Adam(1e-2)),
                            device="cpu").init()
    assert pnet.conf.to_dict() == jnet.conf.to_dict()
    from deeplearning4j_tpu_torch.util.serialization import params_from_numpy
    pnet.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu",
        template=pnet.params)
    rs = np.random.RandomState(4)
    X = rs.rand(16, 8, 8, 3).astype("float32")
    Y = np.eye(4, dtype="float32")[rs.randint(0, 4, 16)]
    y = pnet.output(X)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jnet.output(X), np.float32),
                               atol=3e-2)
    jnet.fit(JMDS((X,), (Y,)), scan_steps=1)
    pnet.fit(MultiDataSet((X,), (Y,)))
    np.testing.assert_allclose(pnet.score(), jnet._score, rtol=3e-2)
    assert all(t.dtype == torch.float32 for t in tree_leaves(pnet.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(pnet.opt_state)
               if t.is_floating_point())
    assert all(t.dtype == torch.float32 for t in tree_leaves(pnet.state))
    for p, j in zip(tree_leaves(pnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=3e-2)
