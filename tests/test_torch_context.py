"""Context parallelism (`parallel/context.py`) and the attention layers'
context-parallel mode against the reference's.

The same seeded reference transformer (a zip both sides load) trains
with the reference's `ContextParallelTrainer` over data x seq of the
conftest's 8 CPU devices and with the port's over a data x seq gloo group
of spawned ranks (`tests/_torch_dist`), for 3 steps: a MultiLayerNetwork
and a single-input, single-output ComputationGraph, dense and flash
attention (the port's flash path is the LSE-merged flash ring, the plain
versions on the CPU; the reference's is its online ring there), with and
without feature and label masks (valid steps bunched in the first shards,
fully masked rows and shards included). Every rank ends with the same
parameters, within 1e-5 relative of the reference's in f32 (1e-10 in
f64). The constructor's refusals, the layers' position offsets and the
other non-slow cases of the reference's `tests/test_attention.py:164-489`
(the MoE expert-parallel specs, the blockwise impl) are the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import RankPool, assert_params_close, ref_flat
from deeplearning4j_tpu.data.dataset import (
    DataSet as JDataSet, MultiDataSet as JMultiDataSet,
)
from deeplearning4j_tpu.data.iterator import (
    ExistingDataSetIterator as JExisting,
)
from deeplearning4j_tpu.util.serialization import (
    load_model as jload, save_model as jsave,
)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def char_data(vocab=16, b=12, t=16, seed=0, dtype="float32"):
    """Token ids (B, T, 1) and one-hot next-token labels (B, T, vocab)."""
    rs = np.random.RandomState(seed)
    x = rs.randint(0, vocab, (b, t)).astype(dtype)
    y = np.eye(vocab, dtype=dtype)[(x.astype(int) + 1) % vocab]
    return x[..., None], y


def lm_conf(attention_impl="dense", seed=3, dtype="float32", t=16,
            n_layers=1, block_size=512):
    """The zoo LM, one block. In f64 with the zoo's own AdamW and
    global-norm clip. In f32 with Nesterov momentum at lr 0.05: AdamW's
    g / (|g| + eps) turns the f32 summation-order noise of a near-zero
    gradient (two rings, two orders) into a good part of lr, and at this
    lr a gradient's f32 rounding (about 1e-5 of it between two orders)
    moves a parameter by less than the tolerance, while a wrong term of
    the gradient moves it by orders of magnitude more."""
    from deeplearning4j_tpu.models import TransformerLM
    from deeplearning4j_tpu.nn.updaters import Nesterovs
    conf = TransformerLM(vocab_size=16, seq_length=t, n_layers=n_layers,
                         n_embd=32, n_heads=4, learning_rate=1e-2,
                         seed=seed, attention_impl=attention_impl,
                         block_size=block_size).conf()
    if dtype != "float32":
        return dataclasses.replace(conf, dtype=dtype)
    return dataclasses.replace(
        conf, updater=Nesterovs(learning_rate=0.05, momentum=0.9))


def graph_conf(t=16, vocab=16, seed=5, attention_impl="flash",
               dtype="float32"):
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import (
        GraphBuilder, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu.nn.layers import (
        EmbeddingSequenceLayer, PositionalEmbeddingLayer, RnnOutputLayer,
        TransformerBlock,
    )
    from deeplearning4j_tpu.nn.updaters import Nesterovs
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(seed)
                      .updater(Nesterovs(learning_rate=0.05,
                                         momentum=0.9)))
         .add_inputs("tokens").set_input_types(InputType.recurrent(1, t)))
    g.add_layer("emb", EmbeddingSequenceLayer(n_in=vocab, n_out=32),
                "tokens")
    g.add_layer("pos", PositionalEmbeddingLayer(max_length=32), "emb")
    g.add_layer("block", TransformerBlock(n_out=32, n_heads=4, causal=True,
                                          use_rope=True,
                                          attention_impl=attention_impl),
                "pos")
    g.add_layer("head", RnnOutputLayer(n_out=vocab, activation="softmax",
                                       loss="mcxent"), "block")
    g.set_outputs("head")
    conf = g.build()
    return dataclasses.replace(conf, dtype=dtype) if dtype != "float32" \
        else conf


def save(conf, path, graph=False):
    if graph:
        from deeplearning4j_tpu.nn.graph import ComputationGraph as C
    else:
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as C
    jsave(C(conf).init(), str(path))
    return str(path)


def ref_source(net, X, Y, batch, fmask=None, lmask=None):
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    cut = (lambda a, i: None if a is None else a[i:i + batch])
    if isinstance(net, ComputationGraph):
        return [JMultiDataSet(
            (X[i:i + batch],), (Y[i:i + batch],),
            None if fmask is None else (cut(fmask, i),),
            None if lmask is None else (cut(lmask, i),))
            for i in range(0, len(X), batch)]
    return JExisting([JDataSet(X[i:i + batch], Y[i:i + batch],
                               cut(fmask, i), cut(lmask, i))
                      for i in range(0, len(X), batch)])


def ref_mesh(data=1, seq=1, stage=1):
    import jax

    from deeplearning4j_tpu.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(data=data, seq=seq, stage=stage),
                      devices=jax.devices()[:data * seq * stage])


def ref_cp_fit(path, X, Y, batch, data, seq, fmask=None, lmask=None):
    from deeplearning4j_tpu.parallel import ContextParallelTrainer
    net = jload(path)
    ContextParallelTrainer(net, ref_mesh(data, seq)).fit(
        ref_source(net, X, Y, batch, fmask, lmask), epochs=1,
        batch_size=batch)
    return net


def check(out, ref, f64=False, steps=3):
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
        assert o["iterations"] == steps
    assert_params_close(out[0]["flat"], ref_flat(ref), f64=f64)
    np.testing.assert_allclose(out[0]["scores"][-1], ref.score(),
                               rtol=1e-10 if f64 else 1e-5)


def masks(b=12, t=16):
    """Valid steps bunched in the first shards: whole shards and the
    first rows of every later shard fully masked."""
    m = np.zeros((b, t), np.float32)
    m[:, :5] = 1.0
    m[:, t - 1] = 1.0
    m[::3, 5:9] = 1.0
    return m


GRID = [("seq2", 1, 2), ("seq4", 1, 4), ("dp2_seq2", 2, 2)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name,data,seq", GRID, ids=[g[0] for g in GRID])
def test_context_parallel_lm_matches_the_reference(pool, tmp_path, name,
                                                   data, seq, impl):
    """Three steps of a one-block LM over each mesh, dense attention (the
    online ring) and flash (the LSE-merged flash ring)."""
    path = save(lm_conf(impl), tmp_path / "lm.zip")
    X, Y = char_data(seed=7)
    ref = ref_cp_fit(path, X, Y, 4, data, seq)
    out = pool.run("context_fit", data * seq, zip_path=path, X=X, Y=Y,
                   batch=4, data=data, seq=seq)
    check(out, ref)
    if seq > 1:
        # CPU tensors on gloo: no host staging; no kernel launch
        assert set(out[0]["routes"]) == {"gloo"}
    assert not any(out[0]["launches"].values())


MASKS = [("fmask", True, False, 1, 2), ("lmask", False, True, 2, 2),
         ("both", True, True, 1, 4)]


@pytest.mark.parametrize("name,fm,lm,data,seq", MASKS,
                         ids=[m[0] for m in MASKS])
def test_context_parallel_masked_matches_the_reference(pool, tmp_path, name,
                                                       fm, lm, data, seq):
    """Feature and label masks: shards hold different numbers of valid
    steps, so the loss is psum(loss * count) / psum(count); the flash
    ring meets fully masked rows and shards."""
    path = save(lm_conf("flash", seed=9), tmp_path / "lm.zip")
    X, Y = char_data(seed=11)
    m = masks()
    kw = dict(fmask=m if fm else None,
              lmask=(1.0 - (np.arange(16) >= 12)[None] * np.ones((12, 1))
                     ).astype(np.float32) if lm else None)
    ref = ref_cp_fit(path, X, Y, 4, data, seq, **kw)
    out = pool.run("context_fit", data * seq, zip_path=path, X=X, Y=Y,
                   batch=4, data=data, seq=seq, **kw)
    check(out, ref)


GRAPH = [("plain", 1, 2, {}, "float32"),
         ("fmask", 2, 2, dict(fmask=masks()), "float32"),
         ("lmask_f64", 1, 4, dict(lmask=masks()[::-1].astype("float64")),
          "float64")]


@pytest.mark.parametrize("name,data,seq,kw,dtype", GRAPH,
                         ids=[g[0] for g in GRAPH])
def test_context_parallel_graph_matches_the_reference(pool, tmp_path,
                                                      request, name, data,
                                                      seq, kw, dtype):
    """A single-input, single-output ComputationGraph with learned
    positions (each shard takes its rows) over seq=2, data x seq and
    seq=4, with a feature mask and with a labels mask (in f64: in f32
    two of 14,640 parameters of this case sit 3.8e-5 apart by rounding,
    while f64 agrees to 1e-12)."""
    if dtype == "float64":
        request.getfixturevalue("jax_x64")
    path = save(graph_conf(dtype=dtype), tmp_path / "g.zip", graph=True)
    X, Y = char_data(seed=9, dtype=dtype)
    ref = ref_cp_fit(path, X, Y, 4, data, seq, **kw)
    out = pool.run("context_fit", data * seq, zip_path=path, X=X, Y=Y,
                   batch=4, data=data, seq=seq, **kw)
    check(out, ref, f64=dtype == "float64")


def test_context_parallel_f64_matches_the_reference(pool, tmp_path,
                                                    jax_x64):
    """f64: the flash ring's merge runs in f64, within 1e-10."""
    path = save(lm_conf("flash", dtype="float64"), tmp_path / "lm.zip")
    X, Y = char_data(seed=5, dtype="float64")
    ref = ref_cp_fit(path, X, Y, 4, 1, 2, fmask=masks().astype("float64"))
    out = pool.run("context_fit", 2, zip_path=path, X=X, Y=Y, batch=4,
                   data=1, seq=2, fmask=masks().astype("float64"))
    check(out, ref, f64=True)


@pytest.fixture
def jax_x64():
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------- refusals
def _port_lm(conf_fn):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(conf_fn(), device="cpu").init()


def _port_conf(layers, input_type):
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    b = NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3)).list()
    for layer in layers:
        b = b.layer(layer)
    return b.set_input_type(input_type).build()


def _one_rank_mesh():
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    return Mesh(1, 1, seq=1)


def test_context_parallel_refuses_what_the_reference_refuses():
    """An LSTM, a LastTimeStep wrapper, a multi-input graph, tbptt and a
    batch or sequence the mesh does not divide raise the reference's
    errors."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        GraphBuilder, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM, DenseLayer, LastTimeStep, MultiHeadAttention, OutputLayer,
        RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import ContextParallelTrainer
    mesh = _one_rank_mesh()
    lstm = MultiLayerNetwork(_port_conf(
        [LSTM(n_out=8), RnnOutputLayer(n_out=4, activation="softmax",
                                       loss="mcxent")],
        InputType.recurrent(4, 8)), device="cpu").init()
    with pytest.raises(ValueError, match="sequence shards"):
        ContextParallelTrainer(lstm, mesh)
    wrapped = MultiLayerNetwork(_port_conf(
        [LastTimeStep(layer=MultiHeadAttention(n_out=8, n_heads=2)),
         OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
        InputType.recurrent(4, 8)), device="cpu").init()
    with pytest.raises(ValueError, match="sequence shards"):
        ContextParallelTrainer(wrapped, mesh)
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(0)
                      .updater(Adam(1e-3)))
         .add_inputs("a", "b")
         .set_input_types(InputType.feed_forward(4),
                          InputType.feed_forward(4)))
    g.add_vertex("cat", MergeVertex(), "a", "b")
    g.add_layer("d", DenseLayer(n_out=4), "cat")
    g.add_layer("out", OutputLayer(n_out=2), "d")
    g.set_outputs("out")
    with pytest.raises(ValueError, match="single-input"):
        ContextParallelTrainer(ComputationGraph(g.build(), device="cpu")
                               .init(), mesh)
    tb = dataclasses.replace(
        _port_conf([MultiHeadAttention(n_out=8, n_heads=2),
                    RnnOutputLayer(n_out=4)], InputType.recurrent(4, 8)),
        backprop_type="tbptt")
    with pytest.raises(ValueError, match="standard backprop"):
        ContextParallelTrainer(MultiLayerNetwork(tb, device="cpu").init(),
                               mesh)
    t = ContextParallelTrainer(
        MultiLayerNetwork(_port_conf(
            [MultiHeadAttention(n_out=8, n_heads=2), RnnOutputLayer(n_out=4)],
            InputType.recurrent(4, 8)), device="cpu").init(), mesh)
    t.data_degree, t.seq_degree = 2, 3
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        t._check_divisible(np.zeros((3, 6, 4)))
    with pytest.raises(ValueError, match="sequence length 4 not divisible"):
        t._check_divisible(np.zeros((4, 4, 4)))


def test_layers_offset_positions_by_the_shards_start():
    """Under context_parallel, RoPE and learned positions start at index
    x T_local: shard i of a sequence gives the rows the whole sequence
    gives there; a global length past max_length raises, as the
    reference's check does."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        MultiHeadAttention, PositionalEmbeddingLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        context_parallel, rope,
    )
    g = torch.Generator().manual_seed(0)
    pe = PositionalEmbeddingLayer(max_length=16)
    p, _ = pe.init(g, InputType.recurrent(8, 16))
    x = torch.randn(2, 16, 8, generator=g)
    whole, _ = pe.apply(p, {}, x)
    for i in range(4):
        with context_parallel(None, i, 4):
            part, _ = pe.apply(p, {}, x[:, 4 * i:4 * (i + 1)])
        torch.testing.assert_close(part, whole[:, 4 * i:4 * (i + 1)],
                                   rtol=0, atol=0)
    with context_parallel(None, 0, 5), pytest.raises(ValueError,
                                                     match="max_length"):
        pe.apply(p, {}, x[:, :4])
    with pytest.raises(ValueError, match="max_length"):
        PositionalEmbeddingLayer(max_length=4).apply(
            {"P": torch.zeros(4, 3)}, {}, torch.zeros(1, 8, 3))
    # RoPE at the shard's global positions: one rank's ring is the
    # whole sequence when the layer sees the shard's offset
    q = torch.randn(1, 16, 2, 8, generator=g)
    pos = torch.arange(16)[None]
    with context_parallel(None, 1, 2):
        from deeplearning4j_tpu_torch.nn.layers.attention import _seq_offset
        off = _seq_offset(8)
    torch.testing.assert_close(rope(q[:, 8:], pos[:, :8] + off),
                               rope(q, pos)[:, 8:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="even head dim"):
        MultiHeadAttention(n_out=36, n_heads=4).init(
            g, InputType.recurrent(8, 4))


def test_the_reference_refuses_the_same_lstm():
    """The reference's refusal of an LSTM, for the record beside the
    port's (its message is the one matched above)."""
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.nn.updaters import Adam
    from deeplearning4j_tpu.parallel import ContextParallelTrainer
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3))
            .list().layer(LSTM(n_out=8))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(4, 8)).build())
    with pytest.raises(ValueError, match="sequence shards"):
        ContextParallelTrainer(MultiLayerNetwork(conf).init(),
                               ref_mesh(1, 1))


def test_moe_expert_parallel_specs_are_the_references():
    """The LM's rules shard a MoE layer's stacked experts over `model` and
    a dense block's W1 column-wise, leaf for leaf as the reference's
    `shard_params` places them on a data=4, model=2 mesh."""
    import jax

    from deeplearning4j_tpu.models import TransformerLMMoE as JMoE
    from deeplearning4j_tpu.models import TransformerLM as JLM
    from deeplearning4j_tpu.parallel import MeshConfig as JConfig
    from deeplearning4j_tpu.parallel import build_mesh as jbuild
    from deeplearning4j_tpu.parallel import shard_params as jshard
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerLM, TransformerLMMoE,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    kw = dict(vocab_size=16, seq_length=16, n_layers=2, n_embd=32,
              n_heads=4, n_experts=4)
    ref = JMoE(**kw).init()
    placed = jshard(ref.params, jbuild(JConfig(data=4, model=2),
                                       devices=jax.devices()[:8]),
                    JLM.sharding_rules())
    port = MultiLayerNetwork(TransformerLMMoE(**kw).conf(),
                             device="cpu").init()
    rules = TransformerLM.sharding_rules()
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    leaves = dict(iter_leaves(port.params))
    for path, leaf in leaves.items():
        node = placed
        for k in path:
            node = node[k]
        want = tuple(node.sharding.spec)
        got = tuple(rules.spec_for("/".join(path), leaf.ndim))
        assert got + (None,) * (len(want) - len(got)) == want, path
    assert tuple(rules.spec_for("3/W1", 3)) == ("model", None, None)
    assert tuple(rules.spec_for("1/W1", 2)) == (None, "model")


def test_blockwise_attention_impl_pads_and_rides_the_zoo():
    """attention_impl "blockwise" with a sequence shorter than, and not
    divisible by, its block runs (padded like the flash path) and gives
    dense attention's answer; the zoo LM carries the impl and block size
    into its blocks."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
    g = torch.Generator().manual_seed(0)
    layer = MultiHeadAttention(n_out=16, n_heads=2,
                               attention_impl="blockwise")
    params, state = layer.init(g, InputType.recurrent(8, 12))
    x = torch.randn(3, 12, 8, generator=g)
    y, _ = layer.apply(params, state, x)
    dense = MultiHeadAttention(n_out=16, n_heads=2, attention_impl="dense")
    y2, _ = dense.apply(params, state, x)
    assert y.shape == (3, 12, 16)
    torch.testing.assert_close(y, y2, rtol=2e-4, atol=2e-4)
    conf = TransformerLM(vocab_size=8, seq_length=16, n_layers=1, n_embd=16,
                         n_heads=2, attention_impl="blockwise",
                         block_size=4).conf()
    assert conf.layers[1].attention_impl == "blockwise"
    assert conf.layers[1].block_size == 4


def test_context_parallel_with_dropout_keeps_ranks_equal(pool, tmp_path):
    """Attention and residual dropout: the ring runs its online form with
    each (data, seq) shard drawing its own masks, the gradient exchange
    keeps every rank's parameters bitwise equal, and the masks move the
    fit off the dropout-free one."""
    import dataclasses as dc

    from deeplearning4j_tpu.models import TransformerLM
    from deeplearning4j_tpu.nn.updaters import Nesterovs
    conf = TransformerLM(vocab_size=16, seq_length=16, n_layers=1, n_embd=32,
                         n_heads=4, seed=3, dropout=0.1,
                         attention_impl="flash").conf()
    conf = dc.replace(conf, updater=Nesterovs(learning_rate=0.05,
                                               momentum=0.9))
    path = save(conf, tmp_path / "drop.zip")
    X, Y = char_data(seed=7)
    out = pool.run("context_fit", 4, zip_path=path, X=X, Y=Y, batch=4,
                   data=2, seq=2)
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
        assert o["iterations"] == 3 and np.all(np.isfinite(o["scores"]))
    plain = save(dc.replace(conf, layers=tuple(
        dc.replace(layer, attention_dropout=0.0, residual_dropout=0.0)
        if hasattr(layer, "residual_dropout") else layer
        for layer in conf.layers)), tmp_path / "plain.zip")
    ref = pool.run("context_fit", 4, zip_path=plain, X=X, Y=Y, batch=4,
                   data=2, seq=2)
    assert not np.allclose(out[0]["flat"], ref[0]["flat"])
