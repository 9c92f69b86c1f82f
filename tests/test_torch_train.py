"""The training slice of the port against the JAX package.

- Layer gradients against `jax.grad`, with the same numpy parameters,
  inputs and cotangents (the JAX flash layers take their blockwise path
  on the CPU, the port its plain flash path through the autograd
  Function).
- The slice: a tiny JAX `TransformerLM(attention_impl="flash")` saved
  with `save_model`, loaded by the port, and 10 `fit` steps on each side
  on the same batches; per-step losses and the parameters after.
- `updaterState.bin` both ways, with one more step on each side.
- The train CLI against the JAX CLI's `--mode single`, and the flags of
  parts not yet ported (and the ported ones in their place: `--dataset
  mnist` failing on a missing cache without `--synthetic-data`;
  `--checkpoint-dir` exiting 3 when preempted and `--resume` finishing
  bitwise the uninterrupted run).

Tolerances: gradients f32 atol 1e-5, rtol 1e-4 (the same f32 math summed
in other orders); fit losses rtol 1e-4 and parameters atol 1e-5 (ten
AdamW steps of that noise).
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.fetchers import (
    IrisDataSetIterator as JIris,
)
from deeplearning4j_tpu.models.zoo import model_by_name as jax_model_by_name
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.layers import attention as jax_attn
from deeplearning4j_tpu.nn.layers import recurrent as jax_rec
from deeplearning4j_tpu.train import cli as jax_cli
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load_model, save_model as jax_save_model,
)
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.fetchers import IrisDataSetIterator
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as port_attn
from deeplearning4j_tpu_torch.nn.layers import recurrent as port_rec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.regularization import GaussianDropout
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd, tree_leaves
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.train import cli
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener, PerformanceListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)

GRAD = dict(atol=1e-5, rtol=1e-4)
LM = dict(vocab_size=48, seq_length=24, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, attention_impl="flash", block_size=16, seed=7)


# ------------------------------------------------------------ layer grads
def _params(layer_jax, input_type, seed=0):
    p, _ = layer_jax.init(jax.random.PRNGKey(seed), input_type)
    rs = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype("float32"),
        p)


def _torch_tree(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(grad), tree)


def _layer_grads(jl, pl, params, x, mask=None, seed=5):
    """d/d(params, x) of sum(apply(...) * g) in both packages."""
    rs = np.random.RandomState(seed)
    g = rs.randn(*x.shape[:-1], jl.n_out if hasattr(jl, "n_out")
                 else x.shape[-1]).astype("float32")
    jmask = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        y, _ = jl.apply(p, {}, xx, train=True, rng=None, mask=jmask)
        return (y * g).sum()

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = _torch_tree(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = pl.apply(tp, {}, tx, train=True,
                    mask=None if mask is None else torch.from_numpy(mask))
    leaves = jax.tree_util.tree_leaves(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                leaves + [tx])
    return (grads, jax.tree_util.tree_leaves(jgp) + [jgx])


def _mask(b, t):
    m = np.ones((b, t), np.float32)
    m[0, t - 5:] = 0.0
    return m


def _assert_grads(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **GRAD)


def test_layer_norm_gradients():
    it = JInputType.recurrent(32, 12)
    jl, pl = jax_attn.LayerNormLayer(), port_attn.LayerNormLayer()
    x = np.random.RandomState(1).randn(2, 12, 32).astype("float32")
    _assert_grads(*_layer_grads(jl, pl, _params(jl, it), x))


def test_rope_gradient():
    x = np.random.RandomState(2).randn(2, 10, 3, 8).astype("float32")
    g = np.random.RandomState(3).randn(*x.shape).astype("float32")
    pos = np.arange(10)[None]
    jg = jax.grad(lambda xx: (jax_attn.rope(xx, jnp.asarray(pos)) * g).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (port_attn.rope(tx, torch.from_numpy(pos)) * torch.from_numpy(g)) \
        .sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **GRAD)


@pytest.mark.parametrize("impl,causal,masked", [
    ("dense", True, False), ("dense", False, True), ("flash", True, False),
    ("flash", True, True), ("flash", False, True)])
def test_multi_head_attention_gradients(impl, causal, masked):
    """T = 20 with block 8: the flash path pads to 24 inside."""
    kw = dict(n_out=32, n_heads=4, causal=causal, attention_impl=impl,
              block_size=8, has_bias=True)
    jl, pl = jax_attn.MultiHeadAttention(**kw), port_attn.MultiHeadAttention(**kw)
    it = JInputType.recurrent(32, 20)
    x = np.random.RandomState(4).randn(2, 20, 32).astype("float32")
    _assert_grads(*_layer_grads(jl, pl, _params(jl, it), x,
                                _mask(2, 20) if masked else None))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_transformer_block_gradients(impl):
    kw = dict(n_out=32, n_heads=4, mlp_ratio=2, attention_impl=impl,
              block_size=8)
    jl, pl = jax_attn.TransformerBlock(**kw), port_attn.TransformerBlock(**kw)
    it = JInputType.recurrent(32, 16)
    x = np.random.RandomState(6).randn(2, 16, 32).astype("float32")
    _assert_grads(*_layer_grads(jl, pl, _params(jl, it), x, _mask(2, 16)))


def test_embedding_sequence_gradients():
    jl = jax_attn.EmbeddingSequenceLayer(n_out=16, n_in=30)
    pl = port_attn.EmbeddingSequenceLayer(n_out=16, n_in=30)
    params = _params(jl, JInputType.recurrent(1, 9))
    ids = np.random.RandomState(7).randint(0, 30, (3, 9, 1))
    g = np.random.RandomState(8).randn(3, 9, 16).astype("float32")
    jg = jax.grad(lambda p: (jl.apply(p, {}, jnp.asarray(ids.astype(
        "float32")))[0] * g).sum())(jax.tree_util.tree_map(jnp.asarray,
                                                           params))
    tp = _torch_tree(params, grad=True)
    y, _ = pl.apply(tp, {}, torch.from_numpy(ids.astype("float32")),
                    train=True)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tp["W"].grad.numpy(), np.asarray(jg["W"]),
                               **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_layer_score_and_gradients(masked):
    jl = jax_rec.RnnOutputLayer(n_out=12, activation="softmax", loss="mcxent")
    pl = port_rec.RnnOutputLayer(n_out=12, activation="softmax", loss="mcxent")
    params = _params(jl, JInputType.recurrent(16, 7))
    rs = np.random.RandomState(9)
    x = rs.randn(3, 7, 16).astype("float32")
    y = np.eye(12, dtype="float32")[rs.randint(0, 12, (3, 7))]
    mask = _mask(3, 7) if masked else None

    def f(p, xx):
        return jl.score(p, xx, jnp.asarray(y),
                        mask=None if mask is None else jnp.asarray(mask))

    js = f(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = _torch_tree(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ps = pl.score(tp, tx, torch.from_numpy(y), train=True,
                  mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ps.item(), float(js), rtol=1e-5)
    grads = torch.autograd.grad(ps, [tp["W"], tp["b"], tx])
    _assert_grads(grads, [jgp["W"], jgp["b"], jgx])


def test_regularization_score_matches_jax():
    kw = dict(n_out=12, l1=0.01, l2=0.1)
    jl, pl = jax_rec.RnnOutputLayer(**kw), port_rec.RnnOutputLayer(**kw)
    params = _params(jl, JInputType.recurrent(16, 7))
    np.testing.assert_allclose(
        pl.regularization_score(_torch_tree(params)).item(),
        float(jl.regularization_score(
            jax.tree_util.tree_map(jnp.asarray, params))), rtol=1e-5)
    assert port_rec.RnnOutputLayer(n_out=3).regularization_score({}) == 0.0


# ------------------------------------------------------------ dropout
def test_input_and_residual_dropout_draw_from_the_generator():
    layer = port_attn.TransformerBlock(n_out=16, n_heads=2, residual_dropout=0.5)
    mha = port_attn.MultiHeadAttention(n_out=16, n_heads=2, dropout=0.5)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    for lyr in (layer, mha):
        p, _ = lyr.init(torch.Generator().manual_seed(1),
                        InputType.recurrent(16, 8))
        run = lambda seed: lyr.apply(
            p, {}, x, train=True,
            generator=torch.Generator().manual_seed(seed))[0]
        eval_y = lyr.apply(p, {}, x, train=False)[0]
        assert torch.equal(run(3), run(3))
        assert not torch.equal(run(3), run(4))
        assert not torch.allclose(run(3), eval_y)
        # no generator: no dropout, as the reference without a key
        assert torch.equal(lyr.apply(p, {}, x, train=True)[0], eval_y)


def test_dropout_objects_and_attention_dropout_raise_in_training():
    mha = port_attn.MultiHeadAttention(n_out=16, n_heads=2,
                                       attention_dropout=0.1)
    p, _ = mha.init(torch.Generator().manual_seed(0),
                    InputType.recurrent(16, 4))
    x = torch.randn(1, 4, 16, generator=torch.Generator().manual_seed(1))
    eval_y = mha.apply(p, {}, x)[0]                       # inference is fine
    # attention dropout trains now (the plain product, masks from the
    # generator); without a generator it draws nothing, as the reference
    # without a key
    assert torch.equal(mha.apply(p, {}, x, train=True)[0], eval_y)
    trained = mha.apply(p, {}, x, train=True,
                        generator=torch.Generator().manual_seed(0))[0]
    assert not torch.allclose(trained, eval_y)
    # dropout objects apply (nn/regularization.py); a dict is no dropout
    obj = port_attn.MultiHeadAttention(n_out=16, n_heads=2,
                                       dropout=GaussianDropout(rate=0.3))
    x1 = torch.ones(1, 4, 16)
    noisy = obj.apply(p, {}, x1, train=True,
                      generator=torch.Generator().manual_seed(0))[0]
    assert not torch.allclose(noisy, obj.apply(p, {}, x1)[0])
    bad = port_attn.MultiHeadAttention(n_out=16, n_heads=2,
                                       dropout={"@class": "GaussianDropout"})
    with pytest.raises(TypeError, match="IDropout"):
        bad.apply(p, {}, x, train=True, generator=torch.Generator())


# ------------------------------------------------------------ the slice
def _tokens(n, t, vocab, seed):
    rs = np.random.RandomState(seed)
    start = rs.randint(0, vocab, (n, 1))
    stride = rs.randint(1, 5, (n, 1))
    seq = (start + stride * np.arange(t + 1)) % vocab
    return (seq[:, :t, None].astype("float32"),
            np.eye(vocab, dtype="uint8")[seq[:, 1:]])


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    net = jax_model_by_name("TransformerLM", **LM).init()
    rs = np.random.RandomState(0)
    net.params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rs.randn(*a.shape).astype("float32"), net.params)
    path = str(tmp_path_factory.mktemp("slice") / "lm.zip")
    jax_save_model(net, path)
    return path


def _assert_params_close(port_net, jax_net, atol=1e-5):
    pl = tree_leaves(port_net.params)
    jl = jax.tree_util.tree_leaves(jax_net.params)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=atol, rtol=0)


def test_ten_fit_steps_match_jax(jax_zip):
    X, Y = _tokens(20, 24, 48, seed=1)
    jnet = jax_load_model(jax_zip)
    pnet = load_model(jax_zip, device="cpu")
    jc, pc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    pnet.set_listeners(pc, ScoreIterationListener(1), PerformanceListener(1))
    jnet.fit((X, Y.astype("float32")), epochs=2, batch_size=4,
             scan_steps=1, prefetch=False)
    pnet.fit((X, Y), epochs=2, batch_size=4)      # uint8 labels cast
    assert [i for i, _ in pc.scores] == list(range(10))
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-4)
    _assert_params_close(pnet, jnet)
    assert pnet.iteration_count == jnet.iteration_count == 10
    assert pnet.epoch_count == 2
    assert pnet.score() == pc.scores[-1][1]
    # score on a dataset runs the inference forward, as the reference's
    labels = Y[:4].astype("float32")
    np.testing.assert_allclose(pnet.score(DataSet(X[:4], labels)),
                               jnet.score(JDataSet(X[:4], labels)), rtol=1e-4)


def test_score_without_a_dataset_runs_no_forward(monkeypatch):
    net = model_by_name("TransformerLM", **LM).init(device="cpu")
    assert np.isnan(net.score())
    X, Y = _tokens(4, 24, 48, seed=2)
    net.fit((X, Y), batch_size=4)
    monkeypatch.setattr(net, "_forward", lambda *a, **k: 1 / 0)
    assert net.score() == net._score


def test_updater_state_moves_both_ways(jax_zip, tmp_path):
    """A port zip with updaterState.bin resumes in the JAX package and the
    next step agrees; and the reverse."""
    X, Y = _tokens(8, 24, 48, seed=3)
    Yf = Y.astype("float32")
    pnet = load_model(jax_zip, device="cpu")
    pnet.fit((X[:4], Y[:4]), batch_size=4)
    port_zip = str(tmp_path / "port.zip")
    save_model(pnet, port_zip)
    with zipfile.ZipFile(port_zip) as zf:
        assert "updaterState.bin" in zf.namelist()
    jnet = jax_load_model(port_zip)
    assert int(jnet.opt_state[1][0].count) == 1
    jnet.fit((X[4:], Yf[4:]), batch_size=4, scan_steps=1, prefetch=False)
    pnet.fit((X[4:], Y[4:]), batch_size=4)
    _assert_params_close(pnet, jnet)
    # the reverse: the JAX net's zip, two steps in, resumes in the port
    jax_zip2 = str(tmp_path / "jax.zip")
    jax_save_model(jnet, jax_zip2)
    back = load_model(jax_zip2, device="cpu")
    assert int(back.opt_state["1"]["0"]["count"]) == 2
    np.testing.assert_allclose(
        back.opt_state["1"]["0"]["nu"]["1"]["W1"].numpy(),
        np.asarray(jnet.opt_state[1][0].nu["1"]["W1"]), rtol=1e-6, atol=1e-9)
    back.fit((X[:4], Y[:4]), batch_size=4)
    jnet.fit((X[:4], Yf[:4]), batch_size=4, scan_steps=1, prefetch=False)
    _assert_params_close(back, jnet)
    # a model without its optimizer state starts a fresh one
    fresh = load_model(jax_zip2, device="cpu", load_updater=False)
    assert int(fresh.opt_state["1"]["0"]["count"]) == 0


def test_updater_state_with_wrong_keys_is_refused(jax_zip, tmp_path):
    from deeplearning4j_tpu_torch.util.serialization import (
        updater_state_from_bytes, updater_state_to_bytes,
    )
    net = load_model(jax_zip, device="cpu")
    data = updater_state_to_bytes({"0": {}, "1": {"0": {}}})
    with pytest.raises(ValueError, match="keys"):
        updater_state_from_bytes(data, net.optimizer_state_template())
    bad = net.optimizer_state_template()
    bad["1"]["0"]["mu"]["0"]["W"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        updater_state_from_bytes(updater_state_to_bytes(bad),
                                 net.optimizer_state_template())


def test_bf16_compute_keeps_f32_master_weights():
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-3))
            .dtype("float32").compute_dtype("bfloat16").list()
            .layer(port_attn.EmbeddingSequenceLayer(n_out=16, n_in=20))
            .layer(port_attn.TransformerBlock(n_out=16, n_heads=2,
                                              attention_impl="flash",
                                              block_size=8))
            .layer(port_rec.RnnOutputLayer(n_out=20))
            .set_input_type(InputType.recurrent(1, 8)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    X, Y = _tokens(4, 8, 20, seed=4)
    before = [t.clone() for t in tree_leaves(net.params)]
    net.fit((X, Y), batch_size=4)
    assert np.isfinite(net.score())
    assert all(t.dtype == torch.float32 for t in tree_leaves(net.params))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(net.params)))


@pytest.mark.parametrize("kw,match", [
    (dict(scan_steps=2), "scan_steps"), (dict(accumulate_steps=2), "accum"),
    (dict(plan=object()), "plan"), (dict(prefetch=True), "prefetch")])
def test_fit_options_not_yet_ported_raise(kw, match):
    net = model_by_name("TransformerLM", **LM).init(device="cpu")
    X, Y = _tokens(4, 24, 48, seed=5)
    if match == "plan":
        # sharding plans train now (tests/test_torch_plan.py): a
        # one-rank plan is bitwise the plain fit, and a plan must be a
        # ShardingPlan
        from deeplearning4j_tpu_torch.parallel import ShardingPlan
        with pytest.raises(TypeError, match="ShardingPlan"):
            net.fit((X, Y), batch_size=4, **kw)
        plain = model_by_name("TransformerLM", **LM).init(device="cpu")
        plain.fit((X, Y), batch_size=4)
        net.fit((X, Y), batch_size=4, plan=ShardingPlan(zero_stage=1))
        assert net.iteration_count == 1 and net.score() == plain.score()
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(net.params), tree_leaves(plain.params)))
    else:
        # scan, accumulation and prefetch train now
        # (tests/test_torch_fit_paths.py)
        net.fit((X, Y), batch_size=4, **kw)
        assert net.iteration_count == 1 and np.isfinite(net.score())
    # the plain per-call path's own values are accepted
    net.fit((X, Y), batch_size=4, scan_steps=1, prefetch=False)


@pytest.mark.parametrize("case", ["frozen", "layer_updater", "tbptt",
                                  "checkpointing", "weight_noise"])
def test_configs_not_yet_ported_raise_at_fit(case):
    emb = port_attn.EmbeddingSequenceLayer(n_out=8, n_in=10)
    head = port_rec.RnnOutputLayer(n_out=10)
    b = NeuralNetConfiguration.Builder().updater(Sgd(0.1))
    if case == "checkpointing":
        b = b.gradient_checkpointing(True)
    lb = b.list()
    if case == "frozen":
        emb = port_attn.EmbeddingSequenceLayer(n_out=8, n_in=10, frozen=True)
    elif case == "layer_updater":
        emb = port_attn.EmbeddingSequenceLayer(n_out=8, n_in=10,
                                               updater=Adam())
    elif case == "weight_noise":
        emb = port_attn.EmbeddingSequenceLayer(n_out=8, n_in=10,
                                               weight_noise={"p": 0.1})
    lb.layer(emb).layer(head).set_input_type(InputType.recurrent(1, 4))
    if case == "tbptt":
        lb.backprop_type("tbptt")
    net = MultiLayerNetwork(lb.build(), device="cpu").init()
    X, Y = _tokens(2, 4, 10, seed=6)
    # weight noise is ported (nn/regularization.py); a dict is no noise.
    # Frozen layers, per-layer updaters, checkpointing and tbptt train
    # now (tests/test_torch_fit_paths.py and tests/test_torch_tbptt.py
    # hold them to the reference); tbptt runs one step a chunk
    if case == "weight_noise":
        with pytest.raises(TypeError, match="IWeightNoise"):
            net.fit((X, Y), batch_size=2)
    else:
        before = net.params["0"]["W"].clone()
        net.fit((X, Y), batch_size=2)
        assert np.isfinite(net.score())
        assert torch.equal(net.params["0"]["W"], before) == (case == "frozen")
    net.output(X)                                # inference still works


def test_iris_iterator_matches_jax():
    port = [(d.features, d.labels) for d in IrisDataSetIterator(batch_size=50)]
    ref = [(d.features, d.labels) for d in JIris(batch_size=50)]
    assert len(port) == len(ref) == 3
    for (pf, pl), (rf, rl) in zip(port, ref):
        np.testing.assert_array_equal(pf, rf)
        np.testing.assert_array_equal(pl, rl)
    it = ArrayDataSetIterator(np.arange(10)[:, None], np.arange(10)[:, None],
                              batch_size=4)
    assert [len(d.features) for d in it] == [4, 4]       # drop_last


# ------------------------------------------------------------ the CLI
def _npz(path, n=16):
    X, Y = _tokens(n, 24, 48, seed=8)
    np.savez(path, features=X, labels=Y)
    return path


def test_cli_matches_the_jax_cli(jax_zip, tmp_path, capsys):
    data = _npz(str(tmp_path / "tokens.npz"))
    common = ["--model", jax_zip, "--dataset", data, "--mode", "single",
              "--epochs", "2", "--batch-size", "4", "--score-every", "1"]
    assert cli.main(common + ["--output", str(tmp_path / "p.zip"),
                              "--device", "cpu"]) == 0
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(common + ["--output", str(tmp_path / "j.zip")]) == 0
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port_line) == set(jax_line) == {"output", "final_score",
                                               "iterations", "epochs"}
    assert (port_line["iterations"], port_line["epochs"]) == (8, 2) \
        == (jax_line["iterations"], jax_line["epochs"])
    np.testing.assert_allclose(port_line["final_score"],
                               jax_line["final_score"], rtol=1e-4)
    _assert_params_close(load_model(str(tmp_path / "p.zip"), device="cpu"),
                         jax_load_model(str(tmp_path / "j.zip")))


def test_cli_trains_a_tbptt_zip_one_iteration_per_chunk(tmp_path, capsys):
    """A saved TextGenerationLSTM (120 steps, tbptt 50) through both CLIs:
    6 sequences in batches of 3 are 2 batches x 3 chunks = 6 iterations
    in the result line; the port's output zip reloads with its count and
    updaterState.bin, and its parameters match the reference CLI's."""
    from deeplearning4j_tpu.util.serialization import save_model as jsave
    src = jsave(jax_model_by_name("TextGenerationLSTM",
                                  total_unique_characters=12,
                                  max_length=120, units=8).init(),
                str(tmp_path / "charlstm.zip"))
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 12, (6, 121))
    eye = np.eye(12, dtype=np.uint8)
    data = str(tmp_path / "chars.npz")
    np.savez(data, features=eye[ids[:, :-1]].astype(np.float32),
             labels=eye[ids[:, 1:]])
    common = ["--model", src, "--dataset", data, "--mode", "single",
              "--batch-size", "3", "--score-every", "1"]
    out = str(tmp_path / "p.zip")
    assert cli.main(common + ["--output", out, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(common + ["--output", str(tmp_path / "j.zip")]) == 0
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["iterations"], line["epochs"]) == (6, 1) == (
        jline["iterations"], jline["epochs"])
    np.testing.assert_allclose(line["final_score"], jline["final_score"],
                               rtol=1e-4)
    net = load_model(out, device="cpu")
    assert net.iteration_count == 6 and net.conf.backprop_type == "tbptt"
    assert "updaterState.bin" in zipfile.ZipFile(out).namelist()
    assert int(net.opt_state["1"]["0"]["count"]) == 6     # Adam after clip
    _assert_params_close(net, jax_load_model(str(tmp_path / "j.zip")))


def test_cli_sync_mode_runs_the_plain_fit_on_one_worker(tmp_path, capsys):
    """--mode sync (the default) over one worker is the plain fit."""
    lm = model_by_name("TransformerLM", **LM).init(device="cpu")
    src = save_model(lm, str(tmp_path / "lm.zip"))
    data = _npz(str(tmp_path / "t.npz"), n=8)
    assert cli.main(["--model", src, "--dataset", data, "--output",
                     str(tmp_path / "o.zip"), "--device", "cpu",
                     "--batch-size", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iterations"] == 2 and np.isfinite(line["final_score"])


def test_cli_dataset_loader_iris_and_npz(tmp_path):
    """`--dataset iris` is the bundled set in the reference's order; an
    npz without its two arrays stops the run."""
    it = cli._load_data("iris", 50)
    for mine, ref in zip(it, JIris(batch_size=50)):
        np.testing.assert_array_equal(mine.features, ref.features)
    np.savez(str(tmp_path / "bad.npz"), x=np.zeros(3))
    with pytest.raises(SystemExit, match="features"):
        cli._load_data(str(tmp_path / "bad.npz"), 4)


@pytest.mark.parametrize("extra", [
    ["--checkpoint-dir", "ckpt"], ["--resume"],
    ["--serve-port", "0"], ["--mesh", "data=1"],
    ["--mode", "averaging"], ["--dataset", "mnist"]])
def test_cli_flags_of_parts_that_wait_raise(extra, tmp_path, monkeypatch,
                                            capsys):
    args = ["--model", "m.zip", "--dataset", "d.npz", "--output", "o.zip",
            "--device", "cpu"]
    if extra[0] == "--serve-port":
        # the serve handoff is ported: it serves the trained network
        _check_serve_handoff(tmp_path, extra)
        return
    if extra[0] in ("--checkpoint-dir", "--resume"):
        # resilient training is ported: a preempted run exits 3 with no
        # output zip, and --resume finishes bitwise the uninterrupted run
        _check_resilient_cli(tmp_path, extra[0], monkeypatch, capsys)
        return
    if extra[0] in ("--mesh", "--mode"):
        # data parallelism is ported: over the one-rank group the CLI
        # forms, `--mesh data=1` (sync) and `--mode averaging` train
        # bitwise as `--mode single` does; averaging refuses --mesh
        _check_parallel_cli(tmp_path, extra, capsys)
        return
    if extra[0] == "--dataset":
        # the MNIST fetcher is ported: without --synthetic-data a missing
        # cache stops the run, as in the reference
        monkeypatch.setenv("DL4J_CUDA_DATA_DIR", str(tmp_path))
        model = str(tmp_path / "m.zip")
        save_model(model_by_name("LeNet").init(device="cpu"), model)
        args = ["--model", model, "--output", str(tmp_path / "o.zip"),
                "--device", "cpu"]
        with pytest.raises(FileNotFoundError, match="MNIST not cached"):
            cli.main(args + extra)
        assert not (tmp_path / "o.zip").exists()
        return
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(args + extra)


def _check_parallel_cli(tmp_path, extra, capsys):
    model = save_model(model_by_name("TransformerLM", **LM).init(
        device="cpu"), str(tmp_path / "lm.zip"))
    data = _npz(str(tmp_path / "t.npz"))
    common = ["--model", model, "--dataset", data, "--device", "cpu",
              "--epochs", "2", "--batch-size", "4", "--score-every", "1"]
    plain, out = str(tmp_path / "plain.zip"), str(tmp_path / "o.zip")
    assert cli.main(common + ["--output", plain, "--mode", "single"]) == 0
    capsys.readouterr()
    assert cli.main(common + ["--output", out] + extra) == 0
    io = capsys.readouterr()
    line = json.loads(io.out.strip().splitlines()[-1])
    assert (line["iterations"], line["epochs"]) == (8, 2)
    record = json.loads(io.err.strip().splitlines()[-1])["parallel"]
    assert record["world"] == 1 and record["backend"] == "gloo"
    # sync: one all-reduce a step (gradients and loss in one buffer);
    # averaging (frequency 5): a loss mean a step for the listeners, the
    # average at step 5 and the final one
    assert record["syncs"] == (8 if extra[0] == "--mesh" else 10)
    a, b = load_model(plain, device="cpu"), load_model(out, device="cpu")
    assert torch.equal(a.params_flat(), b.params_flat())
    if extra[0] == "--mode":
        with pytest.raises(SystemExit, match="--mesh applies to"):
            cli.main(common + ["--output", out, "--mesh", "data=1"]
                     + extra)


def _check_resilient_cli(tmp_path, flag, monkeypatch, capsys):
    """A flash LM with residual dropout, 2 epochs of 4 steps: the plain
    single-mode run, then the resilient path. `--checkpoint-dir` under
    DL4J_CUDA_FAULTS=preempt_at=5 (mid-epoch) exits 3 with the
    reference's stderr record and no output zip, and an uninterrupted
    `--checkpoint-dir` run is bitwise the plain one; `--resume` alone is
    refused, and after the preemption it finishes bitwise the plain run
    (parameters, optimizer state, counters)."""
    import dataclasses
    import os
    conf = model_by_name("TransformerLM", **{**LM, "dropout": 0.1}).conf()
    conf = dataclasses.replace(conf, layers=[
        dataclasses.replace(l, attention_dropout=0.0)
        if hasattr(l, "attention_dropout") else l for l in conf.layers])
    model = save_model(MultiLayerNetwork(conf, device="cpu").init(),
                       str(tmp_path / "lm.zip"))
    data = _npz(str(tmp_path / "t.npz"))
    common = ["--model", model, "--dataset", data, "--device", "cpu",
              "--epochs", "2", "--batch-size", "4", "--score-every", "1"]
    plain = str(tmp_path / "plain.zip")
    assert cli.main(common + ["--output", plain, "--mode", "single"]) == 0
    out, ckpt = str(tmp_path / "o.zip"), str(tmp_path / "ckpt")
    resilient = common + ["--output", out, "--checkpoint-dir", ckpt,
                          "--save-every-iterations", "2"]
    if flag == "--resume":
        with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
            cli.main(common + ["--output", out, "--resume"])
    else:
        # without CUDA and without --device cpu it raises before training
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([a for a in resilient if a not in ("--device", "cpu")])
        assert not os.path.exists(ckpt)
    capsys.readouterr()
    monkeypatch.setenv("DL4J_CUDA_FAULTS", "preempt_at=5")
    assert cli.main(resilient) == 3
    record = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert record == {"preempted": True, "diverged": False, "iterations": 5,
                      "resume_with": "--resume"}
    assert not (tmp_path / "o.zip").exists()
    monkeypatch.delenv("DL4J_CUDA_FAULTS")
    if flag == "--checkpoint-dir":
        ckpt = str(tmp_path / "fresh")
        assert cli.main(resilient[:-4] + ["--checkpoint-dir", ckpt]) == 0
    else:
        assert cli.main(resilient + ["--resume"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["iterations"], line["epochs"]) == (8, 2)
    a, b = load_model(plain, device="cpu"), load_model(out, device="cpu")
    assert torch.equal(a.params_flat(), b.params_flat())
    assert (a.iteration_count, a.epoch_count) == (b.iteration_count,
                                                  b.epoch_count)
    with zipfile.ZipFile(plain) as za, zipfile.ZipFile(out) as zb:
        assert za.read("updaterState.bin") == zb.read("updaterState.bin")


def _check_serve_handoff(tmp_path, extra):
    """`--serve-port` in a subprocess: after the result line the trained
    network answers predict over HTTP with its own output(), and SIGTERM
    drains the server and ends the run with 0."""
    import os
    import signal
    import subprocess
    import sys
    import threading
    import urllib.request
    from pathlib import Path
    from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .list().layer(pff.DenseLayer(n_out=8, activation="relu"))
            .layer(pff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    model = save_model(MultiLayerNetwork(conf, device="cpu").init(),
                       str(tmp_path / "iris.zip"))
    out = str(tmp_path / "served.zip")
    repo = str(Path(__file__).resolve().parent.parent)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.train", "--model",
         model, "--dataset", "iris", "--output", out, "--mode", "single",
         "--device", "cpu", "--batch-size", "32", "--serve-buckets", "1,8",
         *extra], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    announced = threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if line.startswith('{"serving"'):
                announced.set()
    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        assert announced.wait(120), "".join(lines)
        info = json.loads(next(x for x in lines if x.startswith('{"serving"')))
        X = IrisDataSetIterator(batch_size=8).features[:8]
        req = urllib.request.Request(
            info["serving"] + info["predict"],
            data=json.dumps({"inputs": X.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = np.asarray(json.loads(r.read())["outputs"], "float32")
        want = load_model(out, device="cpu").output(X).numpy()
        np.testing.assert_allclose(answer, want, rtol=0, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(lines)
    result = json.loads(stdout.strip().splitlines()[-1])
    assert result["output"] == out and result["iterations"] == 4


def test_flash_layer_training_launches_no_kernel_on_the_cpu():
    net = model_by_name("TransformerLM", **LM).init(device="cpu")
    X, Y = _tokens(4, 24, 48, seed=9)
    before = dict(fa.KERNEL_LAUNCHES)
    net.fit((X, Y), batch_size=4)
    assert dict(fa.KERNEL_LAUNCHES) == before


def test_transformer_lm_conf_builds_the_reference_optimizer():
    from deeplearning4j_tpu_torch.nn.updaters import AdamW
    pc = model_by_name("TransformerLM").conf()
    jc = jax_model_by_name("TransformerLM").conf()
    assert pc.updater == AdamW(3e-4) and pc.grad_clip_norm == 1.0
    assert pc.grad_clip_value is None
    assert pc.to_dict()["updater"] == jc.to_dict()["updater"]
