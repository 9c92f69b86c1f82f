"""Tensor- and expert-parallel compute (`parallel/tensor.py` and the
split layers under a `ShardingPlan` with ``model > 1``) against the
reference's GSPMD fit under the same plan.

The same seeded reference network (a zip both sides load) trains under
the reference's plan over data x model of the conftest's 8 CPU devices,
and under the port's over a data x model gloo group of spawned ranks
(`tests/_torch_dist`), where each model rank is handed its pieces of the
rule-split kernels and computes with them: the Megatron MLP and a
ComputationGraph under `ShardingRules.megatron()` (ZeRO-1 and ZeRO-3
too), an LM and an MoE LM under `TransformerLM.sharding_rules()`, flash
(the plain versions on the CPU) and dense attention, masks included.
After 3 steps the port's parameters are within 1e-5 relative of the
reference's in f32 (1e-10 in f64), and every rank ends with the same
parameters (the replicated leaves, computed on each rank, bitwise). The
four collectives equal their whole-tensor emulation bitwise and pass the
port's gradient check in f64. `ParallelInference(plan=)`, the registry's
`deploy(plan=)` with its followers, `ResilientTrainer` under `use_mesh`,
`ParallelWrapper` adopting the plan and the train CLI's `--mesh` run the
same split compute.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_dist import (
    RankPool, assert_params_close, blobs, ref_flat, ref_graph, ref_mesh,
    ref_mlp, ref_plan, ref_source as ref_mlp_source, save_ref,
)
from test_torch_context import char_data, lm_conf, masks, ref_source, save
from deeplearning4j_tpu.util.serialization import load_model as jload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    return save_ref(ref_mlp(clip=1.0),
                    tmp_path_factory.mktemp("tp") / "mlp.zip")


@pytest.fixture
def jax_x64():
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _check(out, ref, f64=False):
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
        assert o["iterations"] == ref.iteration_count
    assert_params_close(out[0]["flat"], ref_flat(ref), f64=f64)


def _split_forward(out):
    """Every rank's forward read its pieces: no whole gather before the
    fit's end, and no warning of a gather at use."""
    for o in out:
        assert o["full_calls_in_fit"] == 0
        assert not any("ShardingPlan: model=" in m for m in o["warnings"])


# ------------------------------------------------------------ collectives
def test_collectives_equal_their_whole_tensor_emulation(pool):
    """f64 at 2 ranks: each function's forward and backward equal, bit for
    bit, what one process computes on the whole tensors."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 8)
    pieces = [rs.randn(3, 4) for _ in range(2)]
    g_whole = [rs.randn(3, 8) for _ in range(2)]
    g_pieces = [rs.randn(3, 4) for _ in range(2)]
    out = pool.run("tp_collectives", 2, x=x, pieces=pieces,
                   g_whole=g_whole, g_pieces=g_pieces)
    for r, o in enumerate(out):
        y, g = o["copy"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(g, g_whole[0] + g_whole[1])
        y, g = o["slice"]
        np.testing.assert_array_equal(y, x[:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(g, np.concatenate(g_pieces, -1))
        y, g = o["reduce"]
        np.testing.assert_array_equal(y, pieces[0] + pieces[1])
        np.testing.assert_array_equal(g, g_pieces[r])
        y, g = o["gather"]
        np.testing.assert_array_equal(y, np.concatenate(pieces, -1))
        np.testing.assert_array_equal(g, g_whole[r][:, 4 * r:4 * r + 4])


def test_collectives_pass_the_gradient_check(pool):
    """Central differences in f64 through a column-parallel, a
    row-parallel and a gathered column-parallel product."""
    rs = np.random.RandomState(1)
    out = pool.run("tp_gradcheck", 2, x=rs.randn(2, 4), w1=rs.randn(4, 6),
                   w2=rs.randn(6, 4), w3=rs.randn(4, 6), w=rs.randn(2, 6))
    for o in out:
        assert o["passed"], o
        assert o["checked"] > 0


# -------------------------------------------------------- Megatron MLP
MLP = [("dp1_tp2", dict(data=1, model=2), 2, {}),
       ("dp2_tp2", dict(data=2, model=2), 4, {}),
       ("dp2_tp2_accumulate", dict(data=2, model=2), 4,
        dict(accumulate_steps=2))]


@pytest.mark.parametrize("name,plan,world,kw", MLP, ids=[m[0] for m in MLP])
def test_megatron_mlp_computes_split_and_matches_the_reference(
        pool, mlp_zip, name, plan, world, kw):
    """Three steps of 32 (Adam with a global-norm clip): each rank's
    forward is handed the column pieces of both kernels."""
    X, Y = blobs()
    ref = jload(mlp_zip)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(plan["data"], plan["model"], True), **kw)
    out = pool.run("tp_fit", world, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                   plan=dict(plan, megatron=True), **kw)
    _check(out, ref)
    _split_forward(out)
    assert out[0]["forward"]["0/W"] == (8, 8)
    assert out[0]["forward"]["1/W"] == (16, 2)
    assert out[0]["forward"]["0/b"] == (16,)


def test_megatron_mlp_with_l1_l2_matches_the_reference(pool, tmp_path):
    """The l1/l2 penalty of the split kernels is summed over ``model``:
    the score and the step are the whole network's."""
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(5e-2))
            .l1(1e-3).l2(1e-2).list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    path = save_ref(conf, tmp_path / "m.zip")
    X, Y = blobs()
    ref = jload(path)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(1, 2, True))
    out = pool.run("tp_fit", 2, zip_path=path, X=X, Y=Y, batch=32,
                   plan=dict(data=1, model=2, megatron=True))
    _check(out, ref)
    _split_forward(out)
    np.testing.assert_allclose(out[0]["scores"][-1], ref.score(),
                               rtol=1e-5)


def test_megatron_mlp_f64_matches_the_reference(pool, tmp_path, jax_x64):
    path = save_ref(ref_mlp(clip=1.0, dtype="float64"), tmp_path / "m.zip")
    X, Y = blobs(dtype="float64")
    ref = jload(path)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(2, 2, True))
    out = pool.run("tp_fit", 4, zip_path=path, X=X, Y=Y, batch=32,
                   plan=dict(data=2, model=2, megatron=True))
    _check(out, ref, f64=True)
    _split_forward(out)


@pytest.mark.parametrize("zero", [1, 3])
def test_zero_with_megatron_matches_the_reference(pool, mlp_zip, zero):
    """ZeRO over ``data`` on top of the model split: at stage 3 the
    forward gathers each kernel over ``data`` alone."""
    X, Y = blobs()
    ref = jload(mlp_zip)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(2, 2, True, zero_stage=zero))
    out = pool.run("tp_fit", 4, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                   plan=dict(data=2, model=2, megatron=True,
                             zero_stage=zero))
    _check(out, ref)
    _split_forward(out)
    assert out[0]["forward"]["0/W"] == (8, 8)
    # the Adam moments of W's piece are split over data too
    assert (4, 8) in out[0]["opt"]


def test_megatron_graph_matches_the_reference(pool, tmp_path):
    path = save_ref(ref_graph(), tmp_path / "g.zip", graph=True)
    X, Y = blobs()
    ref = jload(path)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(2, 2, True))
    out = pool.run("tp_fit", 4, zip_path=path, X=X, Y=Y, batch=32,
                   plan=dict(data=2, model=2, megatron=True))
    _check(out, ref)
    _split_forward(out)
    assert out[0]["forward"]["d/W"] == (8, 8)


def test_megatron_on_a_recurrent_layer_gathers_it_at_use(pool, tmp_path):
    """An LSTM has no split compute: its rule-split kernel is gathered at
    use (the plan says so once, by path) while the head computes split;
    the step is the reference's."""
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-2))
            .list().layer(LSTM(n_out=8))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(3, 5)).build())
    path = save_ref(conf, tmp_path / "r.zip")
    rs = np.random.RandomState(2)
    X = rs.randn(24, 5, 3).astype("float32")
    Y = np.eye(4, dtype="float32")[rs.randint(0, 4, (24, 5))]
    ref = jload(path)
    ref.fit(ref_source(ref, X, Y, 8), epochs=1, plan=ref_plan(1, 2, True))
    out = pool.run("tp_fit", 2, zip_path=path, X=X, Y=Y, batch=8,
                   plan=dict(data=1, model=2, megatron=True))
    _check(out, ref)
    assert out[0]["forward"]["0/W"] == (3, 32)      # gathered whole
    assert out[0]["forward"]["1/W"] == (8, 2)       # the head's piece
    assert any("0/W" in m and "no split compute" in m
               for m in out[0]["warnings"])


# --------------------------------------------------------------- the LMs
def _lm_rules():
    from deeplearning4j_tpu.models import TransformerLM
    return TransformerLM.sharding_rules()


def _ref_lm_fit(path, X, Y, batch, data, model, fmask=None, lmask=None):
    from deeplearning4j_tpu.parallel import ShardingPlan as JPlan
    net = jload(path)
    net.fit(ref_source(net, X, Y, batch, fmask, lmask), epochs=1,
            plan=JPlan.for_mesh(ref_mesh(data, model), rules=_lm_rules()))
    return net


LM = [("flash", "flash", {}), ("dense", "dense", {}),
      ("flash_masked", "flash", dict(fmask=True, lmask=True)),
      ("dense_masked", "dense", dict(fmask=True))]


@pytest.mark.parametrize("name,impl,mk", LM, ids=[m[0] for m in LM])
def test_lm_rules_compute_split_and_match_the_reference(pool, tmp_path,
                                                        name, impl, mk):
    """A two-block LM at data=2,model=2: each rank runs 2 of the 4 heads,
    half the MLP and half the vocabulary's rows."""
    path = save(lm_conf(impl, n_layers=2), tmp_path / "lm.zip")
    X, Y = char_data(seed=7)
    kw = {}
    if mk.get("fmask"):
        kw["fmask"] = masks()
    if mk.get("lmask"):
        kw["lmask"] = masks()[::-1].copy()
    ref = _ref_lm_fit(path, X, Y, 4, 2, 2, **kw)
    out = pool.run("tp_fit", 4, zip_path=path, X=X, Y=Y, batch=4,
                   plan=dict(data=2, model=2, lm_rules=True), **kw)
    _check(out, ref)
    _split_forward(out)
    fwd = out[0]["forward"]
    assert fwd["0/W"] == (8, 32)                    # vocab rows
    assert fwd["1/attn/Wq"] == (32, 16) and fwd["1/attn/Wo"] == (16, 32)
    assert fwd["1/W1"] == (32, 64) and fwd["1/W2"] == (64, 32)
    assert fwd["4/W"] == (32, 16)                   # the head: whole


def test_lm_f64_matches_the_reference(pool, tmp_path, jax_x64):
    path = save(lm_conf("flash", dtype="float64"), tmp_path / "lm.zip")
    X, Y = char_data(seed=5, dtype="float64")
    fm = masks().astype("float64")
    ref = _ref_lm_fit(path, X, Y, 4, 2, 2, fmask=fm)
    out = pool.run("tp_fit", 4, zip_path=path, X=X, Y=Y, batch=4,
                   plan=dict(data=2, model=2, lm_rules=True), fmask=fm)
    _check(out, ref, f64=True)


def test_lm_ledger_flops_per_rank_equal_the_local_count(pool, tmp_path):
    """The program ledger counts each rank's step from the local shapes:
    the four split GEMMs of each block and the flash work halve, the
    head's GEMM stays whole."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    path = save(lm_conf("flash", n_layers=2), tmp_path / "lm.zip")
    X, Y = char_data(seed=3)
    e, v, t, h, layers, m, b = 32, 16, 16, 4, 2, 2, 2
    out = pool.run("tp_fit", 4, zip_path=path, X=X, Y=Y, batch=4,
                   plan=dict(data=2, model=2, lm_rules=True), ledger=True)
    gemm = 6 * (12 * e * e * layers // m + e * v) * b * t
    flash = 18 * (e // h) * fa.live_pairs(t, t, True) * b * (h // m) \
        * layers
    for o in out:
        assert o["flops"] == gemm + flash


def test_moe_lm_expert_parallel_matches_the_reference(pool, tmp_path):
    """TransformerLMMoE with 4 experts at model=2: each rank scores every
    expert's gate and runs its 2 experts."""
    from deeplearning4j_tpu.models import TransformerLMMoE
    from deeplearning4j_tpu.nn.updaters import Nesterovs
    conf = TransformerLMMoE(vocab_size=16, seq_length=16, n_layers=2,
                            n_embd=32, n_heads=4, n_experts=4,
                            seed=3).conf()
    conf = dataclasses.replace(conf, updater=Nesterovs(learning_rate=0.05,
                                                       momentum=0.9))
    path = save(conf, tmp_path / "moe.zip")
    X, Y = char_data(seed=13)
    ref = _ref_lm_fit(path, X, Y, 4, 1, 2)
    out = pool.run("tp_fit", 2, zip_path=path, X=X, Y=Y, batch=4,
                   plan=dict(data=1, model=2, lm_rules=True))
    _check(out, ref)
    _split_forward(out)
    fwd = out[0]["forward"]
    assert fwd["3/W1"] == (2, 32, 128) and fwd["3/b1"] == (4, 128)


def test_transformer_checks_the_model_degree(pool):
    """Engaging `TransformerLM.sharding_rules()` at model=2 refuses what
    the degree does not divide: the heads (the attention layers' check),
    the vocabulary and the experts (a rule-split dimension)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadAttention, TransformerBlock,
    )
    small = dict(vocab_size=32, seq_length=8, n_layers=2, n_embd=32,
                 n_heads=4)
    out = pool.run("tp_engage_errors", 2, plan=dict(data=1, model=2,
                                                    lm_rules=True),
                   models=[("TransformerLM", small),
                           ("TransformerLM", dict(small, n_heads=3,
                                                  n_embd=48)),
                           ("TransformerLM", dict(small, vocab_size=31)),
                           ("TransformerLMMoE", dict(small, n_experts=3)),
                           ("TransformerLM", dict(small, n_experts=3))])
    for errors in out:
        assert errors[0] is None and errors[4] is None
        assert "n_heads 3 not divisible by the model degree 2" in errors[1]
        assert "dimension 0 should be divisible by the 'model' degree 2, " \
            "but it is equal to 31" in errors[2]
        assert "dimension 0 should be divisible by the 'model' degree 2, " \
            "but it is equal to 3" in errors[3]
    for layer in (MultiHeadAttention(n_out=32, n_heads=4),
                  TransformerBlock(n_out=32, n_heads=4)):
        with pytest.raises(ValueError, match="n_heads 4 not divisible"):
            layer.check_model_degree(3)


# ----------------------------------------------------------------- serving
def test_parallel_inference_serves_tp_sharded_servable(pool, tmp_path):
    """The reference's case (`tests/test_plan.py`), against the port over
    data=2,model=2 ranks: the kernels stay split, every rank's answer is
    the one-device forward within rtol 1e-5 / atol 1e-6, for a batch the
    data degree divides and one it does not; a swap under the plan
    answers the same."""
    from deeplearning4j_tpu_torch.util.serialization import load_model
    path = save_ref(ref_mlp(), tmp_path / "m.zip")
    X, _ = blobs(n=256)
    one = load_model(path, device="cpu")
    want = [one.output(X[:n]).numpy() for n in (64, 5)]
    out = pool.run("tp_infer", 4, zip_path=path, X=X,
                   plan=dict(data=2, model=2, megatron=True),
                   batches=(64, 5))
    for o in out:
        assert o["stored"]["0/W"] == (8, 8)
        assert o["warmed"] == [(2, 4)]
        for got, ref in zip(o["outs"] + o["outs2"], want + want):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_deploy_plan_leads_and_follows(pool, tmp_path):
    """An LM servable at model=2 through `deploy(plan=)`: rank 0 answers
    through its batcher what one process answers, the follower replays
    every forward (the warm-up's included), a swap reaches it, and the
    leader's shutdown ends its loop."""
    from deeplearning4j_tpu_torch.util.serialization import load_model
    path = save(lm_conf("flash", n_layers=2), tmp_path / "lm.zip")
    other = save(lm_conf("flash", seed=8, n_layers=2), tmp_path / "lm2.zip")
    X, _ = char_data(seed=3, b=4)
    want = {p: [load_model(p, device="cpu").output(X[:n]).numpy()
                for n in (1, 3)] for p in (path, other)}
    out = pool.run("tp_deploy", 2, source=path, X=X,
                   plan=dict(data=1, model=2, lm_rules=True), swap_to=other)
    lead, follower = out
    assert lead["role"] == "leader"
    for got, ref in zip(lead["outs"], want[path]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for got, ref in zip(lead["outs_swapped"], want[other]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert follower["status"] == "following"
    assert follower["version"] == 2
    # two buckets warmed twice (deploy and swap), four predicts
    assert follower["runs"] == 8


def test_deploy_plan_rejected_swap_keeps_serving(pool, tmp_path):
    """A swap that fails on any rank is rejected on every rank, which go
    on serving the live version with the same versions: a missing source
    and one of another input shape (the leader's own load and check: the
    followers are not told), a source only the follower cannot load (the
    ranks' vote), a rollback with nothing to roll back to, and a warm-up
    that fails on the leader (its abort drops the followers' candidate).
    A good swap then goes live on both."""
    from deeplearning4j_tpu_torch.util.serialization import load_model
    path = save(lm_conf("flash", n_layers=2), tmp_path / "lm.zip")
    other = save(lm_conf("flash", seed=8, n_layers=2), tmp_path / "lm2.zip")
    copy = save(lm_conf("flash", seed=9, n_layers=2), tmp_path / "lm3.zip")
    mlp = save_ref(ref_mlp(), tmp_path / "mlp.zip")
    X, _ = char_data(seed=3, b=4)
    want = {p: load_model(p, device="cpu").output(X[:3]).numpy()
            for p in (path, other)}
    out = pool.run("tp_deploy_rejects", 2, source=path, X=X,
                   plan=dict(data=1, model=2, lm_rules=True),
                   missing=str(tmp_path / "absent.zip"),
                   wrong_shape=str(mlp), follower_fails=str(copy),
                   good=str(other))
    lead, follower = out
    errors = lead["errors"]
    assert errors[0].startswith("ModelLoadError") and "not found" in errors[0]
    assert errors[1].startswith("ModelLoadError") and "expects input" \
        in errors[1]
    assert errors[2].startswith("ModelLoadError") and "another rank" \
        in errors[2]
    assert errors[3].startswith("ModelLoadError") and "roll back" \
        in errors[3]
    assert errors[4] == "RuntimeError: warm-up failed"
    assert errors[5] is None
    for got in lead["outs"][:5]:
        np.testing.assert_allclose(got, want[path], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lead["outs"][5], want[other], rtol=1e-5,
                               atol=1e-6)
    assert lead["versions"] == follower["versions"] == ([1, 2], 2)
    # deploy's two buckets, six predicts, the good swap's two buckets
    assert follower["runs"] == 10


# ----------------------------------------------- the fit's entry points
def test_resilient_trainer_under_megatron_preempts_and_resumes(pool,
                                                               tmp_path,
                                                               mlp_zip):
    X, Y = blobs()
    ref = jload(mlp_zip)
    ref.fit(ref_mlp_source(ref, X, Y, 16), epochs=2,
            plan=ref_plan(1, 2, True))
    plan = dict(data=1, model=2, megatron=True)
    ckpt = str(tmp_path / "ckpt")
    first = pool.run("tp_resilient", 2, zip_path=mlp_zip, X=X, Y=Y,
                     batch=16, ckpt_dir=ckpt, epochs=2, plan=plan,
                     preempt_at=7)
    assert all(o["preempted"] for o in first)
    out = pool.run("tp_resilient", 2, zip_path=mlp_zip, X=X, Y=Y,
                   batch=16, ckpt_dir=ckpt, epochs=2, plan=plan)
    assert out[0]["resumed_from"] is not None
    _check(out, ref)


def test_wrapper_adopting_a_model_plan_computes_split(pool, mlp_zip):
    """ParallelWrapper built under use_mesh(data=2, model=2, megatron,
    zero=1) adopts the plan (the reference's `tests/test_plan.py` case)
    and its fit computes split."""
    X, Y = blobs()
    ref = jload(mlp_zip)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(2, 2, True, zero_stage=1))
    out = pool.run("tp_fit", 4, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                   plan=dict(data=2, model=2, megatron=True, zero_stage=1),
                   use_mesh=True, wrapper=True)
    _check(out, ref)
    _split_forward(out)
    assert out[0]["wrapper"] == {"model": 2, "zero_stage": 1}


def test_train_cli_mesh_model2_trains_split(tmp_path):
    """Two train-CLI processes with ``--mesh data=1,model=2,
    rules=megatron``: the result is the reference's fit under that plan,
    and nothing is gathered at use."""
    from _torch_dist import _free_port
    from deeplearning4j_tpu_torch.util.serialization import load_model
    model = save_ref(ref_mlp(), tmp_path / "m.zip")
    X, Y = blobs(n=96)
    data = str(tmp_path / "d.npz")
    np.savez(data, features=X, labels=Y)
    out = str(tmp_path / "o.zip")
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("COORDINATOR_ADDRESS", "MASTER_ADDR",
                            "WORLD_SIZE", "RANK", "PROCESS_ID",
                            "NUM_PROCESSES", "MASTER_PORT")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.train",
             "--model", model, "--dataset", data, "--output", out,
             "--device", "cpu", "--batch-size", "32", "--epochs", "1",
             "--mesh", "data=1,model=2,rules=megatron"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        try:
            _, e = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, e[-3000:]
        errs.append(e)
    record = json.loads([ln for ln in errs[0].splitlines()
                         if ln.startswith('{"parallel"')][-1])["parallel"]
    assert record["plan"]["model"] == 2
    assert not any("no split compute" in e for e in errs)
    ref = jload(model)
    ref.fit(ref_mlp_source(ref, X, Y, 32), epochs=1,
            plan=ref_plan(1, 2, True))
    assert_params_close(load_model(out, device="cpu").params_flat().numpy(),
                        ref_flat(ref))
