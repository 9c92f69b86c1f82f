"""The port's sharding plan (`parallel/plan.py`) against the reference's.

The same seeded reference network (a zip both sides load) trains under
the reference's `ShardingPlan` over N x M of the conftest's 8 CPU devices
and under the port's over an N x M-rank gloo group (`tests/_torch_dist`):
data parallelism at N = 2 and 4, ZeRO-1 and ZeRO-3 at N = 2, and
`data=2,model=2,rules=megatron`, on the per-call, scan and accumulate
paths, a ComputationGraph, a ragged final batch and `use_mesh`. After 3
steps (f32) the port's parameters are within 1e-5 relative of the
reference's (1e-10 in f64); every rank ends with the same parameters.
The plan object itself (`parse_plan`, validation, `describe`) raises and
prints what the reference does.
"""
import numpy as np
import pytest

import jax

from _torch_dist import (
    RankPool, assert_params_close, blobs, ref_flat, ref_graph, ref_mlp,
    ref_plan, ref_source, save_ref,
)
from deeplearning4j_tpu.parallel import (
    ShardingPlan as JPlan, ShardingRules as JRules, parse_plan as jparse,
)
from deeplearning4j_tpu.util.serialization import load_model as jload
from deeplearning4j_tpu_torch.parallel import (
    ShardingPlan, ShardingRules, active_plan, parse_plan, use_mesh,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshConfig


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    return save_ref(ref_mlp(clip=1.0),
                    tmp_path_factory.mktemp("plan") / "mlp.zip")


def _ref_fit(path, plan, X, Y, batch=32, **kw):
    net = jload(path)
    net.fit(ref_source(net, X, Y, batch), epochs=1, plan=plan, **kw)
    return net


def _check_ranks(out, ref, f64=False):
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
    assert_params_close(out[0]["flat"], ref_flat(ref), f64=f64)
    assert out[0]["iterations"] == ref.iteration_count


GRID = [("dp2", dict(data=2), 2), ("dp4", dict(data=4), 4),
        ("zero1", dict(data=2, zero_stage=1), 2),
        ("zero3", dict(data=2, zero_stage=3), 2),
        ("dp2_tp2", dict(data=2, model=2, megatron=True), 4)]


@pytest.mark.parametrize("name,plan,world", GRID, ids=[g[0] for g in GRID])
def test_plan_parity_per_call(pool, mlp_zip, name, plan, world):
    """Three per-call steps of 32 (a global-norm clip inside Adam) under
    each grid point: the port's ranks equal, and within 1e-5 of the
    reference's plan-sharded fit."""
    X, Y = blobs()
    ref = _ref_fit(mlp_zip, ref_plan(plan.get("data"), plan.get("model", 1),
                                     plan.get("megatron", False),
                                     plan.get("zero_stage", 0)), X, Y)
    out = pool.run("fit_plan", world, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                   plan=plan)
    _check_ranks(out, ref)


@pytest.mark.parametrize("kw", [dict(scan_steps=2),
                                dict(accumulate_steps=2)],
                         ids=["scan", "accumulate"])
def test_plan_parity_scan_and_accumulate(pool, mlp_zip, kw):
    """The scan-of-K and accumulation paths run the plan's step too
    (ZeRO-1 under accumulation, as the reference's test)."""
    X, Y = blobs(n=128)
    plan = dict(data=2, zero_stage=1 if "accumulate_steps" in kw else 0)
    ref = _ref_fit(mlp_zip, ref_plan(2, zero_stage=plan["zero_stage"]), X,
                   Y, **kw)
    out = pool.run("fit_plan", 2, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                   plan=plan, **kw)
    _check_ranks(out, ref)


def test_plan_parity_graph_and_use_mesh(pool, tmp_path):
    """A ComputationGraph under `use_mesh(ShardingPlan(data=2,
    zero_stage=3))`: the reference's plan-sharded fit's parameters."""
    path = save_ref(ref_graph(), tmp_path / "g.zip", graph=True)
    X, Y = blobs()
    ref = _ref_fit(path, ref_plan(2, zero_stage=3), X, Y)
    out = pool.run("fit_plan", 2, zip_path=path, X=X, Y=Y, batch=32,
                   plan=dict(data=2, zero_stage=3), use_mesh=True)
    _check_ranks(out, ref)


def test_plan_parity_ragged_batch_and_f64(pool, tmp_path):
    """In f64 (JAX x64), 102 rows in batches of 32 over 4 ranks: the
    6-row tail does not divide, so it runs whole on every rank as the
    reference stages it unsharded; 1e-10 of the reference's."""
    jax.config.update("jax_enable_x64", True)
    try:
        path = save_ref(ref_mlp(dtype="float64"), tmp_path / "m64.zip")
        X, Y = (a[:102] for a in blobs(n=104, dtype="float64"))
        from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator
        ref = jload(path)
        ref.fit(ArrayDataSetIterator(X, Y, batch_size=32, drop_last=False),
                plan=ref_plan(4))
        out = pool.run("fit_plan", 4, zip_path=path, X=X, Y=Y, batch=32,
                       plan=dict(data=4), drop_last=False)
        _check_ranks(out, ref, f64=True)
        assert out[0]["iterations"] == 4
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("zero_stage", [0, 1], ids=["dp2", "zero1"])
def test_ragged_batch_with_dropout_keeps_ranks_equal(pool, tmp_path,
                                                     zero_stage):
    """A dropout net over 2 ranks, 71 rows in batches of 32: each rank
    draws its own masks, and on the 7-row tail, which runs whole on both,
    the ranks' gradients are meaned, so they still apply one update and
    end bitwise equal (with and without ZeRO-1's pieces)."""
    path = save_ref(ref_mlp(dropout=0.5), tmp_path / "drop.zip")
    X, Y = (a[:71] for a in blobs())
    out = pool.run("fit_plan", 2, zip_path=path, X=X, Y=Y, batch=32,
                   plan=dict(data=2, zero_stage=zero_stage), epochs=2,
                   drop_last=False)
    assert out[0]["iterations"] == 6
    np.testing.assert_array_equal(out[0]["flat"], out[1]["flat"])
    assert out[0]["scores"] == out[1]["scores"]


LARS_GRID = [("zero1", dict(data=2, zero_stage=1), 2),
             ("zero3", dict(data=2, zero_stage=3), 2),
             ("dp2_tp2", dict(data=2, model=2, megatron=True), 4)]


@pytest.mark.parametrize("name,plan,world", LARS_GRID,
                         ids=[g[0] for g in LARS_GRID])
def test_lars_under_a_sharded_optimizer_state(pool, tmp_path, name, plan,
                                              world):
    """Lars (weight decay, momentum, a global-norm clip before it) with its
    optimizer state in pieces: each leaf's trust ratio measures the whole
    leaf's parameter and update norms (the pieces' squares in one
    all-reduce), within 1e-5 of the reference's plan after 3 steps."""
    from deeplearning4j_tpu.nn.updaters import Lars
    path = save_ref(ref_mlp(clip=1.0, updater=Lars(
        learning_rate=0.5, momentum=0.9, weight_decay=1e-4)),
        tmp_path / "lars.zip")
    X, Y = blobs()
    ref = _ref_fit(path, ref_plan(plan.get("data"), plan.get("model", 1),
                                  plan.get("megatron", False),
                                  plan.get("zero_stage", 0)), X, Y)
    out = pool.run("fit_plan", world, zip_path=path, X=X, Y=Y, batch=32,
                   plan=plan)
    _check_ranks(out, ref)
    # the run moved the parameters (the trust ratio is not the identity)
    assert not np.allclose(out[0]["flat"], ref_flat(jload(path)))


def test_zero_and_megatron_placement_and_whole_after(pool, mlp_zip):
    """During a fit each rank stores its pieces: ZeRO-3 halves the kernel
    and the Adam moments along dim 0, Megatron splits W's output dim over
    `model`; after the fit the network holds whole tensors. A plan with
    `model > 1` warns that it splits storage, not compute; ZeRO-3 over
    `data` alone does not."""
    X, Y = blobs()
    z3 = pool.run("placement", 2, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                  plan=dict(data=2, zero_stage=3))
    assert z3[0]["params"]["0"] == {"W": (4, 16), "b": (8,)}
    assert (4, 16) in z3[0]["opt"] and (8, 16) not in z3[0]["opt"]
    assert z3[0]["after"]["0"] == {"W": (8, 16), "b": (16,)}
    assert (8, 16) in z3[0]["opt_after"] and (4, 16) not in z3[0]["opt_after"]
    tp = pool.run("placement", 4, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                  plan=dict(data=2, model=2, megatron=True))
    assert tp[0]["params"]["0"]["W"] == (8, 8)
    assert tp[0]["params"]["1"]["W"] == (16, 2)
    assert tp[3]["after"]["1"]["W"] == (16, 4)
    assert not any("storage" in m for m in z3[0]["warnings"])
    assert any("model=2 splits the parameters' storage only" in m
               for m in tp[0]["warnings"])


# ------------------------------------------------------------- plan object
def test_parse_plan_and_validation_raise_the_references_errors():
    for spec in ("bogus=1", "rules=unknown", "data", "zero=2"):
        with pytest.raises(ValueError) as theirs:
            jparse(spec)
        with pytest.raises(ValueError) as ours:
            parse_plan(spec)
        assert str(ours.value) == str(theirs.value)
    p = parse_plan("data=4,model=2,rules=megatron,zero=3")
    q = jparse("data=4,model=2,rules=megatron,zero=3")
    assert (p.data, p.model, p.zero_stage) == (q.data, q.model, q.zero_stage)
    assert [(pat, str(s)) for pat, s in p.rules.rules] == \
        [(pat, str(s)) for pat, s in q.rules.rules]
    assert ShardingPlan(data=8) == ShardingPlan(data=8)
    assert ShardingPlan(data=8) != ShardingPlan(data=8, zero_stage=1)
    # one rank, no process group: the degree-1 plan describes itself as
    # the reference's over one device does
    assert ShardingPlan().describe() == JPlan.for_mesh(
        __import__("_torch_dist").ref_mesh(1)).describe()
    assert ShardingPlan(rules=ShardingRules.megatron()).describe() == \
        JPlan.for_mesh(__import__("_torch_dist").ref_mesh(1),
                       rules=JRules.megatron()).describe()
    with pytest.raises(TypeError):
        with use_mesh(object()):
            pass
    with use_mesh(ShardingPlan(zero_stage=1)) as p1:
        assert active_plan() is p1
    assert active_plan() is None


@pytest.mark.parametrize("config,n", [
    (dict(data=3), 8), (dict(model=3), 8), (dict(data=2, model=2), 8),
    (dict(data=-1, model=2, seq=2), 6), (dict(data=2, stage=2), 6)])
def test_mesh_config_resolve_raises_the_references_errors(config, n):
    from deeplearning4j_tpu.parallel import MeshConfig as JMeshConfig
    with pytest.raises(ValueError) as theirs:
        JMeshConfig(**config).resolve(n)
    with pytest.raises(ValueError) as ours:
        MeshConfig(**config).resolve(n)
    assert str(ours.value) == str(theirs.value)
    assert MeshConfig(data=-1, model=2).resolve(8) == \
        JMeshConfig(data=-1, model=2).resolve(8)


def test_lm_sharding_rules_are_the_references_and_train(pool, tmp_path):
    """`TransformerLM.sharding_rules()` is the reference's table; a small
    LM (dense attention) under data=2 x model=2 with it, 2 steps, lands
    within 1e-5 of the reference's fit under the same rules."""
    from deeplearning4j_tpu.models.transformer import (
        TransformerLM as JLM,
    )
    from deeplearning4j_tpu.parallel import ShardingPlan as JP
    from deeplearning4j_tpu.util.serialization import save_model
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    ours = TransformerLM.sharding_rules().rules
    theirs = JLM.sharding_rules().rules
    assert [(p, str(s)) for p, s in ours] == [(p, str(s))
                                              for p, s in theirs]
    kw = dict(vocab_size=16, seq_length=8, n_layers=1, n_embd=16,
              n_heads=2, mlp_ratio=2, seed=3)
    path = str(tmp_path / "lm.zip")
    save_model(JLM(**kw).init(), path)
    rs = np.random.RandomState(0)
    t = rs.randint(0, 16, (8, 9))
    X = t[:, :8, None].astype("float32")
    Y = np.eye(16, dtype="float32")[t[:, 1:]]
    ref = jload(path)
    from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator
    ref.fit(ArrayDataSetIterator(X, Y, batch_size=4),
            plan=JP.for_mesh(__import__("_torch_dist").ref_mesh(2, 2),
                             rules=JLM.sharding_rules()))
    out = pool.run("fit_plan", 4, zip_path=path, X=X, Y=Y, batch=4,
                   plan=dict(data=2, model=2, lm_rules=True))
    _check_ranks(out, ref)


def test_resume_onto_another_zero_stage_is_loud_and_correct(pool, mlp_zip,
                                                            tmp_path):
    """ResilientTrainer under use_mesh: a run preempted under ZeRO-1 banks
    the plan in its checkpoint (the reference's describe()), resumes
    under ZeRO-3 with a warning naming both plans, and ends within 1e-5
    of the reference's uninterrupted single-device fit; the network holds
    whole tensors after it."""
    X, Y = blobs()
    kw = dict(zip_path=mlp_zip, X=X, Y=Y, batch=32, epochs=2,
              ckpt_dir=str(tmp_path / "ck"))
    cut = pool.run("resilient_plan", 2, zero_stage=1, preempt_at=4, **kw)
    assert all(c["preempted"] for c in cut)
    assert cut[0]["banked_plan"] == {"data": 2, "model": 1,
                                     "zero_stage": 1, "rules": None}
    done = pool.run("resilient_plan", 2, zero_stage=3, **kw)
    assert all(d["resumed_from"] is not None for d in done)
    assert all(any("different sharding plan" in m for m in d["warnings"])
               for d in done)
    assert done[0]["banked_plan"]["zero_stage"] == 3
    np.testing.assert_array_equal(done[0]["flat"], done[1]["flat"])
    assert (8, 16) in done[0]["opt_shapes"]
    ref = jload(mlp_zip)
    from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator
    ref.fit(ArrayDataSetIterator(X, Y, batch_size=32), epochs=2)
    assert_params_close(done[0]["flat"], ref_flat(ref))
    assert done[0]["iterations"] == ref.iteration_count == 6
