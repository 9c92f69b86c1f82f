"""Pipeline parallelism (`parallel/pipeline.py`) against the reference's.

The same seeded reference TransformerLM (a zip both sides load) trains
with the reference's `PipelineParallelTrainer` over data x stage of the
conftest's 8 CPU devices and with the port's over a data x stage gloo
group of spawned ranks (`tests/_torch_dist`), for 3 steps of a GPipe
schedule (M microbatches, M + S - 1 ticks, the activations and their
masks shifted stage to stage, autograd's own backward pipeline): two and
four stages, with a data axis, dense and flash blocks, with and without
feature and label masks. Every rank ends with the same whole
parameters, within 1e-5 relative of the reference's in f32 (1e-10 in
f64). The constructor refuses what the reference refuses.
"""
import dataclasses

import numpy as np
import pytest

from _torch_dist import RankPool, assert_params_close, ref_flat
from deeplearning4j_tpu.util.serialization import load_model as jload
from test_torch_context import char_data, lm_conf, ref_mesh, ref_source, save


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture
def jax_x64():
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def ref_pp_fit(path, X, Y, batch, data, stage, m, fmask=None, lmask=None):
    from deeplearning4j_tpu.parallel import PipelineParallelTrainer
    net = jload(path)
    PipelineParallelTrainer(net, ref_mesh(data, stage=stage),
                            n_microbatches=m).fit(
        ref_source(net, X, Y, batch, fmask, lmask), epochs=1,
        batch_size=batch)
    return net


def check(out, ref, f64=False, steps=3):
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
        assert o["iterations"] == steps
    assert_params_close(out[0]["flat"], ref_flat(ref), f64=f64)
    # the reference's pipeline casts its loss to f32 (`loss.astype(
    # jnp.float32)`) in f64 too: its score carries f32's rounding
    np.testing.assert_allclose(out[0]["scores"][-1], ref.score(),
                               rtol=2.0 ** -23 if f64 else 1e-5)


GRID = [("stage2", 1, 2, 4, 2), ("stage4", 1, 4, 4, 4),
        ("dp2_stage2", 2, 2, 2, 2)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name,data,stage,layers,m", GRID,
                         ids=[g[0] for g in GRID])
def test_pipeline_parallel_matches_the_reference(pool, tmp_path, name, data,
                                                 stage, layers, m, impl):
    """Three steps over each mesh: each stage holds its blocks, the
    parameters end whole and equal on every rank."""
    path = save(lm_conf(impl, seed=6, n_layers=layers), tmp_path / "lm.zip")
    X, Y = char_data(b=24, seed=13)
    ref = ref_pp_fit(path, X, Y, 8, data, stage, m)
    out = pool.run("pipeline_fit", data * stage, zip_path=path, X=X, Y=Y,
                   batch=8, data=data, stage=stage, n_microbatches=m)
    check(out, ref)
    per = layers // stage
    assert [o["blocks"] for o in out] == [
        list(range(1 + per * (r % stage), 1 + per * (r % stage + 1)))
        for r in range(data * stage)]
    assert set(out[0]["routes"]) == {"gloo"}


MASKS = [("lmask", False, True, 2, 2), ("fmask", True, False, 1, 2),
         ("both", True, True, 1, 4)]


@pytest.mark.parametrize("name,fm,lm,data,stage", MASKS,
                         ids=[m[0] for m in MASKS])
def test_pipeline_parallel_masked_matches_the_reference(pool, tmp_path,
                                                        name, fm, lm, data,
                                                        stage):
    """Masks travel with their microbatch; bubble ticks carry all-ones
    masks, so fully masked rows poison no gradient."""
    path = save(lm_conf("flash", seed=8, n_layers=4), tmp_path / "lm.zip")
    X, Y = char_data(b=24, seed=21)
    fmask = np.ones((24, 16), np.float32)
    fmask[:, 11:] = 0.0
    fmask[::5, :] = 0.0
    lmask = np.ones((24, 16), np.float32)
    lmask[:, 10:] = 0.0
    kw = dict(fmask=fmask if fm else None, lmask=lmask if lm else None)
    ref = ref_pp_fit(path, X, Y, 8, data, stage, 2, **kw)
    out = pool.run("pipeline_fit", data * stage, zip_path=path, X=X, Y=Y,
                   batch=8, data=data, stage=stage, n_microbatches=2, **kw)
    check(out, ref)


def test_pipeline_parallel_f64_matches_the_reference(pool, tmp_path,
                                                     jax_x64):
    """f64 with the zoo's AdamW and clip: within 1e-10."""
    path = save(lm_conf("flash", seed=4, n_layers=2, dtype="float64"),
                tmp_path / "lm.zip")
    X, Y = char_data(b=24, seed=3, dtype="float64")
    lmask = np.ones((24, 16))
    lmask[:, 12:] = 0.0
    ref = ref_pp_fit(path, X, Y, 8, 1, 2, 4, lmask=lmask)
    out = pool.run("pipeline_fit", 2, zip_path=path, X=X, Y=Y, batch=8,
                   data=1, stage=2, n_microbatches=4, lmask=lmask)
    check(out, ref, f64=True)


# ---------------------------------------------------------------- refusals
def _mesh(data=2, stage=4):
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    return Mesh(data, 1, stage=stage)


def _port(conf):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(conf, device="cpu").init()


def test_pipeline_parallel_refuses_what_the_reference_refuses():
    """Blocks the stages do not divide, no block run, a non-contiguous or
    mixed run, mixed precision, layer state, dropout, a stage degree of 1
    and a batch the microbatches do not split raise the reference's
    errors."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, DenseLayer, EmbeddingSequenceLayer, OutputLayer,
        RnnOutputLayer, TransformerBlock,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import PipelineParallelTrainer
    mesh = _mesh()
    lm = lambda **kw: TransformerLM(vocab_size=16, seq_length=8, n_embd=16,
                                    n_heads=2, **kw).conf()
    with pytest.raises(ValueError, match="divisible"):
        PipelineParallelTrainer(_port(lm(n_layers=3)), mesh)
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3))
            .list().layer(DenseLayer(n_out=8)).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    with pytest.raises(ValueError, match="TransformerBlock"):
        PipelineParallelTrainer(_port(conf), mesh)
    with pytest.raises(ValueError, match="compute_dtype"):
        PipelineParallelTrainer(_port(dataclasses.replace(
            lm(n_layers=4), compute_dtype="bfloat16")), mesh)
    with pytest.raises(ValueError, match="dropout 0"):
        PipelineParallelTrainer(_port(lm(n_layers=4, dropout=0.1)), mesh)
    b = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3)).list()
         .layer(EmbeddingSequenceLayer(n_in=8, n_out=16)))
    for _ in range(4):
        b = b.layer(TransformerBlock(n_out=16, n_heads=2))
    stateful = (b.layer(BatchNormalization()).layer(RnnOutputLayer(n_out=8))
                .set_input_type(InputType.recurrent(1, 8)).build())
    with pytest.raises(ValueError, match="carries state"):
        PipelineParallelTrainer(_port(stateful), mesh)
    b = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3)).list()
         .layer(EmbeddingSequenceLayer(n_in=8, n_out=16))
         .layer(TransformerBlock(n_out=16, n_heads=2))
         .layer(TransformerBlock(n_out=16, n_heads=4)))
    mixed = (b.layer(RnnOutputLayer(n_out=8))
             .set_input_type(InputType.recurrent(1, 8)).build())
    with pytest.raises(ValueError, match="identical"):
        PipelineParallelTrainer(_port(mixed), _mesh(1, 2))
    with pytest.raises(ValueError, match="'stage' axis"):
        PipelineParallelTrainer(_port(lm(n_layers=4)), _mesh(2, 1))
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        PipelineParallelTrainer(object(), mesh)


def test_pipeline_microbatch_rule_is_the_references():
    """A batch must split into M microbatches whose size the data degree
    divides; M defaults to twice the stage degree."""
    from deeplearning4j_tpu_torch.parallel import PipelineParallelTrainer
    t = PipelineParallelTrainer.__new__(PipelineParallelTrainer)
    t.n_microbatches, t.data_degree = 4, 2
    t._check_batch(16)
    for b in (12, 10):
        with pytest.raises(ValueError, match="microbatches"):
            t._check_batch(b)
