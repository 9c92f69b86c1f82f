"""The port's ParallelWrapper (`parallel/wrapper.py`) against the
reference's.

The same seeded reference network (one zip) trains under the reference's
ParallelWrapper over N of the conftest's 8 CPU devices and under the
port's over an N-rank gloo group (`tests/_torch_dist`): SYNC_GRADIENTS
at N = 2 and 4 (and in f64), AVERAGING at N = 2 with frequency 1 and 3,
with and without averaged optimizer state, a ragged final batch
(wrap-padded, the padded rows masked out) and a ComputationGraph. After
the steps every rank holds the same parameters, within 1e-5 relative of
the reference's (1e-10 in f64). ResilientTrainer over a two-rank
wrapper is preempted, resumes, and ends bitwise the uninterrupted run,
with only rank 0 writing checkpoints.
"""
import numpy as np
import pytest

import jax

from _torch_dist import (
    RankPool, assert_params_close, blobs, ref_flat, ref_graph, ref_mesh,
    ref_mlp, ref_source, save_ref,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.util.serialization import load_model as jload


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    return save_ref(ref_mlp(), tmp_path_factory.mktemp("w") / "mlp.zip")


def _ref(path, world, X, Y, batch=32, epochs=1, **kw):
    net = jload(path)
    JWrapper(net, mesh=ref_mesh(world), **kw).fit(
        ref_source(net, X, Y, batch), epochs=epochs, batch_size=batch)
    return net


def _check(out, ref, f64=False):
    for o in out:
        np.testing.assert_array_equal(o["flat"], out[0]["flat"])
    assert_params_close(out[0]["flat"], ref_flat(ref), f64=f64)
    assert out[0]["iterations"] == ref.iteration_count


CASES = [
    ("sync2", 2, {}), ("sync4", 4, {}),
    ("avg_f1", 2, dict(mode="averaging", averaging_frequency=1)),
    ("avg_f3", 2, dict(mode="averaging", averaging_frequency=3)),
    ("avg_f3_no_updaters", 2, dict(mode="averaging", averaging_frequency=3,
                                   average_updaters=False)),
]


@pytest.mark.parametrize("name,world,kw", CASES, ids=[c[0] for c in CASES])
def test_wrapper_parity(pool, mlp_zip, name, world, kw):
    """Two epochs of 3 steps of 32."""
    X, Y = blobs()
    ref = _ref(mlp_zip, world, X, Y, epochs=2, **kw)
    out = pool.run("wrapper_fit", world, zip_path=mlp_zip, X=X, Y=Y,
                   batch=32, epochs=2, **kw)
    _check(out, ref)
    assert out[0]["n_workers"] == world
    np.testing.assert_allclose(out[0]["score"], ref.score(), rtol=1e-5)


def test_wrapper_sync_f64(pool, tmp_path):
    jax.config.update("jax_enable_x64", True)
    try:
        path = save_ref(ref_mlp(dtype="float64"), tmp_path / "m64.zip")
        X, Y = blobs(dtype="float64")
        ref = _ref(path, 2, X, Y)
        out = pool.run("wrapper_fit", 2, zip_path=path, X=X, Y=Y, batch=32)
        _check(out, ref, f64=True)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("mode", ["sync_gradients", "averaging"])
def test_wrapper_ragged_batch_is_exact(pool, mlp_zip, mode):
    """44 rows over 4 ranks: one ragged batch, wrap-padded with its padded
    rows masked out of the loss — the reference's exact result (SYNC: the
    one-device step on the 44 rows)."""
    X, Y = blobs(n=48, seed=3)
    X, Y = X[:44], Y[:44]
    ref = _ref(mlp_zip, 4, X, Y, batch=64, mode=mode,
               averaging_frequency=1)
    out = pool.run("wrapper_fit", 4, zip_path=mlp_zip, X=X, Y=Y, batch=64,
                   mode=mode, averaging_frequency=1)
    _check(out, ref)
    assert abs(out[0]["score"] - ref.score()) < 1e-6
    if mode == "sync_gradients":
        single = jload(mlp_zip)
        single.fit((X, Y), batch_size=64)
        assert_params_close(out[0]["flat"], ref_flat(single))


class _Scores:
    def __init__(self):
        self.vals = []

    def iteration_done(self, net, it, ep, score, etl_ms, bs):
        self.vals.append(score)

    def on_epoch_start(self, net, epoch):
        pass

    def on_epoch_end(self, net, epoch):
        pass


def test_wrapper_graph_and_report_after_averaging(pool, tmp_path):
    """A ComputationGraph under SYNC and under AVERAGING with
    report_score_after_averaging: the listeners see the reference's
    scores (none before the first average, then each average's mean
    loss)."""
    path = save_ref(ref_graph(), tmp_path / "g.zip", graph=True)
    X, Y = blobs()
    for kw in ({}, dict(mode="averaging", averaging_frequency=2,
                        report_score_after_averaging=True)):
        ref = jload(path)
        sc = _Scores()
        ref.set_listeners(sc)
        JWrapper(ref, mesh=ref_mesh(2), **kw).fit(
            ref_source(ref, X, Y, 32), epochs=1)
        out = pool.run("wrapper_fit", 2, zip_path=path, X=X, Y=Y, batch=32,
                       **kw)
        _check(out, ref)
        assert [v is None for v in out[0]["scores"]] == \
            [v is None for v in sc.vals]
        np.testing.assert_allclose(
            [v for v in out[0]["scores"] if v is not None],
            [v for v in sc.vals if v is not None], rtol=1e-5)


def test_wrapper_sync_is_the_plans_fit(pool, mlp_zip):
    """SYNC_GRADIENTS is a shim over the plan: bitwise fit(plan=)."""
    X, Y = blobs()
    w = pool.run("wrapper_fit", 2, zip_path=mlp_zip, X=X, Y=Y, batch=32)
    p = pool.run("fit_plan", 2, zip_path=mlp_zip, X=X, Y=Y, batch=32,
                 plan=dict(data=2))
    np.testing.assert_array_equal(w[0]["flat"], p[0]["flat"])


def test_resilient_wrapper_resumes_bitwise_rank0_writes(pool, mlp_zip,
                                                        tmp_path):
    X, Y = blobs()
    kw = dict(zip_path=mlp_zip, X=X, Y=Y, batch=32, epochs=2)
    ref = pool.run("resilient_wrapper", 2, ckpt_dir=str(tmp_path / "a"),
                   **kw)
    cut = pool.run("resilient_wrapper", 2, ckpt_dir=str(tmp_path / "b"),
                   preempt_at=4, **kw)
    assert all(c["preempted"] for c in cut)
    assert cut[0]["written"] > 0 and cut[1]["written"] == 0
    resumed = pool.run("resilient_wrapper", 2, ckpt_dir=str(tmp_path / "b"),
                       **kw)
    assert all(r["resumed_from"] is not None for r in resumed)
    assert resumed[1]["written"] == 0
    for r in resumed:
        np.testing.assert_array_equal(r["flat"], ref[0]["flat"])
        assert r["iterations"] == 6
