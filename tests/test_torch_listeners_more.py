"""The rest of the port's listeners (`train/listeners.py`) and
`ComputationGraph.copy`, against the JAX package.

The reference's checks (tests/test_training_extras.py: profiler,
divergence, async checkpoints, graph copy; tests/test_resilience.py's
CheckpointListener case) run against the port, and:
- `EvaluativeListener` and `TimeIterationListener` see what the
  reference's see on the same zip and data (accuracies equal, the
  estimate logged at the same iterations);
- an async `CheckpointListener` save holds exactly what a synchronous
  save at the same iteration holds (every array bitwise, the optimizer
  state's bytes equal), though the training thread ran on while its
  worker wrote it;
- a `ProfilerListener` window holds the steps' operators, and exactly
  the window's iterations (its warm-up iteration dropped).
"""
import json
import logging
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.iterator import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.train.listeners import (
    EvaluativeListener as JEvaluative,
)
from deeplearning4j_tpu.util.serialization import load_model as jax_load
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.train import (
    CheckpointListener, DivergenceListener, EvaluativeListener,
    ProfilerListener, TimeIterationListener, TrainingDivergedError,
)
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)

rs = np.random.RandomState(0)
X = rs.randn(120, 6).astype("float32")
Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 120)]


def _mlp(seed=4, updater=None, dropout=None):
    return MultiLayerNetwork(
        (NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater or Adam(1e-2)).list()
         .layer(DenseLayer(n_out=8, activation="tanh", dropout=dropout))
         .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
         .set_input_type(InputType.feed_forward(6)).build()),
        device="cpu").init()


def _tiny_graph():
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(0)
                      .updater(Sgd(1e-2)))
         .add_inputs("in").set_input_types(InputType.feed_forward(4)))
    g.add_layer("d", DenseLayer(n_out=6), "in")
    g.add_layer("out", OutputLayer(n_out=2), "d")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device="cpu").init()


def _zip_arrays(path):
    """Every entry of a checkpoint zip: npz entries as {name: array},
    others as bytes (npz members carry their write time, so two saves of
    one state differ as bytes but not as arrays)."""
    import io
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            data = zf.read(name)
            if name.endswith(".npz"):
                with np.load(io.BytesIO(data)) as z:
                    out[name] = {k: np.array(z[k]) for k in z.files}
            else:
                out[name] = data
    return out


def assert_same_checkpoint(a, b):
    za, zb = _zip_arrays(a), _zip_arrays(b)
    assert sorted(za) == sorted(zb)
    for name in za:
        if isinstance(za[name], dict):
            assert sorted(za[name]) == sorted(zb[name]), name
            for k in za[name]:
                assert za[name][k].dtype == zb[name][k].dtype
                np.testing.assert_array_equal(za[name][k], zb[name][k])
        else:
            assert za[name] == zb[name], name


# ------------------------------------------------------- CheckpointListener
def test_async_save_holds_exactly_the_sync_save_at_that_iteration(tmp_path):
    """The same seeded net trained twice, one with an async listener and
    one with a sync one, both saving every 3 iterations: each async zip
    holds the state of its own iteration (the next steps updated the
    live tensors in place while the worker wrote it)."""
    def run(directory, async_save):
        net = _mlp(dropout=0.5)
        with CheckpointListener(str(directory), save_every_n_iterations=3,
                                keep_last=10, async_save=async_save) as ck:
            net.set_listeners(ck)
            net.fit(ArrayDataSetIterator(X, Y, batch_size=12), epochs=1)
        return net
    a = run(tmp_path / "async", True)
    s = run(tmp_path / "sync", False)
    assert torch.equal(a.params_flat(), s.params_flat())
    names = sorted(os.listdir(str(tmp_path / "async")))
    assert names == sorted(os.listdir(str(tmp_path / "sync"))) == [
        "checkpoint_iter_3.zip", "checkpoint_iter_6.zip",
        "checkpoint_iter_9.zip"]
    for n in names:
        assert_same_checkpoint(str(tmp_path / "async" / n),
                               str(tmp_path / "sync" / n))
    assert load_model(str(tmp_path / "async" / names[0]),
                      device="cpu").iteration_count == 3
    assert not torch.equal(
        load_model(str(tmp_path / "async" / names[0]),
                   device="cpu").params_flat(), a.params_flat())


def test_async_checkpoint_listener(tmp_path):
    """The reference's case: retention, a finite restore that refits."""
    X2 = rs.rand(64, 6).astype("float32")
    Y2 = np.eye(3, dtype="float32")[rs.randint(0, 3, 64)]
    net = _mlp(updater=Sgd(1e-2))
    with CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                            keep_last=2, async_save=True) as ckpt:
        net.set_listeners(ckpt)
        net.fit(ArrayDataSetIterator(X2, Y2, batch_size=8), epochs=1)
    files = sorted(f for f in os.listdir(str(tmp_path)) if f.endswith(".zip"))
    assert 1 <= len(files) <= 2, files
    restored = load_model(os.path.join(str(tmp_path), files[-1]),
                          device="cpu")
    assert np.isfinite(float(restored.params_flat().sum()))
    restored.fit(ArrayDataSetIterator(X2, Y2, batch_size=8), epochs=1)
    assert np.isfinite(restored.score())


def test_async_checkpoint_preserves_counters(tmp_path):
    net = _mlp()
    with CheckpointListener(str(tmp_path), save_every_n_iterations=4,
                            keep_last=1, async_save=True) as ckpt:
        net.set_listeners(ckpt)
        net.fit(ArrayDataSetIterator(X[:64], Y[:64], batch_size=8),
                epochs=1)
    files = [f for f in os.listdir(str(tmp_path)) if f.endswith(".zip")]
    assert len(files) == 1, files
    restored = load_model(os.path.join(str(tmp_path), files[0]),
                          device="cpu")
    assert restored.iteration_count == 4


def test_async_save_errors_surface_on_flush(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.util import serialization

    def broken(*a, **k):
        raise OSError("disk full")
    net = _mlp()
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                            async_save=True)
    monkeypatch.setattr(serialization, "save_model", broken)
    ck.iteration_done(net, 1, 0, 0.5)
    with pytest.raises(OSError, match="disk full"):
        ck.__exit__(None, None, None)


def test_checkpoint_listener_atomic_and_foreign_tolerant(tmp_path):
    foreign = tmp_path / "precious_export.zip"
    foreign.write_bytes(b"do not delete")
    stale = tmp_path / "checkpoint_iter_0.zip"
    stale.write_bytes(b"old run")
    net = _mlp()
    lst = CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                             keep_last=2)
    net.set_listeners(lst)
    net.fit(ArrayDataSetIterator(X, Y, batch_size=12), epochs=1)
    names = sorted(os.listdir(str(tmp_path)))
    assert "precious_export.zip" in names
    assert not [n for n in names if ".tmp." in n]
    own = [n for n in names if n.startswith("checkpoint_")]
    assert own == ["checkpoint_iter_6.zip", "checkpoint_iter_8.zip"]
    restored = load_model(os.path.join(str(tmp_path), own[-1]), device="cpu")
    assert np.isfinite(restored.params_flat().numpy()).all()


def test_epoch_checkpoints_and_the_reference_reads_them(tmp_path):
    net = _mlp()
    net.set_listeners(CheckpointListener(str(tmp_path),
                                         save_every_n_epochs=1, keep_last=2))
    net.fit(ArrayDataSetIterator(X, Y, batch_size=30), epochs=3)
    assert sorted(os.listdir(str(tmp_path))) == [
        "checkpoint_epoch_1.zip", "checkpoint_epoch_2.zip"]
    ref = jax_load(str(tmp_path / "checkpoint_epoch_2.zip"))
    np.testing.assert_array_equal(np.asarray(ref.params_flat()),
                                  net.params_flat().numpy())


# --------------------------------------------------------- the other three
def test_evaluative_listener_matches_the_reference(tmp_path):
    path = save_model(_mlp(), str(tmp_path / "m.zip"))
    held = (X[:40], Y[:40])
    port, ref = load_model(path, device="cpu"), jax_load(path)
    pl = EvaluativeListener(ArrayDataSetIterator(*held, batch_size=20),
                            frequency=2, unit="iteration")
    jl = JEvaluative(JArrayIt(*held, batch_size=20), frequency=2,
                     unit="iteration")
    port.set_listeners(pl)
    ref.set_listeners(jl)
    port.fit(ArrayDataSetIterator(X, Y, batch_size=30), epochs=2)
    ref.fit(JArrayIt(X, Y, batch_size=30), epochs=2)
    assert [at for at, _ in pl.results] == [at for at, _ in jl.results] \
        == [0, 2, 4, 6]
    for (_, a), (_, b) in zip(pl.results, jl.results):
        assert a.accuracy() == b.accuracy()
    assert EvaluativeListener.reads_model is True

    per_epoch = EvaluativeListener(ArrayDataSetIterator(*held,
                                                        batch_size=20))
    port.set_listeners(per_epoch)
    port.fit(ArrayDataSetIterator(X, Y, batch_size=30), epochs=2)
    assert [at for at, _ in per_epoch.results] == [2, 3]


def test_time_iteration_listener_logs_the_estimate(caplog):
    net = _mlp()
    lst = TimeIterationListener(total_iterations=8, frequency=2)
    net.set_listeners(lst)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        net.fit(ArrayDataSetIterator(X, Y, batch_size=30), epochs=2)
    said = [r.message for r in caplog.records
            if r.message.startswith("Remaining time estimate")]
    assert [m.split("(iteration ")[1] for m in said] == [
        "2/8)", "4/8)", "6/8)"]
    assert TimeIterationListener.reads_model is False


def test_divergence_listener_raises_on_nan_and_explosion():
    class FakeModel:
        pass

    lst = DivergenceListener()
    lst.iteration_done(FakeModel(), 0, 0, 1.0, 0.0, 8)
    with pytest.raises(TrainingDivergedError, match="non-finite"):
        lst.iteration_done(FakeModel(), 1, 0, float("nan"), 0.0, 8)
    lst2 = DivergenceListener(explosion_factor=100.0)
    for i in range(5):
        lst2.iteration_done(FakeModel(), i, 0, 1.0, 0.0, 8)
    with pytest.raises(TrainingDivergedError, match="exploded"):
        lst2.iteration_done(FakeModel(), 5, 0, 500.0, 0.0, 8)
    seen = []
    lst3 = DivergenceListener(
        on_divergence=lambda m, it, msg: seen.append((it, msg)))
    lst3.iteration_done(FakeModel(), 7, 0, float("inf"), 0.0, 8)
    assert seen and seen[0][0] == 7
    assert lst.reads_model is False and lst3.reads_model is True

    rs2 = np.random.RandomState(0)
    Xe = (rs2.rand(64, 6) * 50).astype("float32")
    Ye = np.eye(2, dtype="float32")[rs2.randint(0, 2, 64)]
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(500.0))
            .list().layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(6)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.set_listeners(DivergenceListener(explosion_factor=10.0, window=3))
    with pytest.raises(TrainingDivergedError):
        net.fit(ArrayDataSetIterator(Xe, Ye, batch_size=16), epochs=50)


def test_profiler_listener_writes_trace(tmp_path):
    Xp = rs.rand(64, 4).astype("float32")
    Yp = np.eye(2, dtype="float32")[rs.randint(0, 2, 64)]
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2))
            .list().layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    prof = ProfilerListener(str(tmp_path), start_iteration=2,
                            num_iterations=2)
    net.set_listeners(prof)
    net.fit(ArrayDataSetIterator(Xp, Yp, batch_size=16), epochs=2)
    assert prof.trace_dir == str(tmp_path)
    assert not prof._active
    assert prof.trace_path == str(tmp_path / "trace_2_4.json")
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n or "mm" in n for n in names), sorted(names)[:20]
    # the window's two iterations; the warm-up iteration before it dropped
    assert sorted(n for n in names if n.startswith("ProfilerStep")) == [
        "ProfilerStep#1", "ProfilerStep#2"]


def test_profiler_window_closes_at_the_epochs_end(tmp_path):
    net = _mlp()
    prof = ProfilerListener(str(tmp_path), start_iteration=3,
                            num_iterations=10)
    net.set_listeners(prof)
    net.fit(ArrayDataSetIterator(X, Y, batch_size=30), epochs=1)
    assert not prof._active and os.path.exists(prof.trace_path)


# -------------------------------------------------------------- graph copy
def test_computation_graph_copy_independent():
    net = _tiny_graph()
    clone = net.copy()
    r = np.random.RandomState(0)
    X4 = r.rand(16, 4).astype("float32")
    assert clone.device == net.device
    assert torch.equal(clone.output(X4), net.output(X4))
    Y4 = np.eye(2, dtype="float32")[r.randint(0, 2, 16)]
    net.fit(DataSet(X4, Y4), epochs=3)
    assert not np.allclose(clone.params_flat().numpy(),
                           net.params_flat().numpy())
    # the clone trains from its own fresh optimizer state
    clone.fit(DataSet(X4, Y4), epochs=3)
    assert torch.equal(clone.params_flat(), net.params_flat())
