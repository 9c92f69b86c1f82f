"""The resilient fit loop of the port (`train/resilience.py`) against the
JAX package's.

- The reference's own checks (tests/test_resilience.py, without its
  ParallelWrapper and transport cases, which wait for the parallel
  slice), run against the port: crash, retry-exhaustion, SIGTERM and
  injector resumes bitwise equal to an uninterrupted run, NaN skips, the
  consecutive-skip rollback, retries, the manifest's fallback and
  pruning, the checkpoint's extras, the normalizer, streaming seeks.
- What the port adds: an uninterrupted resilient fit is bitwise a
  per-call `fit()` (an MLP with dropout, and a ComputationGraph with
  dropout); the resumes above hold with dropout, mid-epoch, because the
  generator's state is banked (``"torch_rng"``); a retry whose failed
  attempt already stepped (tensors updated, noise drawn) is bitwise the
  unfaulted step; the snapshot is restored into the same tensor objects.
- Across packages, f64, a dropout-free MLP: a directory the reference
  wrote, preempted mid-epoch, resumed by the port, and one the port
  wrote at an epoch boundary resumed by the reference, each ending
  within 1e-10 of the reference's uninterrupted run; the metric families
  and spans of a faulted fit are the reference's.
"""
import json
import logging
import os
import signal
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.data.iterator import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JDense, OutputLayer as JOutput,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.train.resilience import (
    FaultPolicy as JFaultPolicy, ResilientTrainer as JResilientTrainer,
)
from deeplearning4j_tpu.util.faults import FaultInjector as JInjector
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch import monitor
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
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.train import (
    CheckpointManager, FaultPolicy, ResilientTrainer, TrainingDivergedError,
    TrainingListener,
)
from deeplearning4j_tpu_torch.util.faults import (
    FaultInjector, SimulatedCrash, TransientFaultError,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

rs = np.random.RandomState(0)
X = rs.randn(120, 6).astype("float32")
Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 120)]

FAST = FaultPolicy(backoff_base=0.001, backoff_max=0.004)
CROSS = 1e-10       # f64, across packages: the same math summed in other orders


def _conf(seed=7, dropout=0.5, dtype="float32"):
    return (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .dtype(dtype).list()
            .layer(DenseLayer(n_out=16, activation="relu", dropout=dropout))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def _net(seed=7, dropout=0.5):
    return MultiLayerNetwork(_conf(seed, dropout), device="cpu").init()


def _graph(dropout=0.5):
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(3)
                      .updater(Adam(1e-2)))
         .add_inputs("in").set_input_types(InputType.feed_forward(6)))
    g.add_layer("d", DenseLayer(n_out=12, dropout=dropout), "in")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "d")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device="cpu").init()


def _data(shuffle=False):
    return ArrayDataSetIterator(X, Y, batch_size=30, shuffle=shuffle, seed=5)


def _flat(net):
    return net.params_flat().numpy()


def _opt_leaves(net):
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return [t.clone() for t in tree_leaves(net.opt_state)]


def _assert_same_run(a, b):
    """Bitwise parameters, optimizer state, score and counters."""
    np.testing.assert_array_equal(_flat(a), _flat(b))
    for x, y in zip(_opt_leaves(a), _opt_leaves(b)):
        assert torch.equal(x, y)
    assert a.score() == b.score()
    assert (a.iteration_count, a.epoch_count) == (b.iteration_count,
                                                  b.epoch_count)


def _reference_run(tmp_path, epochs=3, shuffle=False):
    net = _net()
    ResilientTrainer(net, str(tmp_path / "ref"), save_every_n_iterations=100,
                     policy=FAST).fit(_data(shuffle), epochs=epochs)
    return net


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for mod in (monitor, jmonitor):
        mod.REGISTRY.reset()
        mod.disable_tracing()
        mod.clear_trace()
    yield
    for mod in (monitor, jmonitor):
        mod.REGISTRY.reset()
        mod.disable_tracing()
        mod.clear_trace()


# ---------------------------------------------------- the plain fit's step
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_uninterrupted_resilient_fit_is_bitwise_the_per_call_fit(kind,
                                                                 tmp_path):
    make = _net if kind == "mln" else _graph
    plain = make()
    plain.fit(_data(shuffle=True), epochs=3, scan_steps=1)
    resilient = make()
    rep = ResilientTrainer(resilient, str(tmp_path), save_every_n_iterations=5,
                           policy=FAST).fit(_data(shuffle=True), epochs=3)
    assert rep.applied_steps == 12 and rep.checkpoints_written >= 3
    _assert_same_run(plain, resilient)


# --------------------------------------------------------------- resume parity
@pytest.mark.parametrize("crash_at", [5, 7])
def test_resume_parity_after_crash(tmp_path, crash_at):
    """Kill-at-k + auto-resume is bitwise the uninterrupted run, with an
    epoch-dependent shuffle and dropout; crash_at=7 leaves the newest
    checkpoint mid-epoch (step 2 of epoch 1), so the resumed run continues
    the banked generator."""
    ref = _reference_run(tmp_path, shuffle=True)
    with pytest.raises(SimulatedCrash):
        ResilientTrainer(_net(), str(tmp_path / "b"),
                         save_every_n_iterations=2, policy=FAST,
                         injector=FaultInjector(crash_at=crash_at)
                         ).fit(_data(shuffle=True), epochs=3)
    resumed = _net()
    rep = ResilientTrainer(resumed, str(tmp_path / "b"),
                           save_every_n_iterations=2, policy=FAST
                           ).fit(_data(shuffle=True), epochs=3)
    assert rep.resumed_from is not None
    _assert_same_run(ref, resumed)


def test_resume_parity_computation_graph(tmp_path):
    ref = _graph()
    ResilientTrainer(ref, str(tmp_path / "a"), save_every_n_iterations=100,
                     policy=FAST).fit(_data(), epochs=2)
    with pytest.raises(SimulatedCrash):
        ResilientTrainer(_graph(), str(tmp_path / "b"),
                         save_every_n_iterations=2, policy=FAST,
                         injector=FaultInjector(crash_at=3)
                         ).fit(_data(), epochs=2)
    resumed = _graph()
    rep = ResilientTrainer(resumed, str(tmp_path / "b"),
                           save_every_n_iterations=2, policy=FAST
                           ).fit(_data(), epochs=2)
    assert rep.resumed_from is not None
    _assert_same_run(ref, resumed)


def test_parallel_wrapper_waits_for_the_parallel_slice(tmp_path):
    """The wrapper has landed: a SYNC_GRADIENTS wrapper over one rank
    crashes, resumes, and ends bitwise the network's own uninterrupted
    resilient run; AVERAGING is refused with the reference's error. (Two
    ranks: tests/test_torch_wrapper.py.)"""
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, TrainingMode,
    )
    ref = _reference_run(tmp_path, shuffle=True)
    with pytest.raises(SimulatedCrash):
        ResilientTrainer(ParallelWrapper(_net()), str(tmp_path / "w"),
                         save_every_n_iterations=2, policy=FAST,
                         injector=FaultInjector(crash_at=7)
                         ).fit(_data(shuffle=True), epochs=3)
    resumed = _net()
    rep = ResilientTrainer(ParallelWrapper(resumed), str(tmp_path / "w"),
                           save_every_n_iterations=2, policy=FAST
                           ).fit(_data(shuffle=True), epochs=3)
    assert rep.resumed_from is not None
    _assert_same_run(ref, resumed)
    with pytest.raises(NotImplementedError, match="SYNC_GRADIENTS mode "
                                                  "only"):
        ResilientTrainer(ParallelWrapper(_net(),
                                         mode=TrainingMode.AVERAGING),
                         str(tmp_path / "a"))


def test_resume_under_streaming_lands_on_exact_shard_offset(tmp_path):
    """ShardDataSetIterator + kill + auto-resume: bitwise parity with the
    uninterrupted run, and the resume seeks to the banked shard offset
    instead of replaying the stream prefix."""
    from deeplearning4j_tpu_torch.data.shards import (
        ShardDataSetIterator, write_shards,
    )
    shard_dir = str(tmp_path / "shards")
    write_shards(ArrayDataSetIterator(X, Y, batch_size=30, drop_last=False),
                 shard_dir, shard_records=32)

    def _shard_it():
        return ShardDataSetIterator(shard_dir, batch_size=30,
                                    shuffle=True, seed=5)

    ref = _net()
    ResilientTrainer(ref, str(tmp_path / "a"), save_every_n_iterations=100,
                     policy=FAST).fit(_shard_it(), epochs=3)
    with pytest.raises(SimulatedCrash):
        ResilientTrainer(_net(), str(tmp_path / "b"),
                         save_every_n_iterations=2, policy=FAST,
                         injector=FaultInjector(crash_at=3)
                         ).fit(_shard_it(), epochs=3)
    entry = CheckpointManager(str(tmp_path / "b")).latest_valid()
    with zipfile.ZipFile(entry["path"]) as zf:
        extra = json.loads(zf.read("resilience.json"))
    assert extra["step_in_epoch"] == 2
    assert extra["stream"]["next_batch"] == 2
    assert extra["stream"]["record_offset"] % 30 == 0
    assert extra["stream"]["shard_file"].endswith(".shard")
    resumed = _net()
    it = _shard_it()
    rep = ResilientTrainer(resumed, str(tmp_path / "b"),
                           save_every_n_iterations=2, policy=FAST
                           ).fit(it, epochs=3)
    assert rep.resumed_from is not None
    _assert_same_run(ref, resumed)
    assert it.batches_read == 12 - 2


def test_preempt_refit_same_process_multiproc_pipeline(tmp_path):
    """Preempt a worker-mode MultiProcessDataSetIterator fit in epoch 1,
    then re-fit with the SAME live pipeline: the seek path, and only the
    epoch resets the live source has not consumed are replayed."""
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader,
    )
    from deeplearning4j_tpu_torch.data.shards import write_shards
    shard_dir = str(tmp_path / "shards")
    write_shards(ArrayDataSetIterator(X, Y, batch_size=30, drop_last=False),
                 shard_dir, shard_records=32)

    def _pipe():
        return MultiProcessDataSetIterator(
            ShardBatchLoader(shard_dir, 30, shuffle=True, seed=5,
                             drop_last=False), num_workers=2)

    ref = _net()
    with _pipe() as p:
        ResilientTrainer(ref, str(tmp_path / "a"),
                         save_every_n_iterations=100, policy=FAST
                         ).fit(p, epochs=2)
    net = _net()
    ckpt = str(tmp_path / "b")
    with _pipe() as p:
        rep = ResilientTrainer(net, ckpt, save_every_n_iterations=1,
                               policy=FAST,
                               injector=FaultInjector(preempt_at=5)
                               ).fit(p, epochs=2)
        assert rep.preempted
        assert p.tell() == 1 and p.stream_state()["epoch"] == 1
        rep2 = ResilientTrainer(net, ckpt, policy=FAST).fit(p, epochs=2)
        assert rep2.resumed_from is not None
        assert rep2.applied_steps == 8 - 5
    np.testing.assert_array_equal(_flat(ref), _flat(net))


def test_completed_run_does_not_retrain_on_rerun(tmp_path):
    net = _net()
    ResilientTrainer(net, str(tmp_path), save_every_n_iterations=100,
                     policy=FAST).fit(_data(), epochs=2)
    before = _flat(net)
    ckpts_before = sorted(f for f in os.listdir(str(tmp_path))
                          if f.startswith("ckpt_"))
    rerun = _net()
    rep = ResilientTrainer(rerun, str(tmp_path), policy=FAST
                           ).fit(_data(), epochs=2)
    assert rep.applied_steps == 0 and rep.resumed_from is not None
    np.testing.assert_array_equal(before, _flat(rerun))
    assert sorted(f for f in os.listdir(str(tmp_path))
                  if f.startswith("ckpt_")) == ckpts_before


# ---------------------------------------------------------------- fault policy
def test_nan_steps_skipped_without_crashing(tmp_path):
    net = _net()
    rep = ResilientTrainer(net, str(tmp_path), save_every_n_iterations=100,
                           policy=FAST,
                           injector=FaultInjector(nan_at=(3, 7))
                           ).fit(_data(), epochs=3)
    assert rep.skipped_steps == 2
    assert rep.applied_steps == 10
    assert not rep.diverged
    assert np.isfinite(_flat(net)).all()
    assert np.isfinite(net.score())
    assert net.iteration_count == 10


def test_a_skip_restores_the_step_into_the_same_tensors(tmp_path):
    """After a NaN skip the parameters and optimizer state are bitwise
    those before the step, in the same tensor objects (the optimizer and
    captured steps hold them)."""
    seen = {}

    class Probe(FaultInjector):
        def before_step(self, step):
            if step in (3, 4):
                seen[step] = ([t for t in _leaves(net)],
                              [t.clone() for t in _leaves(net)])
            super().before_step(step)

    def _leaves(n):
        from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
        return tree_leaves(n.params) + tree_leaves(n.opt_state)

    net = _net()
    rep = ResilientTrainer(net, str(tmp_path), save_every_n_iterations=100,
                           policy=FAST, injector=Probe(nan_at=(3,))
                           ).fit(_data(), epochs=2)
    assert rep.skipped_steps == 1
    (objs3, vals3), (objs4, vals4) = seen[3], seen[4]
    assert all(a is b for a, b in zip(objs3, objs4))
    assert all(torch.equal(a, b) for a, b in zip(vals3, vals4))


def test_consecutive_skip_threshold_restores_last_good_checkpoint(tmp_path):
    net = _net()
    rep = ResilientTrainer(
        net, str(tmp_path), save_every_n_iterations=2,
        policy=FaultPolicy(max_consecutive_skips=2, backoff_base=0.001),
        injector=FaultInjector(nan_at=range(4, 50))).fit(_data(), epochs=3)
    assert rep.diverged
    assert rep.restored_checkpoint is not None
    ck = load_model(rep.restored_checkpoint, device="cpu")
    np.testing.assert_array_equal(_flat(ck), _flat(net))
    for a, b in zip(_opt_leaves(ck), _opt_leaves(net)):
        assert torch.equal(a, b)
    assert np.isfinite(_flat(net)).all()


def test_unrecoverable_raise_mode(tmp_path):
    net = _net()
    with pytest.raises(TrainingDivergedError):
        ResilientTrainer(
            net, str(tmp_path), save_every_n_iterations=2,
            policy=FaultPolicy(max_consecutive_skips=2, backoff_base=0.001,
                               on_unrecoverable="raise"),
            injector=FaultInjector(nan_at=range(4, 50))
        ).fit(_data(), epochs=3)
    assert np.isfinite(_flat(net)).all()


def test_transient_retry_is_transparent(tmp_path):
    clean = _reference_run(tmp_path)
    faulted = _net()
    inj = FaultInjector(transient_at=(2, 5))
    rep = ResilientTrainer(faulted, str(tmp_path / "b"),
                           save_every_n_iterations=100, policy=FAST,
                           injector=inj).fit(_data(), epochs=3)
    assert rep.retries == 2 and inj.transients_injected == 2
    _assert_same_run(clean, faulted)


def test_retry_after_a_step_that_ran_is_bitwise_the_unfaulted_step(
        tmp_path, monkeypatch):
    """A transient error raised AFTER the failed attempt updated the
    tensors in place and drew its dropout noise: the retry restores both
    the snapshot and the generator, so the run is bitwise the unfaulted
    one."""
    from deeplearning4j_tpu_torch.train import resilience
    clean = _reference_run(tmp_path)
    real_step = resilience._NetDriver.step
    failed = []

    def step_then_fail(self, batch, generator):
        out = real_step(self, batch, generator)
        if self.net.iteration_count in (2, 6) \
                and self.net.iteration_count not in failed:
            failed.append(self.net.iteration_count)
            raise TransientFaultError("link dropped after the step")
        return out

    monkeypatch.setattr(resilience._NetDriver, "step", step_then_fail)
    faulted = _net()
    rep = ResilientTrainer(faulted, str(tmp_path / "b"),
                           save_every_n_iterations=100, policy=FAST
                           ).fit(_data(), epochs=3)
    assert rep.retries == 2 and failed == [2, 6]
    _assert_same_run(clean, faulted)


def test_retry_exhaustion_checkpoints_then_raises(tmp_path):
    trainer = ResilientTrainer(
        _net(), str(tmp_path), save_every_n_iterations=100,
        policy=FaultPolicy(max_retries=1, backoff_base=0.001,
                           backoff_max=0.002),
        injector=_AlwaysTransient())
    with pytest.raises(TransientFaultError):
        trainer.fit(_data(), epochs=1)
    assert trainer.ckpt.latest_valid() is not None


class _AlwaysTransient(FaultInjector):
    def before_step(self, step):
        raise TransientFaultError(f"flaky forever at step {step}")


class _StuckStep(FaultInjector):
    """One step that fails on EVERY attempt (retry cannot save it)."""

    def __init__(self, step):
        super().__init__()
        self._stuck = step

    def before_step(self, step):
        if step == self._stuck:
            raise TransientFaultError(f"stuck at step {step}")


@pytest.mark.parametrize("guarded", [True, False])
def test_resume_parity_after_retry_exhaustion(tmp_path, guarded):
    """The emergency checkpoint written when retries run out banks the
    generator as it was before the failed step, so the resumed run draws
    the same noise for it: bitwise the uninterrupted run, with the step
    guarded by the snapshot or not (max_retries=0, skips off)."""
    ref = _reference_run(tmp_path)
    policy = FaultPolicy(max_retries=1, backoff_base=0.001,
                         backoff_max=0.002) if guarded \
        else FaultPolicy(max_retries=0, skip_nonfinite=False)
    with pytest.raises(TransientFaultError):
        ResilientTrainer(_net(), str(tmp_path / "b"),
                         save_every_n_iterations=100, policy=policy,
                         injector=_StuckStep(5)).fit(_data(), epochs=3)
    resumed = _net()
    rep = ResilientTrainer(resumed, str(tmp_path / "b"),
                           save_every_n_iterations=100, policy=FAST
                           ).fit(_data(), epochs=3)
    assert rep.resumed_from is not None
    _assert_same_run(ref, resumed)


# ----------------------------------------------------------------- preemption
def test_preemption_via_sigterm_checkpoints_and_resumes(tmp_path):
    ref = _reference_run(tmp_path)

    class Kick(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score,
                           etl_ms=0.0, batch_size=0):
            if iteration == 5:
                os.kill(os.getpid(), signal.SIGTERM)

    net = _net()
    net.set_listeners(Kick())
    rep = ResilientTrainer(net, str(tmp_path / "p"),
                           save_every_n_iterations=100, policy=FAST
                           ).fit(_data(), epochs=3)
    assert rep.preempted
    assert signal.getsignal(signal.SIGTERM) is not None     # restored
    resumed = _net()
    rep2 = ResilientTrainer(resumed, str(tmp_path / "p"),
                            save_every_n_iterations=100, policy=FAST
                            ).fit(_data(), epochs=3)
    assert rep2.resumed_from is not None and not rep2.preempted
    _assert_same_run(ref, resumed)


def test_preemption_via_injector(tmp_path):
    ref = _reference_run(tmp_path)
    net = _net()
    rep = ResilientTrainer(net, str(tmp_path / "p"),
                           save_every_n_iterations=100, policy=FAST,
                           injector=FaultInjector(preempt_at=5)
                           ).fit(_data(), epochs=3)
    assert rep.preempted and rep.checkpoints_written >= 1
    resumed = _net()
    ResilientTrainer(resumed, str(tmp_path / "p"),
                     save_every_n_iterations=100, policy=FAST
                     ).fit(_data(), epochs=3)
    _assert_same_run(ref, resumed)


# --------------------------------------------------------- checkpoint manager
def test_corrupted_checkpoint_falls_back_to_previous(tmp_path):
    trainer = ResilientTrainer(_net(), str(tmp_path),
                               save_every_n_iterations=2, policy=FAST)
    trainer.fit(_data(), epochs=1)
    mgr = trainer.ckpt
    entries = mgr._read_manifest()["checkpoints"]
    assert len(entries) >= 2
    with open(os.path.join(str(tmp_path), entries[-1]["file"]), "wb") as f:
        f.write(b"truncated garbage")
    best = mgr.latest_valid()
    assert best is not None and best["file"] == entries[-2]["file"]
    rep = ResilientTrainer(_net(), str(tmp_path), policy=FAST
                           ).fit(_data(), epochs=1)
    assert rep.resumed_from.endswith(entries[-2]["file"])


def test_manager_pruning_ignores_foreign_files(tmp_path):
    foreign = tmp_path / "exported_model.zip"
    foreign.write_bytes(b"user data, not ours")
    notes = tmp_path / "NOTES.txt"
    notes.write_text("keep me")
    ResilientTrainer(_net(), str(tmp_path), save_every_n_iterations=1,
                     keep_last=2, policy=FAST).fit(_data(), epochs=1)
    assert foreign.exists() and notes.exists()
    ckpts = [f for f in os.listdir(str(tmp_path)) if f.startswith("ckpt_")]
    assert len(ckpts) == 2
    assert not [f for f in os.listdir(str(tmp_path)) if ".tmp." in f]


def test_checkpoint_zip_carries_the_generator_and_counters(tmp_path):
    """resilience.json banks the generator under the port's own key, and
    never a reference-format "rng" the reference would misread; the
    entries are stored."""
    trainer = ResilientTrainer(_net(), str(tmp_path),
                               save_every_n_iterations=3, policy=FAST)
    trainer.fit(_data(), epochs=1)
    entry = trainer.ckpt.latest_valid()
    with zipfile.ZipFile(entry["path"]) as zf:
        names = set(zf.namelist())
        assert {"configuration.json", "coefficients.npz", "state.npz",
                "updaterState.bin", "metadata.json",
                "resilience.json"} <= names
        # stored, not deflated: the fit waits for each save
        assert {i.compress_type for i in zf.infolist()} == {
            zipfile.ZIP_STORED}
        extra = json.loads(zf.read("resilience.json"))
    assert "rng" not in extra and "step_in_epoch" in extra
    assert extra["torch_rng"]["device"] == "cpu"
    assert len(bytes.fromhex(extra["torch_rng"]["state"])) == len(
        bytes(torch.Generator().get_state().numpy()))
    assert entry["sha256"]


def test_checkpoint_restores_normalizer(tmp_path):
    from deeplearning4j_tpu_torch.data.normalization import (
        NormalizerStandardize,
    )
    norm = NormalizerStandardize().fit(_data())
    src = _data().set_pre_processor(norm)
    ResilientTrainer(_net(), str(tmp_path), save_every_n_iterations=100,
                     policy=FAST, normalizer=norm).fit(src, epochs=1)
    t2 = ResilientTrainer(_net(), str(tmp_path), policy=FAST)
    t2.fit(_data(), epochs=1)
    assert t2.normalizer is not None
    np.testing.assert_allclose(t2.normalizer.feature_mean,
                               norm.feature_mean)


def test_eval_gate_blesses_and_is_counted(tmp_path):
    trainer = ResilientTrainer(_net(), str(tmp_path),
                               save_every_n_iterations=2, policy=FAST,
                               eval_gate=lambda net: {"acc": 1.0})
    rep = trainer.fit(_data(), epochs=1)
    assert rep.checkpoints_blessed == rep.checkpoints_written >= 2
    with open(os.path.join(str(tmp_path), "blessed.json")) as f:
        doc = json.load(f)
    assert doc["metrics"] == {"acc": 1.0}
    ctr = monitor.REGISTRY.collect("resilience_checkpoints_blessed_total")
    assert ctr.value() == rep.checkpoints_blessed


def test_tbptt_is_refused_as_the_reference_refuses_it(tmp_path):
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
            .list().layer(LSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(3, 8))
            .tbptt(4).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(NotImplementedError, match="tbptt"):
        ResilientTrainer(net, str(tmp_path)).fit(
            (np.zeros((2, 8, 3), "float32"), np.zeros((2, 8, 2), "float32")))


# ------------------------------------------------------- across the packages
@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


X64, Y64 = X.astype("float64"), Y.astype("float64")
J_FAST = JFaultPolicy(backoff_base=0.001, backoff_max=0.004)


def _jnet():
    conf = (JNNC.Builder().seed(7).updater(JAdam(1e-2)).dtype("float64")
            .list().layer(JDense(n_out=16, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(6)).build())
    return JMLN(conf).init()


def _jdata():
    return JArrayIt(X64, Y64, batch_size=30, shuffle=True, seed=5)


def _pdata():
    return ArrayDataSetIterator(X64, Y64, batch_size=30, shuffle=True, seed=5)


def _port_from(jnet, tmp_path):
    path = str(tmp_path / "init.zip")
    jax_save(jnet, path)
    return load_model(path, device="cpu")


def _assert_close_to(jnet, pnet):
    want = np.asarray(jnet.params_flat())
    got = _flat(pnet)
    assert np.max(np.abs(got - want)) <= CROSS * max(1.0, np.abs(want).max())
    assert (pnet.iteration_count, pnet.epoch_count) == (
        jnet.iteration_count, jnet.epoch_count)


def test_a_reference_directory_preempted_mid_epoch_resumes_in_the_port(
        tmp_path, x64, caplog):
    ref = _jnet()
    JResilientTrainer(ref, str(tmp_path / "a"), save_every_n_iterations=100,
                      policy=J_FAST).fit(_jdata(), epochs=3)
    start = _jnet()
    rep = JResilientTrainer(start, str(tmp_path / "b"),
                            save_every_n_iterations=100, policy=J_FAST,
                            injector=JInjector(preempt_at=6)
                            ).fit(_jdata(), epochs=3)
    assert rep.preempted                      # epoch 1, step 2: mid-epoch
    resumed = _port_from(_jnet(), tmp_path)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        rep = ResilientTrainer(resumed, str(tmp_path / "b"),
                               save_every_n_iterations=100, policy=FAST
                               ).fit(_pdata(), epochs=3)
    assert rep.resumed_from is not None and rep.applied_steps == 12 - 6
    assert any("noise stream restarts" in r.message for r in caplog.records)
    _assert_close_to(ref, resumed)


def test_a_port_directory_at_an_epoch_boundary_resumes_in_the_reference(
        tmp_path, x64):
    ref = _jnet()
    JResilientTrainer(ref, str(tmp_path / "a"), save_every_n_iterations=100,
                      policy=J_FAST).fit(_jdata(), epochs=3)
    port = _port_from(_jnet(), tmp_path)
    with pytest.raises(SimulatedCrash):
        # the newest checkpoint is the end of epoch 0 (step-in-epoch 0);
        # the reference resumes mid-epoch only from its own "rng" key
        ResilientTrainer(port, str(tmp_path / "b"),
                         save_every_n_iterations=100, policy=FAST,
                         injector=FaultInjector(crash_at=5)
                         ).fit(_pdata(), epochs=3)
    entry = CheckpointManager(str(tmp_path / "b")).latest_valid()
    assert (entry["epoch"], entry["step_in_epoch"]) == (1, 0)
    resumed = _jnet()
    rep = JResilientTrainer(resumed, str(tmp_path / "b"),
                            save_every_n_iterations=100, policy=J_FAST
                            ).fit(_jdata(), epochs=3)
    assert rep.resumed_from is not None and rep.applied_steps == 8
    want = np.asarray(ref.params_flat())
    got = np.asarray(resumed.params_flat())
    assert np.max(np.abs(got - want)) <= CROSS * max(1.0, np.abs(want).max())


def _families(dump, prefix):
    return sorted(k for k in dump if k.startswith(prefix))


def test_a_faulted_fit_emits_the_references_families_and_spans(tmp_path):
    """Retry, skip, checkpoints, preemption and a resume: the resilience_*
    metric families and the span names of both packages' trainers are the
    same, and so are the counts."""
    def drive(trainer_cls, policy_cls, injector_cls, net, data, root):
        policy = policy_cls(backoff_base=0.001, backoff_max=0.002)
        trainer_cls(net(), str(root), save_every_n_iterations=2,
                    policy=policy,
                    injector=injector_cls(transient_at=(1,), nan_at=(3,),
                                          preempt_at=6)).fit(data(), epochs=2)
        trainer_cls(net(), str(root), save_every_n_iterations=2,
                    policy=policy).fit(data(), epochs=2)

    def jconf():
        conf = (JNNC.Builder().seed(7).updater(JAdam(1e-2)).list()
                .layer(JDense(n_out=16, activation="relu"))
                .layer(JOutput(n_out=3, activation="softmax",
                               loss="mcxent"))
                .set_input_type(JInputType.feed_forward(6)).build())
        return JMLN(conf).init()

    for mod in (monitor, jmonitor):
        mod.enable_tracing()
    drive(JResilientTrainer, JFaultPolicy, JInjector, jconf,
          lambda: JArrayIt(X, Y, batch_size=30), tmp_path / "j")
    drive(ResilientTrainer, FaultPolicy, FaultInjector, _net, _data,
          tmp_path / "p")
    mine, ref = monitor.dump(), jmonitor.dump()
    assert _families(mine, "resilience_") == _families(ref, "resilience_")
    for name in _families(ref, "resilience_"):
        if name.endswith("_total"):
            assert mine[name] == ref[name], name

    def spans(mod):
        return sorted({e["name"] for e in mod.trace_events()
                       if e["name"].startswith(("resilience/",
                                                "train/resume"))})
    assert spans(monitor) == spans(jmonitor)
    assert "resilience/checkpoint_restore" in spans(monitor)
