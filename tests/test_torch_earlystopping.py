"""The port's early stopping (`train/earlystopping.py`) against the JAX
package's.

- The reference's checks (tests/test_training_extras.py): max epochs,
  score improvement on noise, the divergence guard.
- The same zip through both trainers: the same termination, epochs and
  best epoch, scores by epoch within rtol 1e-5 (f32 Adam steps on two
  stacks).
- `InMemoryModelSaver.restore_best` gives the best epoch's parameters
  bitwise after later epochs changed them (the port's steps update in
  place: a saver that kept references would hand back the last epoch),
  into the network's own tensors; `LocalFileModelSaver` round-trips.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.train import earlystopping as jes
from deeplearning4j_tpu.util.serialization import load_model as jax_load
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_leaves
from deeplearning4j_tpu_torch.train.earlystopping import (
    BestScoreEpochTerminationCondition, ClassificationScoreCalculator,
    DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
    InMemoryModelSaver, LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition, MaxTimeIterationTerminationCondition,
    ScoreCalculator, ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)


def _blobs(n=240, d=6, k=3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // k, d)
                        for i in range(k)]).astype("float32")
    Y = np.eye(k, dtype="float32")[np.repeat(np.arange(k), n // k)]
    perm = rs.permutation(n)
    return X[perm], Y[perm]


def _mlp(k=3, d=6, lr=2e-2, seed=0):
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Adam(lr)).list()
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=k, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(d)).build())


def _net(**kw):
    return MultiLayerNetwork(_mlp(**kw), device="cpu").init()


# -------------------------------------------------- the reference's checks
def test_early_stopping_max_epochs():
    X, Y = _blobs()
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator((X, Y)),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(4)])
    result = EarlyStoppingTrainer(cfg, _net(), (X, Y)).fit()
    assert result.termination_reason == "epoch"
    assert result.total_epochs == 4
    assert result.best_model is not None
    assert len(result.score_vs_epoch) == 4


def test_early_stopping_score_improvement():
    rs = np.random.RandomState(1)
    X = rs.randn(120, 6).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 120)]
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator((X, Y)),
        epoch_termination_conditions=[
            ScoreImprovementEpochTerminationCondition(2),
            MaxEpochsTerminationCondition(50)])
    result = EarlyStoppingTrainer(cfg, _net(lr=1e-3, seed=1), (X, Y)).fit()
    assert result.total_epochs <= 50
    assert result.best_model_score <= min(result.score_vs_epoch.values()) \
        + 1e-9


def test_early_stopping_divergence_guard():
    X, Y = _blobs()
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(10)],
        iteration_termination_conditions=[
            MaxScoreIterationTerminationCondition(max_score=1e-6)])
    result = EarlyStoppingTrainer(cfg, _net(), (X, Y)).fit()
    assert result.termination_reason == "iteration"
    assert "MaxScoreIterationTerminationCondition" in \
        result.termination_details


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("case", ["improvement", "accuracy_every_2"])
def test_the_same_zip_stops_where_the_reference_stops(case, tmp_path):
    X, Y = _blobs(seed=2)
    Xv, Yv = _blobs(n=90, seed=3)
    path = save_model(_net(lr=5e-2, seed=2), str(tmp_path / "m.zip"))

    def config(mod, held):
        if case == "improvement":
            return mod.EarlyStoppingConfiguration(
                score_calculator=mod.DataSetLossCalculator(held),
                epoch_termination_conditions=[
                    mod.ScoreImprovementEpochTerminationCondition(1, 1e-3),
                    mod.MaxEpochsTerminationCondition(12)])
        return mod.EarlyStoppingConfiguration(
            score_calculator=mod.ClassificationScoreCalculator(held),
            epoch_termination_conditions=[
                mod.BestScoreEpochTerminationCondition(0.99,
                                                       minimize=False),
                mod.MaxEpochsTerminationCondition(7)],
            evaluate_every_n_epochs=2)

    import deeplearning4j_tpu_torch.train.earlystopping as pes
    mine = pes.EarlyStoppingTrainer(config(pes, (Xv, Yv)),
                                    load_model(path, device="cpu"),
                                    (X, Y), batch_size=30).fit()
    ref = jes.EarlyStoppingTrainer(config(jes, (Xv, Yv)), jax_load(path),
                                   (X, Y), batch_size=30).fit()
    assert (mine.termination_reason, mine.termination_details,
            mine.total_epochs, mine.best_model_epoch) == (
        ref.termination_reason, ref.termination_details, ref.total_epochs,
        ref.best_model_epoch)
    assert sorted(mine.score_vs_epoch) == sorted(ref.score_vs_epoch)
    for e in ref.score_vs_epoch:
        np.testing.assert_allclose(mine.score_vs_epoch[e],
                                   ref.score_vs_epoch[e], rtol=1e-5)


# ------------------------------------------------------------------- savers
class _Scripted(ScoreCalculator):
    """Scores by epoch from a list, so the best epoch is not the last."""

    def __init__(self, scores):
        self.scores = list(scores)

    def calculate(self, model):
        return self.scores.pop(0)


class _EpochParams:
    """Clones of the parameters at each epoch's end."""
    reads_model = True

    def __init__(self):
        self.by_epoch = []

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        self.by_epoch.append(model.params_flat().clone())

    def iteration_done(self, *a, **k):
        pass


def test_in_memory_saver_restores_the_best_epoch_not_the_last():
    X, Y = _blobs()
    net = _net()
    keep = _EpochParams()
    net.set_listeners(keep)
    live = [t for t in tree_leaves(net.params)]
    cfg = EarlyStoppingConfiguration(
        score_calculator=_Scripted([3.0, 1.0, 2.0, 4.0]),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(4)])
    result = EarlyStoppingTrainer(cfg, net, (X, Y)).fit()
    assert result.best_model_epoch == 1 and result.total_epochs == 4
    assert result.best_model is net
    assert torch.equal(net.params_flat(), keep.by_epoch[1])
    assert not torch.equal(keep.by_epoch[1], keep.by_epoch[3])
    # written into the network's own tensors
    assert all(a is b for a, b in zip(live, tree_leaves(net.params)))


def test_in_memory_saver_latest_and_empty():
    net = _net()
    saver = InMemoryModelSaver()
    assert saver.restore_best(net) is net
    saver.save_latest(net)
    before = net.params_flat().clone()
    with torch.no_grad():
        for t in tree_leaves(net.params):
            t.add_(1.0)
    assert torch.equal(saver._latest[0]["0"]["W"].reshape(-1),
                       before[:saver._latest[0]["0"]["W"].numel()])


def test_local_file_saver_round_trips(tmp_path):
    X, Y = _blobs()
    cfg = EarlyStoppingConfiguration(
        score_calculator=ClassificationScoreCalculator((X, Y)),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
        model_saver=LocalFileModelSaver(str(tmp_path)),
        save_last_model=True)
    result = EarlyStoppingTrainer(cfg, _net(), (X, Y)).fit()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bestModel.zip", "latestModel.zip"]
    best = result.best_model
    assert isinstance(best, MultiLayerNetwork) and best.device.type == "cpu"
    assert best.evaluate((X, Y)).accuracy() == result.best_model_score


def test_time_condition_stops_at_once():
    X, Y = _blobs()
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(5)],
        iteration_termination_conditions=[
            MaxTimeIterationTerminationCondition(0.0)])
    result = EarlyStoppingTrainer(cfg, _net(), (X, Y)).fit()
    assert result.termination_reason == "iteration"
    assert result.total_epochs == 1
