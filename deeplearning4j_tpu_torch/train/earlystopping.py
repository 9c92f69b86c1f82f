"""Early stopping — config-driven train-until-criteria loops.

Counterpart of the JAX package's `train/earlystopping.py` (DL4J
`deeplearning4j-nn/.../earlystopping/`): `EarlyStoppingConfiguration`
(termination conditions, score calculator, model saver,
evaluate-every-N-epochs), `EarlyStoppingTrainer`
(`trainer/BaseEarlyStoppingTrainer.java:47,77`, the epoch loop), the
termination conditions, the savers and `EarlyStoppingResult`.

The port's steps update the parameters in place, so `InMemoryModelSaver`
keeps clones (the reference keeps references to immutable arrays, which
here would follow every later update) and `restore_best` writes them
back into the network's tensors.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import step_graph
from deeplearning4j_tpu_torch.nn.updaters import tree_map


# ----------------------------------------------------------- score calculators
class ScoreCalculator:
    """Computes the model-selection score after each epoch (lower is better
    unless minimize=False). DL4J: DataSetLossCalculator etc."""
    minimize = True

    def calculate(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (DL4J DataSetLossCalculator)."""

    def __init__(self, data, batch_size: int = 32):
        self.data = data
        self.batch_size = batch_size

    def calculate(self, model) -> float:
        iterator = model._as_iterator(self.data, self.batch_size) \
            if not hasattr(self.data, "reset") else self.data
        total, count = 0.0, 0
        for ds in iterator:
            n = int(np.shape(ds.features)[0])
            total += model.score(ds) * n
            count += n
        iterator.reset()
        return total / max(count, 1)


class ClassificationScoreCalculator(ScoreCalculator):
    """Maximize accuracy/f1 on held-out data (DL4J ClassificationScoreCalculator)."""
    minimize = False

    def __init__(self, data, metric: str = "accuracy", batch_size: int = 32):
        self.data = data
        self.metric = metric
        self.batch_size = batch_size

    def calculate(self, model) -> float:
        ev = model.evaluate(self.data, batch_size=self.batch_size)
        return float(getattr(ev, self.metric)())


# ------------------------------------------------------ termination conditions
class EpochTerminationCondition:
    # Conditions that compare the epoch SCORE set uses_score = True; they are
    # only consulted on epochs where a score was actually computed (eval
    # epochs when a score calculator is configured). Epoch/time-count
    # conditions leave it False and run every epoch.
    uses_score = False

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, iteration: int, score: float, elapsed_s: float) -> bool:
        raise NotImplementedError


@dataclasses.dataclass
class MaxEpochsTerminationCondition(EpochTerminationCondition):
    max_epochs: int

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


@dataclasses.dataclass
class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (min_improvement) improvement."""
    max_epochs_without_improvement: int
    min_improvement: float = 0.0
    uses_score = True

    def __post_init__(self):
        self._best: Optional[float] = None
        self._since = 0
        self.minimize = True

    def terminate(self, epoch, score):
        s = score if self.minimize else -score
        if self._best is None or s < self._best - self.min_improvement:
            self._best = s
            self._since = 0
            return False
        self._since += 1
        return self._since > self.max_epochs_without_improvement


@dataclasses.dataclass
class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as the score is at least as good as a target."""
    best_expected_score: float
    minimize: bool = True
    uses_score = True

    def terminate(self, epoch, score):
        return score <= self.best_expected_score if self.minimize \
            else score >= self.best_expected_score


@dataclasses.dataclass
class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    max_seconds: float

    def terminate(self, iteration, score, elapsed_s):
        return elapsed_s >= self.max_seconds


@dataclasses.dataclass
class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on divergence: training loss exceeds a bound (or NaN)."""
    max_score: float

    def terminate(self, iteration, score, elapsed_s):
        return not math.isfinite(score) or score > self.max_score


# --------------------------------------------------------------------- savers
class InMemoryModelSaver:
    """DL4J InMemoryModelSaver: best/latest parameter and state copies in
    memory, on the network's device. `restore_best` writes the best copy
    back into the network's tensors (in place, so the optimizer and any
    captured step keep their references)."""

    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _copy(model):
        return (tree_map(torch.clone, model.params),
                tree_map(torch.clone, model.state))

    def save_best(self, model):
        self._best = self._copy(model)

    def save_latest(self, model):
        self._latest = self._copy(model)

    def restore_best(self, model):
        if self._best is None:
            return model
        with torch.no_grad():
            step_graph.commit(model.params, tree_map(torch.clone,
                                                     self._best[0]))
            step_graph.commit(model.state, tree_map(torch.clone,
                                                    self._best[1]))
        model._drop_graphs()
        return model


class LocalFileModelSaver:
    """DL4J LocalFileModelSaver: bestModel.zip / latestModel.zip on disk."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save_best(self, model):
        from deeplearning4j_tpu_torch.util.serialization import save_model
        save_model(model, os.path.join(self.directory, "bestModel.zip"))

    def save_latest(self, model):
        from deeplearning4j_tpu_torch.util.serialization import save_model
        save_model(model, os.path.join(self.directory, "latestModel.zip"))

    def restore_best(self, model):
        """A new network loaded from bestModel.zip, on `model`'s device."""
        from deeplearning4j_tpu_torch.util.serialization import load_model
        return load_model(os.path.join(self.directory, "bestModel.zip"),
                          device=model.device)


# --------------------------------------------------------------------- config
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    """DL4J EarlyStoppingConfiguration.Builder analog."""
    score_calculator: Optional[ScoreCalculator] = None
    epoch_termination_conditions: List[EpochTerminationCondition] = \
        dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    model_saver: Any = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    """DL4J EarlyStoppingResult: why we stopped + best model info."""
    termination_reason: str          # "epoch" | "iteration" | "exhausted"
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any


class EarlyStoppingTrainer:
    """DL4J BaseEarlyStoppingTrainer: epoch loop + per-iteration divergence
    checks via a listener."""

    def __init__(self, config: EarlyStoppingConfiguration, model, data,
                 batch_size: int = 32):
        self.config = config
        self.model = model
        self.data = data
        self.batch_size = batch_size

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        model = self.model
        if model.params is None:
            model.init()
        calc = cfg.score_calculator
        best_score = None
        best_epoch = -1
        score_history = {}
        start = time.monotonic()
        epoch = 0
        reason, details = "exhausted", "no termination condition fired"

        # iteration-level divergence/time guard (DL4J checks inside the
        # iteration listener)
        class _Guard:
            stop = False
            why = ""

            def on_epoch_start(self, *a): pass
            def on_epoch_end(self, *a): pass

            def iteration_done(_self, m, it, ep, score, etl, bs):
                elapsed = time.monotonic() - start
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(it, score, elapsed):
                        _self.stop = True
                        _self.why = f"{type(c).__name__} at iteration {it}"

        guard = _Guard()
        saved_listeners = list(model.listeners)
        model.listeners = saved_listeners + [guard]
        try:
            while True:
                model.fit(self.data, epochs=1, batch_size=self.batch_size)
                if guard.stop:
                    reason, details = "iteration", guard.why
                    break
                do_eval = (epoch % cfg.evaluate_every_n_epochs == 0)
                if calc and not do_eval:
                    # With a score calculator configured, skipped-eval epochs
                    # do NOT substitute the training loss — it is on a
                    # different scale (and direction) than the validation
                    # score, so best-model selection and score-based
                    # termination only run on eval epochs (DL4J
                    # BaseEarlyStoppingTrainer behavior).
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest(model)
                    fired = None
                    for c in cfg.epoch_termination_conditions:
                        if not c.uses_score:    # epoch/time-count conditions
                            if c.terminate(epoch, float("nan")):
                                fired = c
                                break
                    if fired is not None:
                        reason = "epoch"
                        details = f"{type(fired).__name__} at epoch {epoch}"
                        break
                    epoch += 1
                    continue
                # graftlint: disable=host-sync-in-hot-path -- ONE per-epoch score materialization (not per-step); everything below reuses the host float
                score = float(calc.calculate(model) if calc
                              else model.score())
                minimize = calc.minimize if calc else True
                score_history[epoch] = score
                better = (best_score is None or
                          (score < best_score if minimize else score > best_score))
                if better:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best(model)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest(model)
                fired = None
                for c in cfg.epoch_termination_conditions:
                    if c.uses_score and hasattr(c, "minimize"):
                        c.minimize = minimize
                    if c.terminate(epoch, score):
                        fired = c
                        break
                if fired is not None:
                    reason = "epoch"
                    details = f"{type(fired).__name__} at epoch {epoch}"
                    break
                epoch += 1
        finally:
            model.listeners = saved_listeners
        best_model = cfg.model_saver.restore_best(model)
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            score_vs_epoch=score_history,
            best_model=best_model,
        )
