"""Training listeners — the callback bus of `fit()`.

Counterpart of the first part of the JAX package's `train/listeners.py`
(DL4J's TrainingListener framework):

- ScoreIterationListener          (logs the score every N iterations)
- PerformanceListener             (examples/s, batches/s, ETL time;
                                   PerformanceListener.java:22-87)
- CollectScoresIterationListener  (score history)

`PerformanceListener` reports throughput only: the reference's
compiled-program report and goodput come with the telemetry slice.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def iteration_done(self, model, iteration: int, epoch: int,
                       score: float, etl_ms: float = 0.0,
                       batch_size: int = 0):
        pass


class ScoreIterationListener(TrainingListener):
    def __init__(self, print_iterations: int = 10):
        self.n = max(int(print_iterations), 1)

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if iteration % self.n == 0:
            log.info("Score at iteration %d is %s", iteration, score)


class PerformanceListener(TrainingListener):
    """Throughput per reported iteration, on the host clock between
    consecutive `iteration_done` calls (each follows the step's loss
    fetch, so the interval covers the whole step). Records go to
    `history` and the log."""

    def __init__(self, frequency: int = 1, report: bool = True):
        self.frequency = max(int(frequency), 1)
        self.report = report
        self._last_time: Optional[float] = None
        self.history: List[dict] = []

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            rec = {
                "iteration": iteration,
                "batches_per_sec": 1.0 / dt if dt > 0 else float("inf"),
                "examples_per_sec": batch_size / dt if dt > 0
                else float("inf"),
                "etl_ms": etl_ms,
                "iteration_ms": dt * 1e3,
            }
            rec["samples_per_sec"] = rec["examples_per_sec"]
            self.history.append(rec)
            if self.report:
                log.info("ETL: %.0f ms; iteration %d; iteration time: %.1f ms; "
                         "examples/sec: %.1f; batches/sec: %.2f",
                         etl_ms, iteration, rec["iteration_ms"],
                         rec["examples_per_sec"], rec["batches_per_sec"])
        self._last_time = now


class CollectScoresIterationListener(TrainingListener):
    def __init__(self, frequency: int = 1):
        self.frequency = max(int(frequency), 1)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))
