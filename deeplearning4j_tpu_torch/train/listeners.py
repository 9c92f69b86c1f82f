"""Training listeners — the callback bus of `fit()`.

Counterpart of the first part of the JAX package's `train/listeners.py`
(DL4J's TrainingListener framework):

- ScoreIterationListener          (logs the score every N iterations)
- PerformanceListener             (examples/s, batches/s, ETL time;
                                   PerformanceListener.java:22-87)
- CollectScoresIterationListener  (score history)

`PerformanceListener` is the reference's: throughput gauges, a step
program's FLOPs, HBM peak and MFU from the program ledger
(`monitor/xla.py`) once per program, and goodput from the live session
(`monitor/goodput.py`), each only when that ledger is on.
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
    """Reports throughput per iteration (DL4J PerformanceListener.java:22-87).

    Every reported record carries the SAME four numbers in the history
    dict, the log line, and the telemetry registry (monitor/metrics.py:
    train_examples_per_sec / train_batches_per_sec gauges and the
    train_etl_seconds histogram) — one source of truth for throughput,
    whether you read logs, listener history, or a /metrics scrape."""

    def __init__(self, frequency: int = 1, report: bool = True):
        self.frequency = max(int(frequency), 1)
        self.report = report
        self._last_time: Optional[float] = None
        self._compiled_logged: set = set()   # ledger fingerprints reported
        self.history: List[dict] = []

    def _report_compiled(self):
        """Once per distinct step program (first iteration after its
        counted step): log HBM peak and MFU, sourced from the monitor.xla
        ledger — just a dict read. No-op while the ledger is disabled."""
        from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
        if not xla_ledger.enabled():
            return
        rec = xla_ledger.latest_record("train")
        if rec is None or rec.fingerprint in self._compiled_logged:
            return
        mfu = xla_ledger.last_mfu("train")
        if mfu is None and rec.flops and xla_ledger.device_peak_flops():
            # debut iteration: it was the counted step, so no MFU sample
            # exists yet — log on the next (steady) iteration
            return
        self._compiled_logged.add(rec.fingerprint)
        peak = rec.hbm_peak_bytes
        log.info(
            "compiled step %s (fingerprint %s): %s GFLOP/call, HBM peak "
            "%s, compile %.2f s, mfu %s",
            rec.name, rec.fingerprint,
            "n/a" if not rec.flops else f"{rec.flops / 1e9:.2f}",
            "n/a" if peak is None else f"{peak / 2**20:.1f} MiB",
            rec.compile_seconds,
            "n/a" if mfu is None else f"{mfu:.1f}%")

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        from deeplearning4j_tpu_torch import monitor
        if self.report:
            self._report_compiled()
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            rec = {
                "iteration": iteration,
                "batches_per_sec": 1.0 / dt if dt > 0 else float("inf"),
                "examples_per_sec": batch_size / dt if dt > 0 else float("inf"),
                "etl_ms": etl_ms,
                "iteration_ms": dt * 1e3,
            }
            # historical key kept so existing consumers don't break
            rec["samples_per_sec"] = rec["examples_per_sec"]
            self.history.append(rec)
            if dt > 0:
                monitor.gauge("train_examples_per_sec",
                              "Training throughput, examples/sec "
                              "(PerformanceListener)").set(
                    rec["examples_per_sec"])
                monitor.gauge("train_batches_per_sec",
                              "Training throughput, batches/sec "
                              "(PerformanceListener)").set(
                    rec["batches_per_sec"])
            monitor.histogram("train_etl_seconds",
                              "Host ETL time per reported iteration "
                              "(PerformanceListener)").observe(etl_ms / 1e3)
            # goodput beside throughput, sourced from the ledger's live
            # session (the same accumulators /metrics scrapes, so the
            # log line and the gauge cannot disagree); absent while the
            # ledger is off
            from deeplearning4j_tpu_torch.monitor import goodput
            gp = goodput.live_stats()
            if gp is not None:
                rec["goodput_pct"] = gp["goodput_pct"]
                rec["dominant_stall"] = gp["dominant_stall"]
            if self.report:
                suffix = ""
                if gp is not None:
                    suffix = (f"; goodput: {gp['goodput_pct']:.1f}%% "
                              f"(top stall: {gp['dominant_stall']})")
                log.info("ETL: %.0f ms; iteration %d; iteration time: %.1f ms; "
                         "examples/sec: %.1f; batches/sec: %.2f" + suffix,
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
