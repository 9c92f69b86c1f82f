"""Training listeners — the callback bus of `fit()`.

Counterpart of the JAX package's `train/listeners.py` (DL4J's
TrainingListener framework):

- ScoreIterationListener          (logs the score every N iterations)
- PerformanceListener             (examples/s, batches/s, ETL time;
                                   PerformanceListener.java:22-87)
- CollectScoresIterationListener  (score history)
- TimeIterationListener           (remaining-time estimate)
- EvaluativeListener              (periodic held-out evaluation)
- CheckpointListener              (periodic checkpoints with keep_last;
                                   checkpoint/CheckpointListener.java:72-144)
- ProfilerListener                (a torch.profiler trace of a window of
                                   iterations)
- DivergenceListener              (NaN/Inf or exploding score)

`PerformanceListener` is the reference's: throughput gauges, a step
program's FLOPs, HBM peak and MFU from the program ledger
(`monitor/xla.py`) once per program, and goodput from the live session
(`monitor/goodput.py`), each only when that ledger is on.

Parameters are updated in place by every step, so a listener that keeps
the model's tensors past its call copies them first:
`CheckpointListener(async_save=True)` enqueues device-to-host copies
into pinned buffers behind the step on the compute stream and hands
those buffers, with an event, to its worker thread.
"""
from __future__ import annotations

import logging
import math
import os
import re
import time
from typing import Callable, List, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    #: True for listeners whose iteration_done inspects the MODEL (params,
    #: opt state) rather than just the scalar score stream. The chunked
    #: fit (fit(scan_steps=K)) delivers iteration_done up to 2K-1 steps
    #: after the params have advanced, so such listeners force the
    #: per-call path, where model state and iteration number agree.
    reads_model = False

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


class TimeIterationListener(TrainingListener):
    """Logs remaining-time estimate (DL4J TimeIterationListener)."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.frequency = max(int(frequency), 1)
        self._start: Optional[float] = None

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = elapsed / iteration
            remaining = (self.total - iteration) * rate
            log.info("Remaining time estimate: %.1f s (iteration %d/%d)",
                     remaining, iteration, self.total)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (DL4J EvaluativeListener)."""

    reads_model = True

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = max(int(frequency), 1)
        self.unit = unit
        self.results: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model, iteration)

    def on_epoch_end(self, model, epoch):
        if self.unit == "epoch" and (epoch + 1) % self.frequency == 0:
            self._evaluate(model, epoch)

    def _evaluate(self, model, at):
        ev = model.evaluate(self.iterator)
        self.results.append((at, ev))
        log.info("Evaluation at %s %d: accuracy=%.4f", self.unit, at,
                 ev.accuracy())


def _host_snapshot(model):
    """A copy of `model` on the host for a background save, and the event
    its copies end in (None on the CPU). CUDA tensors are copied into
    pinned buffers with non-blocking copies enqueued on the current
    stream, so the training thread does not wait: the next step's
    in-place update is ordered after them on the same stream. CPU
    tensors are cloned. The copy carries the counters and no optimizer
    of its own (`save_model` reads `opt_state` as it is)."""
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import tree_map

    def to_host(t):
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h
        return t.detach().clone()

    snap = type(model)(model.conf, device="cpu")
    snap.params = tree_map(to_host, model.params)
    snap.state = tree_map(to_host, model.state)
    snap.opt_state = None if model.opt_state is None \
        else tree_map(to_host, model.opt_state)
    snap.iteration_count = model.iteration_count
    snap.epoch_count = model.epoch_count
    event = None
    if model.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(model.device))
    return snap, event


class CheckpointListener(TrainingListener):
    """Periodic checkpoint saver with retention policy
    (DL4J checkpoint/CheckpointListener.java:46-144: saveEveryNIterations /
    saveEveryNEpochs + keepLast).

    `async_save=True` moves the zip serialization off the training thread:
    the snapshot (`_host_snapshot`) is enqueued behind the step with no
    host wait, and a background worker waits on its event before it
    compresses and writes the zip. Call `flush()` (or use the listener as a
    context manager) to wait for pending saves; errors from background
    saves surface on the next save or flush."""

    reads_model = True      # snapshots params: scan-mode fit falls back

    def __init__(self, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.async_save = async_save
        self._saved: List[str] = []
        self._executor = None
        self._pending: List = []
        os.makedirs(directory, exist_ok=True)

    def _prune(self):
        """keep_last retention by directory scan: only files matching the
        tag kinds THIS listener writes (checkpoint_iter_* and/or
        checkpoint_epoch_*) count and get deleted — foreign files in the
        directory are ignored. Ordered by the counter in the file name,
        not mtime, and per kind (iteration and epoch counters are not
        comparable)."""
        kinds = [k for k, on in (("iter", self.every_iter),
                                 ("epoch", self.every_epoch)) if on]
        if not kinds:
            return
        pat = re.compile(rf"^checkpoint_({'|'.join(kinds)})_(\d+)\.zip$")
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for kind in kinds:
            own = sorted((int(m.group(2)), n) for n in names
                         for m in [pat.match(n)] if m and m.group(1) == kind)
            while len(own) > self.keep_last:
                try:
                    os.remove(os.path.join(self.dir, own.pop(0)[1]))
                except OSError:
                    pass

    def _save(self, model, tag: str):
        # save_model's default atomic mode (tmp + os.replace) means a kill
        # mid-save can never leave a truncated checkpoint zip at `path`
        from deeplearning4j_tpu_torch.util.serialization import save_model
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        if self.async_save:
            import concurrent.futures
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt")
            self._raise_pending_errors(block=False)
            snap, event = _host_snapshot(model)

            def job():
                if event is not None:
                    event.synchronize()
                save_model(snap, path)
                # retention runs AFTER the file lands; the single-worker
                # executor serializes these mutations
                self._saved.append(path)
                self._prune()

            self._pending.append(self._executor.submit(job))
        else:
            save_model(model, path)
            self._saved.append(path)
            self._prune()

    def _raise_pending_errors(self, block: bool):
        still = []
        for f in self._pending:
            if f.done() or block:
                f.result()          # re-raises background failures
            else:
                still.append(f)
        self._pending = still

    def flush(self):
        """Block until all background saves land (async_save mode)."""
        self._raise_pending_errors(block=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.flush()
        finally:                    # never leak the worker thread
            if self._executor is not None:
                self._executor.shutdown(wait=True)

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if self.every_iter and iteration > 0 \
                and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model, epoch):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0:
            self._save(model, f"epoch_{epoch}")


class ProfilerListener(TrainingListener):
    """A torch.profiler trace of a window of iterations (the reference
    records an XLA trace with jax.profiler). CPU activity always, CUDA
    activity when the network is on a card; the window's Chrome trace is
    written into `log_dir` as ``trace_<start>_<stop>.json``. The profiler
    starts one iteration before the window when there is one, as a
    warm-up step whose events are dropped (torch.profiler's schedule):
    kernels launched just after the tracer starts can be missed.

    Usage:
        net.set_listeners(ProfilerListener("/tmp/trace", start_iteration=5,
                                           num_iterations=3))
        net.fit(...)          # iterations [5, 8) are traced
    """

    reads_model = True      # brackets live device work: needs per-call fit

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 num_iterations: int = 3):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.stop_iteration = start_iteration + num_iterations
        self._active = False
        self._prof = None
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None

    def _start(self, model, warmup: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        activities = [ProfilerActivity.CPU]
        if getattr(model, "device", None) is not None \
                and model.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=warmup,
                              active=self.stop_iteration
                              - self.start_iteration, repeat=1),
            on_trace_ready=self._export)
        self._prof.__enter__()
        self._active = True

    def _export(self, prof):
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir,
            f"trace_{self.start_iteration}_{self.stop_iteration}.json")
        prof.export_chrome_trace(self.trace_path)
        self.trace_dir = self.log_dir
        log.info("profiler trace written to %s", self.trace_path)

    def _stop(self):
        self._prof.__exit__(None, None, None)
        self._prof = None
        self._active = False

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if self._prof is None:
            if iteration + 2 == self.start_iteration:
                self._start(model, warmup=1)
            elif iteration + 1 == self.start_iteration:
                self._start(model, warmup=0)    # no iteration to warm on
            return
        self._prof.step()
        if iteration + 1 >= self.stop_iteration:
            self._stop()

    def on_epoch_end(self, model, epoch):
        if self._active:        # epoch ended inside the window: close out
            self._stop()


class DivergenceListener(TrainingListener):
    """Training failure detection: watches the score stream for NaN/Inf
    or a sustained explosion and either raises TrainingDivergedError (the
    default — fail the job before it burns more device hours) or invokes
    a callback (alerting / checkpoint-and-restart policies).

    Usage:
        net.set_listeners(DivergenceListener())                  # raise
        net.set_listeners(DivergenceListener(on_divergence=cb))  # custom
    """

    def __init__(self, explosion_factor: float = 1e4,
                 window: int = 20, on_divergence: Optional[Callable] = None):
        self.explosion_factor = explosion_factor
        self.window = window
        self.on_divergence = on_divergence
        # a custom callback receives the model; the default raise path only
        # reads the score stream and stays scan-compatible
        self.reads_model = on_divergence is not None
        self._recent: List[float] = []

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        bad = None
        if not math.isfinite(score):
            bad = f"non-finite score {score} at iteration {iteration}"
        else:
            self._recent.append(score)
            if len(self._recent) > self.window:
                self._recent.pop(0)
            baseline = min(self._recent)
            if baseline > 0 and score > baseline * self.explosion_factor:
                bad = (f"score exploded: {score:.4g} > "
                       f"{self.explosion_factor:g} x recent best "
                       f"{baseline:.4g} at iteration {iteration}")
        if bad:
            if self.on_divergence is not None:
                self.on_divergence(model, iteration, bad)
            else:
                raise TrainingDivergedError(bad)


class TrainingDivergedError(RuntimeError):
    """Raised by DivergenceListener when the loss goes NaN/Inf/explodes."""
