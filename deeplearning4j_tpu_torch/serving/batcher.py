"""Shape-bucketed dynamic batcher.

Counterpart of the JAX package's `serving/batcher.py`:

- **Bucket ladder.** Coalesced request groups are padded up to a fixed
  ladder of batch sizes, and oversized groups are chunked into max-bucket
  pieces, so the runner only ever sees ladder shapes.
- **Warmup.** `warm()` pushes a zeros batch of every bucket through the
  runner at load time, so first-use costs (kernel build, allocator
  growth) are paid before the first request.
- **Coalescing deadline.** The worker waits at most `max_delay_ms` from
  the first queued request before dispatching.
- **Admission control.** A full queue raises `ServerOverloadedError`
  (HTTP 429); a request whose deadline expired before dispatch gets
  `DeadlineExceededError` (504); a draining batcher raises
  `ServerDrainingError` (503).

`dispatches` counts runner calls (one per ladder chunk, warmup included).
The reference's telemetry rides along: the first-run ledger
`serving_bucket_compiles_total{model,bucket}` increments when a bucket
shape runs for the first time in the current model generation (a
"compile" here is a shape's first use: its kernels, allocations and
first-call costs) and `serving_warmup_runs_total` counts warmup runs, so
``compiles == warmups`` on /metrics shows no request paid a first use;
queue depth, rejections, batch sizes, padding waste, and the
`serving/queue_wait` / `serving/batch` spans under each request's trace
context.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_BUCKETS = (1, 8, 32, 128)


class ServingError(RuntimeError):
    """Base class for request-path serving failures."""


class ServerOverloadedError(ServingError):
    """Admission control: the request queue is full (HTTP 429)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before a result was ready (504)."""


class ServerDrainingError(ServingError):
    """The batcher is draining for shutdown; not accepting requests (503)."""


class _Request:
    __slots__ = ("x", "deadline", "event", "result", "error", "enqueued",
                 "ctx", "t0")

    def __init__(self, x, deadline: Optional[float]):
        self.x = x
        self.deadline = deadline        # absolute time.monotonic() or None
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.enqueued = time.monotonic()
        # the submitting thread's trace context (None while tracing and
        # the flight recorder are off — one thread-local read, no alloc)
        self.ctx = monitor.current_context()
        self.t0 = time.perf_counter()   # queue-wait span start


class ShapeBucketedBatcher:
    """Coalesce concurrent requests, pad to the bucket ladder, run once.

    `runner(x) -> np.ndarray` is the execution engine (the served
    network's forward); any callable with that signature works in tests.
    """

    def __init__(self, runner: Callable, input_shape: Tuple[int, ...],
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_ms: float = 5.0,
                 queue_limit: int = 256,
                 dtype="float32",
                 name: str = "default"):
        bs = sorted(set(int(b) for b in buckets))
        if not bs or bs[0] < 1:
            raise ValueError(f"bucket ladder must be positive ints: {buckets}")
        self.runner = runner
        self.input_shape = tuple(int(s) for s in input_shape)
        self.buckets = tuple(bs)
        self.max_delay = max(0.0, float(max_delay_ms)) / 1e3
        self.dtype = np.dtype(dtype)
        self.name = name
        self.dispatches = 0             # runner calls, warmup included
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._count_lock = threading.Lock()
        self._compiled: set = set()     # bucket sizes run in this generation
        self._gen_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.batcher.ShapeBucketedBatcher."
            "_gen_lock")
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop, daemon=True,
                                        name=f"ServingBatcher-{name}")
        self._worker.start()

    # -------------------------------------------------------------- buckets
    def bucket_for(self, n: int) -> int:
        """Smallest ladder size >= n (the max bucket for oversized n —
        callers chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pad(self, x: np.ndarray, b: int) -> np.ndarray:
        if x.shape[0] == b:
            return x
        pad = np.zeros((b - x.shape[0],) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0)

    def _run_bucketed(self, x: np.ndarray,
                      runner: Optional[Callable] = None,
                      warmup: bool = False, ledger=None) -> np.ndarray:
        """Pad/chunk to ladder shapes, run, unpad: the ONLY call site of
        the runner (`runner` overrides the live one: a swap's warm), so
        every execution goes through the first-run ledger. `ledger`
        overrides the live generation's set: warm() builds the NEXT
        generation's aside, so concurrent requests against the still-live
        old model never read a half-built one."""
        runner = self.runner if runner is None else runner
        n = x.shape[0]
        outs, ofs = [], 0
        while ofs < n:
            take = min(n - ofs, self.buckets[-1])
            b = self.bucket_for(take)
            chunk = self._pad(np.asarray(x[ofs:ofs + take]), b)
            with self._gen_lock:
                seen = self._compiled if ledger is None else ledger
                first = b not in seen
                if first:
                    seen.add(b)
            if first:
                monitor.counter(
                    "serving_bucket_compiles_total",
                    "First executions of a bucket shape per model "
                    "generation (each implies one XLA compile)",
                    labels=("model", "bucket")).inc(
                        model=self.name, bucket=str(b))
                if not warmup:
                    # the flight timeline must show WHEN a live request
                    # paid a first use
                    flight.note(monitor.current_context(),
                                "bucket_compile", bucket=b,
                                model=self.name)
                    log.warning(
                        "serving[%s]: bucket %d first ran on the REQUEST "
                        "path (its first-use costs hit a live request) — "
                        "warm() was skipped or the ladder changed",
                        self.name, b)
            with self._count_lock:
                self.dispatches += 1
            outs.append(runner(chunk)[:take])
            ofs += take
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def warm(self, run: Optional[Callable] = None) -> float:
        """Run a zeros batch of every bucket; returns the seconds taken.
        `run` overrides the live runner — a swap passes the replacement
        network's, so its first-use costs are paid before it goes live.
        The new generation's first-run ledger is built aside and
        installed on completion."""
        t0 = time.perf_counter()
        fresh: set = set()
        for b in self.buckets:
            zeros = np.zeros((b,) + self.input_shape, self.dtype)
            with monitor.span("serving/warmup", model=self.name, bucket=b):
                self._run_bucketed(zeros, run, warmup=True, ledger=fresh)
            monitor.counter("serving_warmup_runs_total",
                            "AOT warmup executions (one per bucket per "
                            "model generation)",
                            labels=("model",)).inc(model=self.name)
        with self._gen_lock:
            self._compiled = fresh
        seconds = time.perf_counter() - t0
        monitor.histogram("serving_warmup_seconds",
                          "Full bucket-ladder warmup duration",
                          labels=("model",),
                          buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120)
                          ).observe(seconds, model=self.name)
        return seconds

    # ------------------------------------------------------------------ API
    def predict(self, x, deadline: Optional[float] = None,
                timeout: float = 60.0) -> np.ndarray:
        """Synchronous bucketed inference; thread-safe. `deadline` is a
        per-request budget in seconds."""
        x = np.asarray(x, self.dtype)
        if x.shape[1:] != self.input_shape:
            raise ValueError(
                f"serving[{self.name}]: request shape {x.shape[1:]} does "
                f"not match model input {self.input_shape}")
        if x.shape[0] == 0:
            raise ValueError(
                f"serving[{self.name}]: empty request (0 examples)")
        if self._draining.is_set() or self._stop.is_set():
            raise ServerDrainingError(
                f"serving[{self.name}] is shutting down")
        req = _Request(x, None if deadline is None
                       else time.monotonic() + deadline)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            monitor.counter("serving_rejected_total",
                            "Requests rejected by admission control",
                            labels=("model", "reason")).inc(
                model=self.name, reason="queue_full")
            raise ServerOverloadedError(
                f"serving[{self.name}]: request queue full "
                f"({self._queue.maxsize} pending)") from None
        monitor.gauge("serving_queue_depth", "Queued serving requests",
                      labels=("model",)).set(self._queue.qsize(),
                                             model=self.name)
        wait = timeout if deadline is None else min(timeout, deadline + 1.0)
        if not req.event.wait(wait):
            req.error = req.error or DeadlineExceededError(
                f"serving[{self.name}]: no result within {wait:.1f}s")
            raise req.error
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------- worker
    def _coalesce(self, first: _Request):
        """Gather queued requests behind `first` until the max bucket is
        filled or the coalescing deadline from first-arrival passes."""
        reqs, total = [first], first.x.shape[0]
        deadline = time.monotonic() + self.max_delay
        while total < self.buckets[-1]:
            remaining = deadline - time.monotonic()
            try:
                nxt = self._queue.get(timeout=remaining) if remaining > 0 \
                    else self._queue.get_nowait()
            except queue.Empty:
                break
            reqs.append(nxt)
            total += nxt.x.shape[0]
        return reqs

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._draining.is_set():
                    break
                continue
            reqs = self._coalesce(first)
            now = time.monotonic()
            live = []
            for r in reqs:
                if r.deadline is not None and now > r.deadline:
                    monitor.counter("serving_rejected_total",
                                    "Requests rejected by admission control",
                                    labels=("model", "reason")).inc(
                        model=self.name, reason="deadline")
                    r.error = DeadlineExceededError(
                        f"serving[{self.name}]: deadline expired after "
                        f"{now - r.enqueued:.3f}s in queue")
                    r.event.set()
                else:
                    live.append(r)
            if not live:
                continue
            if monitor.tracing_enabled():
                # per-request queue-wait spans, recorded on behalf of the
                # submitting threads (their ctx, this thread's track)
                dispatch_pc = time.perf_counter()
                for r in live:
                    monitor.add_span("serving/queue_wait", r.t0,
                                     dispatch_pc, ctx=r.ctx,
                                     model=self.name)
            if flight.enabled():
                for r in live:
                    flight.note(r.ctx, "dispatch",
                                wait_ms=round(
                                    (now - r.enqueued) * 1e3, 3),
                                coalesced=len(live), model=self.name)
            try:
                batch = np.concatenate([r.x for r in live], axis=0) \
                    if len(live) > 1 else live[0].x
                monitor.histogram(
                    "serving_batch_size",
                    "Coalesced serving batch sizes (pre-padding examples)",
                    labels=("model",),
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                ).observe(batch.shape[0], model=self.name)
                n, padded, ofs = batch.shape[0], 0, 0
                while ofs < n:          # chunks mirror _run_bucketed
                    take = min(n - ofs, self.buckets[-1])
                    padded += self.bucket_for(take)
                    ofs += take
                monitor.histogram(
                    "serving_batch_pad_fraction",
                    "Padding waste per device batch (padded/real - 1)",
                    labels=("model",),
                    buckets=(0.0, 0.1, 0.25, 0.5, 1.0, 3.0, 7.0)
                ).observe(padded / n - 1.0, model=self.name)
                # bind the FIRST coalesced request's context to this
                # worker for the batch extent: the batch span, the ledger
                # capture inside the runner, and any first-use note all
                # land under one trace_id (the others are linked through
                # their queue_wait spans above)
                with monitor.bind_context(live[0].ctx):
                    with monitor.span("serving/batch", model=self.name,
                                      n=int(batch.shape[0]),
                                      requests=len(live)):
                        out = self._run_bucketed(batch)
                ofs = 0
                for r in live:
                    r.result = out[ofs:ofs + r.x.shape[0]]
                    ofs += r.x.shape[0]
            except Exception as e:      # noqa: BLE001 — surface to waiters
                for r in live:
                    r.error = e
            finally:
                for r in live:
                    r.event.set()
            monitor.gauge("serving_queue_depth", "Queued serving requests",
                          labels=("model",)).set(self._queue.qsize(),
                                                 model=self.name)
        # drain leftovers so no caller blocks forever
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.error = ServerDrainingError(f"serving[{self.name}] shut down")
            r.event.set()

    # --------------------------------------------------------------- admin
    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting new requests, flush everything queued, stop the
        worker. Returns True when the queue emptied in time."""
        self._draining.set()
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        flushed = self._queue.empty()
        self._stop.set()
        self._worker.join(timeout=max(0.1, deadline - time.monotonic()))
        return flushed

    def shutdown(self):
        self._stop.set()
        self._draining.set()
        self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
