"""Goodput ledger — wall-clock attribution for training (and decode).

`examples_per_sec` answers "how fast"; this module answers "where did
the time go". A `GoodputLedger` consumes the span stream the fit loops
already emit (`train/etl`, `train/host_sync`, `xla/compile`, the
resilience checkpoint spans, plus the emission points this module
added: `train/device_wait`, `train/resume_replay`,
`resilience/eval_gate`) and attributes every wall-clock second of a
`fit()` to exactly ONE of a closed category set:

==============  ======================================================
category        meaning
==============  ======================================================
step_compute    device executing the compiled step (the goodput)
data_wait       blocked on the ETL/input pipeline (`train/etl`)
host_sync       the deliberate loss fetch's D2H transfer + Python
compile         a step program's capture: the eager first step plus the
                CUDA graph capture, or a kernel's nvcc build (`xla/compile`)
checkpoint      checkpoint save/restore IO
eval_gate       blessing-gate evaluation between checkpoints
resume_replay   fast-forwarding an iterator after preempt->resume
other           everything unattributed (framework overhead, listener
                callbacks, logging, ...)
==============  ======================================================

Exclusivity is the contract: the categories of a finished session sum
to its measured wall-clock exactly (`other` is defined as the
remainder). A chunk's `train/dispatch` or `train/chunk_sync` span, or a
capture's `xla/compile` span, can contain another attributed span (an
`xla/compile` capture inside the first dispatch, an nvcc build inside
the capture): such a container banks only its extent less the spans it
contains (`_CONTAINERS`), so no second is attributed twice.

Zero-cost-when-disabled follows `span()`/flight: while disabled the fit
loops' `add_span()` calls keep their original single-flag fast path and
`device_wait()` returns at once (the fit's loss fetch is its sync). Enabling
installs the ledger as the trace-module span sink, so attribution works
whether or not tracing itself is on.

Extras carried by the ledger:

- live `train_goodput_pct` gauge + `train_time_seconds_total{category}`
  counters, and a per-session summary in `FitReport`
  (`goodput_pct`, `time_by_category`);
- a per-step anomaly detector — rolling median/MAD over the
  step-to-step wall spacing; a spike fires
  `flight.trip("step_time_anomaly")` with a postmortem naming the
  dominant category, step index and trace id (plus the all-thread
  stack snapshot trip() attaches);
- `train/barrier_wait` spans bank as
  `train_barrier_wait_seconds_total` (straggler time, reported beside
  the closed partition, not inside it); the port runs one device per
  fit and emits none itself;
- a decode-side split for the scheduler loop:
  `serving_decode_time_seconds_total{model,category}` over
  ``admission`` / ``step_compute`` / ``page_stall`` / ``idle``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from deeplearning4j_tpu_torch.monitor import metrics, trace

#: the closed partition every attributed second falls into
CATEGORIES = ("step_compute", "data_wait", "host_sync", "compile",
              "checkpoint", "eval_gate", "resume_replay", "other")

#: span name -> category: the consumed stream. `train/step` is handled
#: specially (its residual after contained child spans is step_compute)
#: and `train/barrier_wait` banks outside the partition.
SPAN_CATEGORY = {
    "train/etl": "data_wait",
    "train/device_wait": "step_compute",
    "train/dispatch": "step_compute",
    "train/chunk_sync": "step_compute",
    "train/host_sync": "host_sync",
    "xla/compile": "compile",
    "resilience/checkpoint_save": "checkpoint",
    "resilience/checkpoint_restore": "checkpoint",
    "resilience/eval_gate": "eval_gate",
    "train/resume_replay": "resume_replay",
}

#: spans that may enclose other attributed spans of the same thread
_CONTAINERS = frozenset(("train/dispatch", "train/chunk_sync", "xla/compile"))

_TIME_HELP = ("Attributed fit() wall-clock seconds per goodput "
              "category (docs/OBSERVABILITY.md 'Goodput accounting')")
_PCT_HELP = ("Share of fit() wall-clock spent in device step compute "
             "(live during a session, final value at session end)")

_enabled = False
_ledger: Optional["GoodputLedger"] = None


def _cat_counter():
    return metrics.counter("train_time_seconds_total", _TIME_HELP,
                           labels=("category",))


class _Session:
    """One fit()'s accounting state. Touched only from the fit thread
    (the sink filters on `tid`), except the swap in/out under the
    ledger lock."""

    __slots__ = ("kind", "tid", "t0", "categories", "buffer",
                 "barrier_wait_s", "steps", "anomalies", "prev_step_end",
                 "iter_walls", "cat_mark", "last_anomaly_step", "ctx",
                 "_binder")

    def __init__(self, kind: str, clock_now: float, window: int):
        self.kind = kind
        self.tid = threading.get_ident()
        self.t0 = clock_now
        self.categories: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.buffer = []              # (t0, t1, dur) since last step
        self.barrier_wait_s = 0.0
        self.steps = 0
        self.anomalies = 0
        self.prev_step_end: Optional[float] = None
        self.iter_walls: deque = deque(maxlen=window)
        self.cat_mark: Dict[str, float] = dict(self.categories)
        self.last_anomaly_step = -10**9
        self.ctx = None
        self._binder = None


def _median(values) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class GoodputLedger:
    """Span-stream consumer + per-fit session accounting. One instance
    is installed process-wide by `enable_goodput()`; `on_span` runs
    inline on every span boundary, so it must stay cheap (two dict
    lookups and a float add on the common path)."""

    def __init__(self, window: int = 64, warmup_steps: int = 16,
                 mad_k: float = 6.0, anomaly_min_s: float = 0.02,
                 anomaly_min_ratio: float = 2.0,
                 anomaly_cooldown_steps: int = 32,
                 clock=time.perf_counter):
        self.window = int(window)
        self.warmup_steps = int(warmup_steps)
        self.mad_k = float(mad_k)
        self.anomaly_min_s = float(anomaly_min_s)
        self.anomaly_min_ratio = float(anomaly_min_ratio)
        self.anomaly_cooldown_steps = int(anomaly_cooldown_steps)
        self.clock = clock
        self._lock = threading.Lock()
        self._session: Optional[_Session] = None
        self._last_summary: Optional[dict] = None
        self._decode_totals: Dict[tuple, float] = {}

    # ------------------------------------------------------ sessions
    def fit_begin(self, kind: str = "train") -> Optional[_Session]:
        """Open a session on the calling thread. Returns the token
        `fit_end` takes — None when a session is already active (nested
        fits: the outer one owns the wall-clock)."""
        with self._lock:
            if self._session is not None:
                return None
            s = _Session(kind, self.clock(), self.window)
            self._session = s
        # label the whole fit with a trace id so the anomaly postmortem,
        # the Perfetto trace and the flight ring all name one session —
        # only when something downstream records it (zero-cost contract)
        from deeplearning4j_tpu_torch.monitor import flight
        if trace.tracing_enabled() or flight.enabled():
            ctx = trace.current_context()
            if ctx is None:
                ctx = trace.mint_context()
                s._binder = trace.bind_context(ctx)
                s._binder.__enter__()
            s.ctx = ctx
        return s

    def fit_end(self, session: Optional[_Session]) -> Optional[dict]:
        """Close a session token: computes `other` as the unattributed
        remainder (the exclusivity contract), publishes the final gauge,
        and returns the summary dict. None-safe (nested/disabled)."""
        if session is None:
            return None
        t1 = self.clock()
        with self._lock:
            if self._session is not session:
                return None
            self._session = None
        if session._binder is not None:
            session._binder.__exit__(None, None, None)
        wall = max(t1 - session.t0, 0.0)
        attributed = sum(session.categories.values())
        other = max(wall - attributed, 0.0)
        if other > 0.0:
            session.categories["other"] += other
            _cat_counter().inc(other, category="other")
        pct = (100.0 * session.categories["step_compute"] / wall
               if wall > 0 else 0.0)
        metrics.gauge("train_goodput_pct", _PCT_HELP).set(round(pct, 3))
        summary = {
            "kind": session.kind,
            "wall_s": round(wall, 6),
            "categories": {k: round(v, 6)
                           for k, v in session.categories.items()},
            "goodput_pct": round(pct, 2),
            "steps": session.steps,
            "anomalies": session.anomalies,
            "barrier_wait_s": round(session.barrier_wait_s, 6),
            "trace_id": session.ctx.trace_id if session.ctx else None,
        }
        self._last_summary = summary
        return summary

    def last_session(self) -> Optional[dict]:
        return self._last_summary

    # ------------------------------------------------------ span sink
    def on_span(self, name: str, t0: float, t1: float, attrs: dict):
        s = self._session
        if s is None or threading.get_ident() != s.tid:
            return
        dur = t1 - t0
        if dur < 0.0:
            return
        if name == "train/step":
            self._on_step(s, t0, t1, dur, attrs)
            return
        if name == "train/barrier_wait":
            s.barrier_wait_s += dur
            metrics.counter(
                "train_barrier_wait_seconds_total",
                "Per-step spread between the first and last shard "
                "finishing under a multi-device plan (straggler time; "
                "reported beside the goodput partition, not inside "
                "it)").inc(dur)
            return
        cat = SPAN_CATEGORY.get(name)
        if cat is None:
            return
        entry = (t0, t1, dur)
        if name in _CONTAINERS:
            eps = 1e-9
            inner = [e for e in s.buffer
                     if e[0] >= t0 - eps and e[1] <= t1 + eps]
            if inner:
                # the container's entry stands for its whole extent in a
                # later step's residual; it banks only what its children
                # did not
                s.buffer = [e for e in s.buffer if e not in inner]
                dur = max(dur - sum(e[2] for e in inner), 0.0)
        s.categories[cat] += dur
        s.buffer.append(entry)
        _cat_counter().inc(dur, category=cat)

    def _on_step(self, s: _Session, t0: float, t1: float, dur: float,
                 attrs: dict):
        # residual: the step extent minus the child spans it contains
        # (device_wait/host_sync/dispatch...) is device execution the
        # loop didn't bracket separately -> step_compute
        eps = 1e-9
        contained = sum(d for (c0, c1, d) in s.buffer
                        if c0 >= t0 - eps and c1 <= t1 + eps)
        s.buffer.clear()
        residual = max(dur - contained, 0.0)
        if residual > 0.0:
            s.categories["step_compute"] += residual
            _cat_counter().inc(residual, category="step_compute")
        s.steps += 1
        # iteration wall: spacing between consecutive step ENDS — it
        # covers the inter-step gap (ETL, checkpoints), so a stall
        # anywhere in the loop surfaces, not just a slow step
        iter_wall = (t1 - s.prev_step_end
                     if s.prev_step_end is not None else dur)
        s.prev_step_end = t1
        deltas = {k: s.categories[k] - s.cat_mark[k]
                  for k in s.categories}
        s.cat_mark = dict(s.categories)
        wall = t1 - s.t0
        if wall > 0:
            metrics.gauge("train_goodput_pct", _PCT_HELP).set(
                round(100.0 * s.categories["step_compute"] / wall, 3))
        self._check_anomaly(s, iter_wall, deltas, attrs)
        s.iter_walls.append(iter_wall)   # after the check: a spike must
        #                                  not raise its own baseline

    def _check_anomaly(self, s: _Session, iter_wall: float,
                       deltas: Dict[str, float], attrs: dict):
        hist = s.iter_walls
        if len(hist) < self.warmup_steps:
            return
        med = _median(hist)
        mad = _median([abs(x - med) for x in hist])
        threshold = max(med + self.mad_k * 1.4826 * mad,
                        med * self.anomaly_min_ratio,
                        self.anomaly_min_s)
        if iter_wall <= threshold:
            return
        if s.steps - s.last_anomaly_step < self.anomaly_cooldown_steps:
            return
        s.last_anomaly_step = s.steps
        s.anomalies += 1
        metrics.counter(
            "train_step_anomalies_total",
            "Step-time spikes caught by the rolling median/MAD "
            "detector (each fires a step_time_anomaly postmortem when "
            "the flight recorder is on)").inc()
        # the interval's dominant category names the suspect; when the
        # unattributed remainder dominates, say "other" honestly
        dominant = max(deltas, key=deltas.get)
        unattributed = iter_wall - sum(deltas.values())
        if unattributed > deltas[dominant]:
            dominant, dom_s = "other", unattributed
        else:
            dom_s = deltas[dominant]
        from deeplearning4j_tpu_torch.monitor import flight
        flight.trip(
            "step_time_anomaly",
            step=attrs.get("iteration", attrs.get("step", s.steps)),
            iteration_wall_s=round(iter_wall, 6),
            median_s=round(med, 6),
            threshold_s=round(threshold, 6),
            dominant_category=dominant,
            dominant_seconds=round(dom_s, 6),
            trace_id=s.ctx.trace_id if s.ctx else None)

    # ------------------------------------------------------ live view
    def live_stats(self) -> Optional[dict]:
        """Goodput% + dominant stall of the ACTIVE session — what
        PerformanceListener prints beside examples/sec. Reads and
        publishes through the same accumulators as `/metrics`, so the
        log line and the gauge cannot disagree."""
        s = self._session
        if s is None:
            return None
        wall = self.clock() - s.t0
        if wall <= 0:
            return None
        cats = dict(s.categories)
        cats["other"] += max(wall - sum(cats.values()), 0.0)
        pct = round(100.0 * cats["step_compute"] / wall, 2)
        stall = max((k for k in cats if k != "step_compute"),
                    key=lambda k: cats[k])
        metrics.gauge("train_goodput_pct", _PCT_HELP).set(pct)
        return {"goodput_pct": pct, "dominant_stall": stall,
                "stall_seconds": round(cats[stall], 6)}

    # ------------------------------------------------------ decode
    def decode_note(self, model: str, category: str, seconds: float):
        """Bank scheduler-loop seconds for one decode category
        (``admission`` / ``step_compute`` / ``page_stall`` / ``idle``)."""
        if seconds <= 0.0:
            return
        key = (model, category)
        with self._lock:
            self._decode_totals[key] = \
                self._decode_totals.get(key, 0.0) + seconds
        metrics.counter(
            "serving_decode_time_seconds_total",
            "Decode scheduler-loop wall-clock split per model: engine "
            "step compute vs page-stall slot time vs admission vs "
            "idle", labels=("model", "category")).inc(
            seconds, model=model, category=category)

    def decode_totals(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for (model, cat), secs in self._decode_totals.items():
                out.setdefault(model, {})[cat] = round(secs, 6)
            return out


# ---------------------------------------------------------- module API
def enable_goodput(**knobs) -> GoodputLedger:
    """Install a fresh ledger as the span sink (idempotent with the
    same effect: a new ledger replaces the old). Knobs forward to
    `GoodputLedger` (window, warmup_steps, mad_k, anomaly_min_s,
    anomaly_min_ratio, anomaly_cooldown_steps, clock)."""
    global _enabled, _ledger
    _ledger = GoodputLedger(**knobs)
    trace.set_span_sink(_ledger.on_span)
    _enabled = True
    return _ledger


def disable_goodput():
    global _enabled, _ledger
    trace.set_span_sink(None)
    _enabled = False
    _ledger = None


def goodput_enabled() -> bool:
    return _enabled


def ledger() -> Optional[GoodputLedger]:
    return _ledger


def fit_begin(kind: str = "train"):
    """Session open for the fit loops: None (no-op token) while
    disabled or when an outer session already owns the wall-clock."""
    led = _ledger
    if led is None:
        return None
    return led.fit_begin(kind)


def fit_end(session) -> Optional[dict]:
    led = _ledger
    if led is None or session is None:
        return None
    return led.fit_end(session)


def last_session() -> Optional[dict]:
    led = _ledger
    return led.last_session() if led is not None else None


def live_stats() -> Optional[dict]:
    led = _ledger
    return led.live_stats() if led is not None else None


def decode_note(model: str, category: str, seconds: float):
    led = _ledger
    if led is not None:
        led.decode_note(model, category, seconds)


def decode_totals() -> Dict[str, Dict[str, float]]:
    led = _ledger
    return led.decode_totals() if led is not None else {}


def device_wait(value):
    """Wait until the work that produces `value` (a CUDA tensor) has run,
    WITHOUT transferring it: the per-call fit calls this right before its
    one budgeted `float(loss)`, so the ledger can split device execution
    (`train/device_wait` -> step_compute) from the narrow D2H fetch
    (`train/host_sync`). The wait is on a CUDA event recorded behind the
    step on the tensor's stream, where the reference calls
    `block_until_ready()`; the fetch that follows then finds the device
    done, so the fit waits on the device no more often than before.

    While the ledger is off, or no session is active, this returns at
    once (no event, no wait: the fetch itself is the sync); host values
    and CPU tensors pass through untouched. The port runs one device per
    fit, so there is no per-shard barrier wait to bank."""
    led = _ledger
    if led is None or led._session is None \
            or not getattr(value, "is_cuda", False):
        return value
    import torch
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(value.device))
    ev.synchronize()
    return value
