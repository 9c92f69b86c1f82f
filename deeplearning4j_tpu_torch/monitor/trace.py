"""Trace half of the telemetry subsystem (see monitor/__init__.py).

`span("name", **attrs)` is a context manager that records one complete
event per dynamic extent — thread-aware, nestable, exported as Chrome
trace-event JSON that Perfetto / chrome://tracing load directly. Use it
to see WHERE a training step's wall time goes: the fit loops bracket the
compiled step and the loss host-sync, the prefetch worker brackets ETL,
ResilientTrainer brackets checkpoint IO, ParallelInference brackets
batches — all on their own thread tracks.

Zero-cost-when-disabled is the hard requirement: tracing is off by
default, `span()` then returns a shared no-op context manager (no
allocation, no clock read, no lock), and `add_span()` returns
immediately. Enabling costs two `perf_counter_ns` reads and one
lock-guarded list append per span — still no device->host syncs, so the
jitted fast path is untouched either way.

Optionally (`enable_tracing(profiler_ranges=True)`, the counterpart of
the JAX package's ``jax_annotations=True``) each span also enters a
`torch.profiler.record_function` and an NVTX range
(`torch.cuda.nvtx.range_push` / `range_pop`), so the same names show up
in a `torch.profiler` trace and in an Nsight Systems timeline. Both are
host-side calls around the step: a CUDA graph replays without them, so
the fit loops open them around a replay, never inside a capture. torch
is imported only when this flag is set (the module itself imports no
torch: spawned ETL workers load it).

**Cross-process trace context** (docs/OBSERVABILITY.md "Tracing a
single request"): a `TraceContext` is a W3C-``traceparent``-shaped
(trace_id, span_id, parent_id) triple. The serving ingress mints one per
request (or adopts the caller's ``traceparent`` header), forwards it on
every hop as an HTTP header, and binds it to the handling thread with
`bind_context` — every span recorded while a context is bound carries
its ``trace_id`` in the event args, so one id stitches router, replica,
batcher and decode-scheduler spans across processes
(`tools/trace_report.py` merges the per-process files). Context
binding follows the same zero-cost contract as `span()`: while tracing
(and the flight recorder) are disabled no context exists, nothing is
allocated, and `bind_context(None)` is a no-op.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

_lock = threading.Lock()
_events: List[dict] = []
_thread_names: dict = {}
_enabled = False
_profiler_ranges = False
_MAX_EVENTS = 1_000_000          # runaway-loop backstop (~hundreds of MB)

#: optional live consumer of the span stream: fn(name, t0_s, t1_s, attrs).
#: The goodput ledger installs itself here so wall-clock attribution works
#: with tracing off — while BOTH are disabled span()/add_span() stay on the
#: original zero-cost path (one extra None check).
_span_sink = None

#: the header every serving hop forwards (W3C trace-context shape)
TRACEPARENT_HEADER = "traceparent"

_tls = threading.local()         # .ctx: the thread's current TraceContext


class TraceContext:
    """One request's identity across processes: ``trace_id`` names the
    whole request, ``span_id`` this process segment, ``parent_id`` the
    segment that forwarded it (None at the origin)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """Same trace, fresh segment id, parented to this one — what a
        hop binds locally after adopting an incoming header."""
        return TraceContext(self.trace_id, os.urandom(8).hex(),
                            self.span_id)

    def header(self) -> str:
        """``traceparent`` wire form: 00-<trace_id>-<span_id>-01."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent={self.parent_id!r})")


def mint_context() -> TraceContext:
    """A fresh root context (new trace_id) — the ingress of a request
    that arrived without a ``traceparent`` header."""
    return TraceContext(os.urandom(16).hex(), os.urandom(8).hex())


_HEX = frozenset("0123456789abcdef")


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """``00-<32 hex>-<16 hex>-<flags>`` -> TraceContext, or None for
    anything malformed / absent / all-zero (per the W3C rules a zero id
    is invalid — treat it as no context and mint fresh). Strict hex
    check: ``int(x, 16)`` would accept underscores/signs/whitespace and
    re-emit an invalid header downstream."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    tid, sid = parts[1].lower(), parts[2].lower()
    if len(tid) != 32 or len(sid) != 16:
        return None
    if not (set(tid) <= _HEX and set(sid) <= _HEX):
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return TraceContext(tid, sid)


def current_context() -> Optional[TraceContext]:
    """The context bound to this thread, or None."""
    return getattr(_tls, "ctx", None)


class bind_context:
    """Install `ctx` as the thread's current trace context for the
    extent of the ``with`` block (restores the previous one on exit).
    ``bind_context(None)`` is a no-op passthrough, so call sites never
    branch on whether a request carries a context."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        if self.ctx is not None:
            _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


class _NullSpan:
    """Stateless reusable no-op: what span() hands out while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0", "_ann", "_ctx")

    def __init__(self, name: str, args: dict, ctx=None):
        self.name = name
        self.args = args
        self._ann = None
        self._ctx = ctx

    def __enter__(self):
        if _profiler_ranges:
            self._ann = _ProfilerRange(self.name)
            self._ann.__enter__()
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        _record(self.name, self.t0, t1, self.args, ctx=self._ctx)
        sink = _span_sink
        if sink is not None:
            sink(self.name, self.t0 / 1e6, t1 / 1e6, self.args)
        return False


class _ProfilerRange:
    """One span's mirror in the torch profiler and NVTX. Best effort: a
    profiler failure must never break the traced code path."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        try:
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        except Exception:                 # noqa: BLE001 — best effort
            self._rf = None
        return self

    def __exit__(self, *exc):
        try:
            if self._nvtx:
                import torch
                torch.cuda.nvtx.range_pop()
            if self._rf is not None:
                self._rf.__exit__(*exc)
        except Exception:                 # noqa: BLE001 — best effort
            pass
        return False


class _SinkSpan:
    """What span() hands out while tracing is off but a span sink (the
    goodput ledger) is installed: times the extent with the same clock as
    `_Span` and feeds only the sink — no event buffer, no lock."""

    __slots__ = ("name", "args", "t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sink = _span_sink
        if sink is not None:
            sink(self.name, self.t0, time.perf_counter(), self.args)
        return False


def _record(name: str, t0_us: float, t1_us: float, args: dict, ctx=None):
    tid = threading.get_ident()
    ev = {"name": name, "ph": "X", "ts": t0_us,
          "dur": max(t1_us - t0_us, 0.0), "pid": os.getpid(), "tid": tid}
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
    if args or ctx is not None:
        a = ev["args"] = {k: _jsonable(v) for k, v in args.items()} \
            if args else {}
        if ctx is not None:
            a.setdefault("trace_id", ctx.trace_id)
            a.setdefault("ctx_span", ctx.span_id)
    tname = threading.current_thread().name
    dropped = False
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            dropped = True
        else:
            _events.append(ev)
            _thread_names[tid] = tname
    if dropped:
        from deeplearning4j_tpu_torch.monitor import metrics
        metrics.counter(
            "trace_spans_dropped_total",
            "Spans discarded after the in-memory event buffer filled "
            "(save_trace/clear_trace to reclaim)").inc()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span(name: str, ctx: Optional[TraceContext] = None, **attrs):
    """Context manager timing one dynamic extent. No-op (shared null
    object) while tracing is disabled. `ctx` overrides the thread-bound
    trace context (for recording on behalf of another thread's
    request); by default the bound context, if any, is attached."""
    if not _enabled:
        if _span_sink is not None:
            return _SinkSpan(name, attrs)
        return _NULL
    return _Span(name, attrs, ctx)


def add_span(name: str, start_s: float, end_s: float,
             ctx: Optional[TraceContext] = None, **attrs):
    """Record a complete event from `time.perf_counter()` stamps already
    taken — for loops that measure a phase anyway (ETL timers in the fit
    loops) and shouldn't pay a second pair of clock reads."""
    sink = _span_sink
    if sink is not None:
        sink(name, start_s, end_s, attrs)
    if not _enabled:
        return
    _record(name, start_s * 1e6, end_s * 1e6, attrs, ctx=ctx)


def instant(name: str, ctx: Optional[TraceContext] = None, **attrs):
    """Record an instant event (a point mark: preemption, resume, skip)."""
    if not _enabled:
        return
    tid = threading.get_ident()
    ev = {"name": name, "ph": "i", "ts": _now_us(), "pid": os.getpid(),
          "tid": tid, "s": "t"}
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
    if attrs or ctx is not None:
        a = ev["args"] = {k: _jsonable(v) for k, v in attrs.items()} \
            if attrs else {}
        if ctx is not None:
            a.setdefault("trace_id", ctx.trace_id)
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
            _thread_names[tid] = threading.current_thread().name


def enable_tracing(profiler_ranges: bool = False):
    """Start recording spans (idempotent). `profiler_ranges=True` (the
    JAX package's ``jax_annotations=True``) additionally mirrors every
    span into `torch.profiler.record_function` and an NVTX range, so
    device profiles captured alongside carry the same names."""
    global _enabled, _profiler_ranges
    _profiler_ranges = bool(profiler_ranges)
    _enabled = True


def disable_tracing():
    global _enabled, _profiler_ranges
    _enabled = False
    _profiler_ranges = False


def tracing_enabled() -> bool:
    return _enabled


def set_span_sink(sink) -> None:
    """Install (or, with None, remove) the live span consumer — called
    through `goodput.enable_goodput()` / `disable_goodput()`, not
    directly. At most one sink exists; it must be cheap and exception-free
    (it runs inline on every span boundary)."""
    global _span_sink
    _span_sink = sink


def clear_trace():
    with _lock:
        _events.clear()
        _thread_names.clear()


def trace_events() -> List[dict]:
    """Copy of the recorded events (Chrome trace-event dicts)."""
    with _lock:
        return list(_events)


def save_trace(path: str, clear: bool = True) -> int:
    """Write the recorded events as a Chrome trace-event JSON file
    (object form, with thread-name metadata so Perfetto labels tracks).
    Returns the number of events written; `clear` drops them after."""
    with _lock:
        events = list(_events)
        names = dict(_thread_names)
        if clear:
            _events.clear()
    meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
             "tid": tid, "args": {"name": tname}}
            for tid, tname in sorted(names.items())]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(events)
