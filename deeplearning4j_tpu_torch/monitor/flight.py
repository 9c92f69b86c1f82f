"""Per-request flight recorder + SLO-breach postmortems.

The trace buffer (monitor/trace.py) answers "where did the time go"
when someone *planned* to look; this module is the black box that is
already recording when something goes wrong. A bounded ring holds a
structured timeline per request/stream — admission wait, bucket,
compile-ledger hit, page stalls, the engine generation that served it,
hedges/failovers, finish reason — keyed by the request's trace_id, so a
flight record, the merged Perfetto trace, and a latency-histogram
exemplar all name the same request.

Three surfaces:

- ``GET /v1/debug/flight`` on every serving process returns
  `snapshot()` (the ring + still-open records); the fleet router
  aggregates its own snapshot with every healthy replica's.
- `trip(reason, ...)` is the SLO hook: a 5xx, an opened circuit
  breaker, a wedge detection, or a p99 breach dumps the current ring as
  a postmortem JSON (rate-limited per reason) into the configured
  directory — serve_chaos and the fleet supervisor become
  self-documenting.
- `request_context()` is the serving ingress helper that adopts the
  caller's ``traceparent`` header or mints a fresh context — and
  returns None, allocating nothing, while both tracing and the flight
  recorder are disabled.

Zero-cost-when-disabled is the same hard contract `span()` carries (and
graftlint's telemetry-zero-cost rule enforces for `flight.*` calls in
compiled regions): every entry point returns immediately on the module
flag, `begin()` hands back None, and `note(None, ...)`/`finish(None)`
are no-ops — the request path allocates nothing until an operator turns
the recorder on (the serving CLI enables it by default; the training
library never does).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.monitor import metrics, trace

_lock = threading.Lock()
_enabled = False
_capacity = 256
_ring: deque = deque(maxlen=256)           # finished records
_live: Dict[str, List[dict]] = {}          # trace_id -> open records
_dump_dir: Optional[str] = None
_last_trip: Dict[str, float] = {}          # reason -> monotonic stamp
_postmortems: deque = deque(maxlen=8)      # recent postmortem docs
_MAX_EVENTS_PER_RECORD = 128               # one stuck stream can't flood
_TRIP_COOLDOWN_S = 10.0
_SNAPSHOT_MAX_THREADS = 32                 # stack-snapshot bounds: a
_SNAPSHOT_MAX_FRAMES = 20                  # postmortem stays a few KB

#: latency families whose trace_id exemplars ride along in snapshot()
EXEMPLAR_FAMILIES = ("serving_request_seconds",
                     "serving_router_request_seconds",
                     "serving_decode_ttft_seconds",
                     "serving_decode_inter_token_seconds")


def enable_flight(capacity: int = 256, dump_dir: Optional[str] = None,
                  trip_cooldown_s: float = 10.0):
    """Start recording (idempotent). `capacity` bounds the finished-
    record ring; `dump_dir` (created on demand) receives postmortem
    JSONs from trip() — without it postmortems stay in memory only."""
    global _enabled, _capacity, _ring, _dump_dir, _TRIP_COOLDOWN_S
    with _lock:
        _capacity = max(1, int(capacity))
        if _ring.maxlen != _capacity:
            _ring = deque(_ring, maxlen=_capacity)
        _dump_dir = dump_dir
        _TRIP_COOLDOWN_S = float(trip_cooldown_s)
        _enabled = True


def disable_flight():
    global _enabled
    with _lock:
        _enabled = False
        _live.clear()


def enabled() -> bool:
    return _enabled


def clear():
    """Drop every record and postmortem (tests)."""
    with _lock:
        _ring.clear()
        _live.clear()
        _postmortems.clear()
        _last_trip.clear()


def request_context(traceparent: Optional[str],
                    component: str) -> Optional[trace.TraceContext]:
    """Serving-ingress context: adopt the caller's ``traceparent``
    (child segment, parent preserved) or mint a fresh root. Returns
    None — no allocation, no metric — while both tracing and the flight
    recorder are disabled (the zero-cost contract's ingress half)."""
    if not (_enabled or trace.tracing_enabled()):
        return None
    ctx = trace.parse_traceparent(traceparent)
    if ctx is not None:
        metrics.counter("trace_contexts_adopted_total",
                        "Request contexts adopted from an incoming "
                        "traceparent header", labels=("component",)).inc(
            component=component)
        return ctx.child()
    metrics.counter("trace_contexts_minted_total",
                    "Fresh request trace contexts minted at an ingress",
                    labels=("component",)).inc(component=component)
    return trace.mint_context()


def _trace_id(ctx) -> Optional[str]:
    if ctx is None:
        return None
    return ctx.trace_id if isinstance(ctx, trace.TraceContext) else str(ctx)


def begin(ctx, kind: str, **meta) -> Optional[dict]:
    """Open a record for one request/stream; returns the handle the
    SAME layer later passes to finish() (other layers annotate by
    context via note()). None (and nothing recorded) while disabled."""
    if not _enabled:
        return None
    tid = _trace_id(ctx)
    if tid is None:
        return None
    rec = {"trace_id": tid, "kind": kind, "pid": os.getpid(),
           "start_unix": round(time.time(), 6),
           "t0": time.perf_counter(), "events": []}
    rec.update({k: v for k, v in meta.items() if v is not None})
    dropped = 0
    with _lock:
        _live.setdefault(tid, []).append(rec)
        # open records are bounded too: a caller that never finishes
        # (crash between begin and finally) must not leak the map.
        # Evict OLDEST first (insertion order), never the record just
        # opened.
        while len(_live) > _capacity:
            stale = _live.pop(next(iter(_live)))
            dropped += len(stale)
    if dropped:
        metrics.counter("serving_flight_dropped_total",
                        "Flight records evicted before finishing "
                        "(open-record bound exceeded)").inc(dropped)
    metrics.counter("serving_flight_records_total",
                    "Flight-recorder records opened per request kind",
                    labels=("kind",)).inc(kind=kind)
    return rec


def note(ctx, event: str, **fields):
    """Append a timeline event to every open record of this request
    (the batcher/scheduler annotating the record the HTTP layer
    opened). No-op while disabled or without a context."""
    if not _enabled:
        return
    tid = _trace_id(ctx)
    if tid is None:
        return
    now = time.perf_counter()
    with _lock:
        recs = _live.get(tid)
        if not recs:
            return
        for rec in recs:
            evs = rec["events"]
            if len(evs) >= _MAX_EVENTS_PER_RECORD:
                rec["events_dropped"] = rec.get("events_dropped", 0) + 1
                continue
            ev = {"t_ms": round((now - rec["t0"]) * 1e3, 3),
                  "event": event}
            ev.update(fields)
            evs.append(ev)


def finish(rec: Optional[dict], outcome: str, **fields):
    """Close a record handle from begin(): stamp the outcome + duration
    and move it to the ring. None-safe."""
    if rec is None or not _enabled:
        return
    rec["outcome"] = outcome
    rec["duration_ms"] = round(
        (time.perf_counter() - rec.pop("t0", time.perf_counter())) * 1e3, 3)
    rec.update({k: v for k, v in fields.items() if v is not None})
    with _lock:
        recs = _live.get(rec["trace_id"])
        if recs is not None:
            try:
                recs.remove(rec)
            except ValueError:
                pass
            if not recs:
                _live.pop(rec["trace_id"], None)
        _ring.append(rec)


def _strip_open(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k != "t0"}
    out["open"] = True
    out["age_ms"] = round((time.perf_counter() - rec["t0"]) * 1e3, 3)
    return out


def snapshot(limit: Optional[int] = None) -> dict:
    """The debug-endpoint payload: finished ring (newest last), open
    records, recent postmortem summaries, and the latency-histogram
    trace_id exemplars that link a p99 bucket to a record here."""
    with _lock:
        finished = list(_ring)
        live = [_strip_open(r) for rs in _live.values() for r in rs]
        pms = [{k: pm[k] for k in ("reason", "dumped_unix", "meta",
                                   "n_records")} for pm in _postmortems]
    if limit is not None:
        finished = finished[-int(limit):]
    exemplars = {}
    for fam in EXEMPLAR_FAMILIES:
        f = metrics.REGISTRY.collect(fam)
        if f is None:
            continue
        series = [s for s in f._dump_series_all() if "exemplars" in s]
        if series:
            exemplars[fam] = series
    return {"enabled": _enabled, "capacity": _capacity,
            "records": finished, "live": live, "postmortems": pms,
            "exemplars": exemplars}


def postmortems() -> List[dict]:
    """Recent full postmortem documents (newest last)."""
    with _lock:
        return list(_postmortems)


def _thread_snapshot() -> List[dict]:
    """Bounded where-was-every-thread capture: up to
    `_SNAPSHOT_MAX_THREADS` threads, innermost `_SNAPSHOT_MAX_FRAMES`
    frames each — the postmortem shows where every thread sat, not just
    the metric that tripped. Best-effort: a failure here must never take
    the trip path down."""
    try:
        frames = sys._current_frames()
        by_ident = {t.ident: t for t in threading.enumerate()}
        threads = []
        for ident, frame in list(frames.items())[:_SNAPSHOT_MAX_THREADS]:
            t = by_ident.get(ident)
            stack = traceback.format_stack(frame)[-_SNAPSHOT_MAX_FRAMES:]
            threads.append({
                "name": t.name if t is not None else f"ident-{ident}",
                "ident": ident,
                "daemon": bool(t.daemon) if t is not None else None,
                "stack": [ln.rstrip() for ln in stack]})
        return threads
    except Exception:
        # diagnostics capture inside the postmortem path: any failure
        # degrades to an empty snapshot rather than masking the trip
        return []


def _lock_holder_snapshot() -> dict:
    """The util/locks.py DiagnosedLock holder table as plain JSON: which
    named lock is held, by which thread, for how long."""
    try:
        from deeplearning4j_tpu_torch.util import locks
        return {name: {"thread": thread, "held_for_s": round(held, 3)}
                for name, (thread, held) in locks.holder_table().items()}
    except Exception:
        # same contract as _thread_snapshot: degrade to empty, never
        # mask the original trip reason
        return {}


def trip(reason: str, **meta) -> Optional[str]:
    """SLO breach: snapshot the ring into a postmortem document — plus a
    bounded all-thread stack snapshot and the DiagnosedLock holder table
    — keep it in memory, and (when a dump_dir is configured) write it to
    ``postmortem-<unix_ms>-<reason>.json`` atomically. Rate-limited to
    one dump per reason per cooldown so a flapping breaker cannot
    dump-storm the disk. Returns the written path (or None)."""
    if not _enabled:
        return None
    now = time.monotonic()
    with _lock:
        last = _last_trip.get(reason)
        if last is not None and now - last < _TRIP_COOLDOWN_S:
            return None
        _last_trip[reason] = now
    # capture the stacks OUTSIDE the ring lock: formatting 32 threads is
    # milliseconds, and nothing here touches flight state
    threads = _thread_snapshot()
    locks_held = _lock_holder_snapshot()
    with _lock:
        doc = {"reason": reason,
               "dumped_unix": round(time.time(), 6),
               "pid": os.getpid(),
               "meta": {k: v for k, v in meta.items() if v is not None},
               "n_records": len(_ring),
               "records": list(_ring),
               "live": [_strip_open(r) for rs in _live.values()
                        for r in rs],
               "threads": threads,
               "locks": locks_held}
        _postmortems.append(doc)
        dump_dir = _dump_dir
    metrics.counter("serving_flight_postmortems_total",
                    "Auto-dumped SLO-breach postmortems by trigger",
                    labels=("reason",)).inc(reason=reason)
    if dump_dir is None:
        return None
    try:
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir, f"postmortem-{int(time.time() * 1e3)}-"
                      f"{os.getpid()}-{reason}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        return path
    except OSError:
        # the postmortem must never take the serving path down with it;
        # the in-memory copy above is still retrievable
        metrics.counter("serving_flight_postmortems_total",
                        "Auto-dumped SLO-breach postmortems by trigger",
                        labels=("reason",)).inc(reason="write_failed")
        return None
