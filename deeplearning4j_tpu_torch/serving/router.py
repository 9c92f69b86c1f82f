"""ResilientRouter — the fleet-aware request front end.

Counterpart of the JAX package's `serving/router.py`: framework-neutral
control plane (no torch), the same policies, metric families, spans and
flight-recorder events. The single-process ModelServer protects a *healthy* process (429/504/503
admission control); this router protects the *endpoint* when processes are
not healthy. Four mechanisms, composed per request:

- **Power-of-two-choices load spread.** Each predict picks two random
  healthy replicas and routes to the one with the lower router-tracked
  in-flight count — within a constant factor of optimal load balance at a
  fraction of the bookkeeping of global least-loaded, and it never herds
  traffic onto one "least loaded" victim the way a deterministic argmin
  does.
- **Circuit breakers per (replica, model).** Transport errors, timeouts
  and replica 5xx feed a sliding error-rate window; past the threshold the
  breaker opens and the replica stops receiving that model's traffic for
  ``open_for_s``, then a half-open probe request decides between closing
  (healthy again) and re-opening (still broken). Breakers are keyed to the
  replica's supervisor *generation*, so a restarted replica starts with a
  clean breaker instead of inheriting its dead predecessor's record.
- **Priority-class load shedding.** Requests carry ``X-Priority``
  (configurable ordered classes, e.g. interactive > standard > batch).
  Shedding is utilization-tiered: the lowest class is refused (429 +
  jittered Retry-After) when fleet in-flight crosses ``shed_floor`` of
  capacity, higher classes at evenly spaced higher thresholds, the top
  class only when the fleet is hard-full. Under saturation the endpoint
  degrades by *class*, never by luck.
- **Hedged retries.** Predict calls are idempotent, so when a request has
  waited longer than the tracked p99 of recent latencies (min
  ``hedge_min_s``), the router fires a second copy at a different healthy
  replica and returns whichever answers first — the classic tail-at-scale
  cure for one-straggler p99 blowup. Hedges are metered
  (`serving_router_hedges_total`) and capped at one per request.

`RouterServer` is the HTTP face: predict proxying with the above, fleet
swap/rollback fan-out, aggregated /readyz, and /metrics carrying both the
`serving_router_*` families and the supervisor's `serving_fleet_*` ones.
"""
from __future__ import annotations

import json
import logging
import queue
import random as _random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.monitor import slo as slo_mod
from deeplearning4j_tpu_torch.monitor import timeseries as timeseries_mod
from deeplearning4j_tpu_torch.serving import kvfabric
from deeplearning4j_tpu_torch.serving.fleet import Replica
from deeplearning4j_tpu_torch.serving.server import (
    metrics_payload, retry_after_seconds, timeseries_doc,
)
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

#: default priority ladder, highest first; requests default to the middle
DEFAULT_PRIORITY_CLASSES = ("interactive", "standard", "batch")
PRIORITY_HEADER = "X-Priority"

#: serving_router_breaker_state gauge encoding
BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2
_BREAKER_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                  BREAKER_HALF_OPEN: "half_open"}


class CircuitBreaker:
    """Sliding-window error-rate breaker: closed -> open -> half-open.

    closed: requests flow; each outcome lands in a bounded window. Once
      the window holds >= ``min_samples`` outcomes and the failure share
      reaches ``failure_rate``, the breaker opens.
    open: requests are refused locally (no wire traffic) until
      ``open_for_s`` has elapsed on the injected clock.
    half-open: up to ``half_open_probes`` live requests are let through as
      probes; the first success closes the breaker (window reset), the
      first failure re-opens it for another full ``open_for_s``.

    All transitions run under the injected ``time_fn`` — unit tests drive
    the full lifecycle with a fake clock, no sleeps.
    """

    def __init__(self, window: int = 20, min_samples: int = 5,
                 failure_rate: float = 0.5, open_for_s: float = 10.0,
                 half_open_probes: int = 1,
                 time_fn: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[int], None]] = None):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.open_for = float(open_for_s)
        self.half_open_probes = int(half_open_probes)
        self._time = time_fn
        self._on_transition = on_transition
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.router.CircuitBreaker._lock")
        self._events: deque = deque(maxlen=self.window)   # 1=failure
        self.state = BREAKER_CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0

    def _transition(self, state: int):
        self.state = state
        if self._on_transition is not None:
            self._on_transition(state)

    def _maybe_half_open_locked(self):
        if self.state == BREAKER_OPEN \
                and self._time() - self._opened_at >= self.open_for:
            self._half_open_inflight = 0
            self._transition(BREAKER_HALF_OPEN)

    def would_allow(self) -> bool:
        """Non-consuming peek (candidate filtering): would allow() pass?"""
        with self._lock:
            self._maybe_half_open_locked()
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_HALF_OPEN:
                return self._half_open_inflight < self.half_open_probes
            return False

    def allow(self) -> bool:
        """Consume permission to send one request through the breaker."""
        with self._lock:
            self._maybe_half_open_locked()
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_HALF_OPEN \
                    and self._half_open_inflight < self.half_open_probes:
                self._half_open_inflight += 1
                return True
            return False

    def release(self):
        """Give back a consumed half-open probe slot when the outcome
        was INCONCLUSIVE — replica backpressure (429/503/504) says
        nothing about brokenness, but without the release the slot would
        leak and wedge the breaker in half-open forever."""
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1)

    def record_success(self):
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1)
                self._events.clear()
                self._transition(BREAKER_CLOSED)
            elif self.state == BREAKER_CLOSED:
                self._events.append(0)

    def record_failure(self):
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1)
                self._events.clear()
                self._opened_at = self._time()
                self._transition(BREAKER_OPEN)
            elif self.state == BREAKER_CLOSED:
                self._events.append(1)
                if len(self._events) >= self.min_samples and \
                        sum(self._events) / len(self._events) \
                        >= self.failure_rate:
                    self._events.clear()
                    self._opened_at = self._time()
                    self._transition(BREAKER_OPEN)


class ReplicaTransportError(RuntimeError):
    """The replica could not be reached / timed out at the wire level."""


def http_transport(replica: Replica, path: str, body: Optional[bytes],
                   headers: Dict[str, str], timeout: float
                   ) -> Tuple[int, Dict[str, str], bytes]:
    """Default transport: POST (body given) / GET to the replica. HTTP
    error statuses come back as (code, ...) — only wire-level failures
    raise ReplicaTransportError (those are what breakers count)."""
    req = urllib.request.Request(replica.url + path, data=body,
                                 headers=headers)
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        data = e.read()
        return e.code, dict(e.headers), data
    except Exception as e:                    # noqa: BLE001 — wire failure
        raise ReplicaTransportError(
            f"{replica.name}: {type(e).__name__}: {e}") from e


def _percentile(xs: Sequence[float], p: float) -> float:
    ss = sorted(xs)
    i = min(len(ss) - 1, int(round(p / 100 * (len(ss) - 1))))
    return ss[i]


def _pop_traceparent(headers: Dict[str, str]) -> Optional[str]:
    """Case-insensitively remove and return the incoming traceparent
    (HTTP header names arrive in whatever casing the client/wire chose;
    leaving the original key in place would forward TWO traceparent
    headers after the router substitutes its own segment)."""
    for k in list(headers):
        if k.lower() == monitor.TRACEPARENT_HEADER:
            return headers.pop(k)
    return None


def _outcome_of(code: int) -> str:
    """HTTP status -> flight-record outcome tag (the loadgen taxonomy)."""
    if 200 <= code < 300:
        return "ok"
    return {429: "shed_429", 503: "unavailable_503",
            504: "deadline_504"}.get(code, f"http_{code}")


class ResilientRouter:
    """Route predict requests across the healthy fleet with breakers,
    priority shedding and hedging. See the module docstring for policy.

    `replicas_fn` yields the current routing set — usually
    ``supervisor.healthy``; tests pass a lambda over fakes. `transport`
    is the (replica, path, body, headers, timeout) -> (code, headers,
    body) seam; tests fake it, production uses `http_transport`.
    """

    def __init__(self, replicas_fn: Callable[[], List[Replica]],
                 classes: Sequence[str] = DEFAULT_PRIORITY_CLASSES,
                 default_class: Optional[str] = None,
                 shed_floor: float = 0.7,
                 per_replica_inflight: int = 8,
                 max_attempts: int = 2,
                 hedge: bool = True,
                 hedge_min_s: float = 0.05,
                 hedge_min_samples: int = 20,
                 timeout_s: float = 30.0,
                 breaker_window: int = 20,
                 breaker_min_samples: int = 5,
                 breaker_failure_rate: float = 0.5,
                 breaker_open_for_s: float = 10.0,
                 breaker_half_open_probes: int = 1,
                 time_fn: Callable[[], float] = time.monotonic,
                 rng: Optional[_random.Random] = None,
                 transport: Callable = http_transport,
                 slo_p99_ms: Optional[float] = None,
                 canary_fraction: float = 0.1,
                 affinity: bool = True,
                 disagg_min_tokens: Optional[int] = None,
                 disagg_timeout_s: float = 30.0):
        self._replicas_fn = replicas_fn
        # normalized to lowercase: _classify lowercases the header value,
        # so a class configured as "Interactive" must still match
        self.classes = tuple(c.strip().lower() for c in classes)
        if not self.classes or any(not c for c in self.classes):
            raise ValueError("need at least one non-empty priority class")
        if default_class is None:
            default_class = self.classes[min(1, len(self.classes) - 1)]
        default_class = default_class.strip().lower()
        if default_class not in self.classes:
            raise ValueError(f"default class {default_class!r} not in "
                             f"{self.classes}")
        self.default_class = default_class
        # shed thresholds: highest class sheds only at 1.0 (hard full),
        # lowest at shed_floor, the rest evenly spaced between
        n = len(self.classes)
        self.shed_at = {
            c: 1.0 if n == 1 else 1.0 - (1.0 - float(shed_floor)) * i
            / (n - 1)
            for i, c in enumerate(self.classes)}
        self.per_replica_inflight = int(per_replica_inflight)
        self.max_attempts = max(1, int(max_attempts))
        self.hedge_enabled = bool(hedge)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self.timeout_s = float(timeout_s)
        self._breaker_kw = dict(
            window=breaker_window, min_samples=breaker_min_samples,
            failure_rate=breaker_failure_rate,
            open_for_s=breaker_open_for_s,
            half_open_probes=breaker_half_open_probes, time_fn=time_fn)
        self._time = time_fn
        self._rng = rng if rng is not None else _random.Random()
        self._transport = transport
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.router.ResilientRouter._lock")
        #: (replica_name, model) -> (generation, CircuitBreaker)
        self._breakers: Dict[Tuple[str, str], Tuple[int, CircuitBreaker]] \
            = {}
        #: model -> deque of recent successful latencies (hedge p99 input)
        self._latencies: Dict[str, deque] = {}
        #: p99 SLO (ms), kept as declared configuration: the breach
        #: itself is watched by monitor/slo.py's latency burn-rate
        #: alert over serving_router_request_seconds (the CLI wires
        #: --slo-p99-ms into an Objective with reason="p99_breach")
        self.slo_p99_ms = None if slo_p99_ms is None else float(slo_p99_ms)
        #: bounded share of live traffic a canary replica receives while
        #: a rollout evaluates it (serving/rollout.py flips replica.role);
        #: the rest of the traffic routes around the canary entirely
        if not 0.0 < float(canary_fraction) <= 0.5:
            raise ValueError("canary_fraction must be in (0, 0.5], got "
                             f"{canary_fraction}")
        self.canary_fraction = float(canary_fraction)
        #: prefix-affinity routing for generate: steer a stream toward
        #: the replica advertising ownership of its leading token block
        #: (p2c-guarded: a clearly less-loaded rival still wins)
        self.affinity = bool(affinity)
        #: prefill/decode disaggregation trigger: prompts of at least
        #: this many tokens get their KV prefilled on a kv_role=prefill
        #: replica and shipped to the decode replica; None disables
        self.disagg_min_tokens = (None if disagg_min_tokens is None
                                  else int(disagg_min_tokens))
        self.disagg_timeout_s = float(disagg_timeout_s)

    # ------------------------------------------------------------- breakers
    def breaker(self, replica: Replica, model: str) -> CircuitBreaker:
        key = (replica.name, model)
        with self._lock:
            ent = self._breakers.get(key)
            if ent is None or ent[0] != replica.generation:
                # fresh incarnation -> fresh breaker: a restarted replica
                # must not inherit its predecessor's failure record
                gauge = monitor.gauge(
                    "serving_router_breaker_state",
                    "Circuit-breaker state per (replica, model): "
                    "0=closed 1=open 2=half_open",
                    labels=("replica", "model"))
                rname, mname = key

                def on_transition(state: int, _replica=replica):
                    gauge.set(state, replica=rname, model=mname)
                    monitor.counter(
                        "serving_router_breaker_transitions_total",
                        "Breaker transitions by target state",
                        labels=("replica", "model", "to")).inc(
                        replica=rname, model=mname,
                        to=_BREAKER_NAMES[state])
                    log.warning("router: breaker (%s, %s) -> %s", rname,
                                mname, _BREAKER_NAMES[state])
                    if state == BREAKER_OPEN:
                        # an opened breaker is an SLO event: snapshot the
                        # flight ring while the evidence is still in it.
                        # On a THREAD: on_transition runs under the
                        # breaker's lock (record_failure), and the trip's
                        # disk write must not stall every routing
                        # decision through that breaker mid-incident.
                        # generation is read at fire time — the postmortem
                        # must name the CURRENT incarnation, not the one
                        # alive when this breaker was first built.
                        threading.Thread(
                            target=lambda: flight.trip(
                                "breaker_open", replica=rname,
                                model=mname,
                                generation=_replica.generation),
                            daemon=True,
                            name=f"flight-trip-{rname}").start()

                br = CircuitBreaker(on_transition=on_transition,
                                    **self._breaker_kw)
                gauge.set(BREAKER_CLOSED, replica=rname, model=mname)
                self._breakers[key] = (replica.generation, br)
                return br
            return ent[1]

    # ------------------------------------------------------------- shedding
    def _classify(self, headers: Dict[str, str]) -> str:
        for k, v in headers.items():
            if k.lower() == PRIORITY_HEADER.lower():
                v = v.strip().lower()
                return v if v in self.classes else self.default_class
        return self.default_class

    def utilization(self, healthy: List[Replica]) -> float:
        cap = self.per_replica_inflight * max(1, len(healthy))
        used = sum(r.inflight() for r in healthy)
        return used / cap

    def _shed_check(self, cls: str, healthy: List[Replica]) -> bool:
        util = self.utilization(healthy) if healthy else 1.0
        monitor.gauge("serving_router_utilization",
                      "Fleet in-flight / fleet capacity").set(
            round(util, 4))
        return util >= self.shed_at[cls]

    # -------------------------------------------------------------- hedging
    def _note_latency(self, model: str, seconds: float):
        # feeds hedge_delay's tracked p99 only — SLO breach detection
        # moved to monitor/slo.py's windowed burn-rate alert, which
        # replaced the old every-16th-sample check here
        with self._lock:
            dq = self._latencies.get(model)
            if dq is None:
                dq = self._latencies[model] = deque(maxlen=512)
            dq.append(seconds)

    def hedge_delay(self, model: str) -> Optional[float]:
        """Fire a hedge after the tracked p99 (never sooner than
        hedge_min_s); None while disabled or under-sampled."""
        if not self.hedge_enabled:
            return None
        with self._lock:
            dq = self._latencies.get(model)
            if dq is None or len(dq) < self.hedge_min_samples:
                return None
            return max(self.hedge_min_s, _percentile(dq, 99))

    # ------------------------------------------------------------- routing
    def _pick(self, candidates: List[Replica]) -> Replica:
        """Power-of-two-choices on router-tracked in-flight depth."""
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        return a if a.inflight() <= b.inflight() else b

    def _canary_split(self, healthy: List[Replica], model: str
                      ) -> Tuple[List[Replica], Optional[Replica]]:
        """Weighted canary routing: while a rollout has a replica marked
        ``role == "canary"``, ~canary_fraction of requests are ASSIGNED
        to it (preferred primary, stable failover) and the rest route on
        stable replicas only — the canary's share of traffic is bounded
        above by the fraction, never inflated by power-of-two luck.
        Returns (candidate pool, preferred canary or None)."""
        canaries = [r for r in healthy if r.role == "canary"]
        if not canaries or len(canaries) == len(healthy):
            return healthy, None
        stable = [r for r in healthy if r.role != "canary"]
        if self._rng.random() >= self.canary_fraction:
            return stable, None
        preferred = canaries[0] if len(canaries) == 1 \
            else self._pick(canaries)
        monitor.counter("serving_router_canary_requests_total",
                        "Requests assigned to a canary replica by the "
                        "weighted rollout split",
                        labels=("model", "replica")).inc(
            model=model, replica=preferred.name)
        return [preferred] + stable, preferred

    def _json_response(self, code: int, payload: dict, retry_after=None
                       ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        headers = [("Content-Type", "application/json")]
        if retry_after is not None:
            headers.append(("Retry-After", str(retry_after)))
        return code, headers, json.dumps(payload).encode()

    def route_predict(self, model: str, body: bytes,
                      headers: Dict[str, str],
                      timeout: Optional[float] = None
                      ) -> Tuple[int, List[Tuple[str, str]], bytes]:
        """Route one predict call; returns (status, headers, body) ready
        to relay. Every non-2xx the router *originates* is 429/503 with
        Retry-After — the router never turns a routable request into a
        5xx of its own making."""
        t0 = time.perf_counter()
        cls = self._classify(headers)
        # adopt the client's traceparent (or mint one) and forward OUR
        # segment on the replica hop: one trace_id, router -> replica ->
        # batcher, across process boundaries. With the router's tracing
        # AND recorder off, the client's header still passes through
        # untouched — replicas with recorders on keep the trace intact.
        incoming = _pop_traceparent(headers)
        ctx = flight.request_context(incoming, "router")
        if ctx is not None:
            headers[monitor.TRACEPARENT_HEADER] = ctx.header()
        elif incoming is not None:
            headers[monitor.TRACEPARENT_HEADER] = incoming
        fr = flight.begin(ctx, "route", model=model, cls=cls)
        timeout = self.timeout_s if timeout is None else float(timeout)
        code = 500
        try:
            with monitor.bind_context(ctx), \
                    monitor.span("serving/route", model=model, cls=cls):
                code, hdrs, payload = self._route_predict(
                    model, cls, body, headers, timeout)
            if ctx is not None:
                hdrs = list(hdrs) + [("X-Trace-Id", ctx.trace_id)]
            return code, hdrs, payload
        finally:
            monitor.counter("serving_router_requests_total",
                            "Routed predict requests",
                            labels=("model", "code", "cls")).inc(
                model=model, code=str(code), cls=cls)
            monitor.histogram("serving_router_request_seconds",
                              "Router-side end-to-end predict latency",
                              labels=("model",)).observe(
                time.perf_counter() - t0, model=model,
                exemplar=None if ctx is None else ctx.trace_id)
            flight.finish(fr, _outcome_of(code), code=code)

    def _route_predict(self, model: str, cls: str, body: bytes,
                       headers: Dict[str, str], timeout: float):
        healthy = list(self._replicas_fn())
        if not healthy:
            monitor.counter("serving_router_no_backend_total",
                            "Requests refused for lack of a routable "
                            "replica (none healthy or all breakers open)"
                            ).inc()
            return self._json_response(
                503, {"error": "no healthy replica available"},
                retry_after=retry_after_seconds(1, 1, draining=True,
                                                rng=self._rng))
        if self._shed_check(cls, healthy):
            monitor.counter("serving_router_shed_total",
                            "Requests shed by priority class",
                            labels=("cls",)).inc(cls=cls)
            used = sum(r.inflight() for r in healthy)
            cap = self.per_replica_inflight * max(1, len(healthy))
            flight.note(monitor.current_context(), "shed", cls=cls,
                        inflight=used, capacity=cap)
            return self._json_response(
                429, {"error": f"fleet saturated; class {cls!r} is being "
                               "shed", "class": cls},
                retry_after=retry_after_seconds(used, cap, rng=self._rng))
        pool, preferred = self._canary_split(healthy, model)
        candidates = [r for r in pool
                      if self.breaker(r, model).would_allow()]
        if not candidates:
            monitor.counter("serving_router_no_backend_total",
                            "Requests refused for lack of a routable "
                            "replica (none healthy or all breakers open)"
                            ).inc()
            return self._json_response(
                503, {"error": "no healthy replica available"},
                retry_after=retry_after_seconds(1, 1, draining=True,
                                                rng=self._rng))
        path = f"/v1/models/{model}/predict"
        if headers.get("__query__"):
            path += "?" + headers.pop("__query__")
        return self._attempt_with_hedge(model, cls, candidates, path,
                                        body, headers, timeout,
                                        preferred=preferred)

    def _fire(self, replica: Replica, model: str, path: str, body, headers,
              timeout: float, resq: "queue.Queue"):
        """Send one copy of the request on a worker thread; put the
        (replica, kind, result) outcome on `resq` and do the breaker +
        in-flight bookkeeping regardless of whether anyone is still
        waiting (a hedge loser must still be accounted)."""
        replica.inflight_add(1)
        ctx = monitor.current_context()     # the request's, for the worker

        def run():
            t0 = time.perf_counter()
            try:
                with monitor.bind_context(ctx):
                    self._fire_one(replica, model, path, body, headers,
                                   timeout, resq, t0)
            except Exception as e:            # noqa: BLE001 — fail loud:
                # a silently-dead send thread would make the caller wait
                # out its whole deadline for an outcome that never comes
                # (the silent-thread-death class); surface the crash as
                # an error outcome so failover can proceed now. Give back
                # any half-open probe slot this send consumed: this crash
                # path records neither success nor failure, and an
                # unreturned slot wedges the breaker half-open forever. release() is a no-op
                # outside half-open, so a crash AFTER _fire_one already
                # recorded an outcome (state then left half-open) cannot
                # double-account. inflight is NOT re-decremented here:
                # _fire_one's finally owns it for every crash inside the
                # transport call, the overwhelmingly dominant source.
                self.breaker(replica, model).release()
                log.exception("router: send to %s crashed", replica.name)
                resq.put((replica, "error", e))

        threading.Thread(target=run, daemon=True,
                         name=f"route-{replica.name}").start()

    def _fire_one(self, replica, model, path, body, headers, timeout,
                  resq, t0):
        try:
            out = self._transport(replica, path, body, dict(headers),
                                  timeout)
        except ReplicaTransportError as e:
            self.breaker(replica, model).record_failure()
            monitor.counter("serving_router_replica_errors_total",
                            "Replica-level failures seen by the "
                            "router", labels=("replica", "kind")).inc(
                replica=replica.name, kind="transport")
            resq.put((replica, "error", e))
            return
        finally:
            replica.inflight_add(-1)
        code = out[0]
        if 500 <= code < 600 and code not in (503, 504):
            self.breaker(replica, model).record_failure()
            monitor.counter("serving_router_replica_errors_total",
                            "Replica-level failures seen by the "
                            "router", labels=("replica", "kind")).inc(
                replica=replica.name, kind=f"http_{code}")
            resq.put((replica, "server_error", out))
            return
        if code in (429, 503, 504):
            # an overloaded/draining replica is not a broken replica,
            # and a 504 means the REQUEST's deadline expired (a tight
            # client deadline must not open breakers on healthy
            # backends): don't poison the breaker — but DO give back
            # a half-open probe slot this send may have consumed —
            # and relay the backpressure if no other candidate answers
            self.breaker(replica, model).release()
            resq.put((replica, "overloaded", out))
            return
        self.breaker(replica, model).record_success()
        if 200 <= code < 300:
            self._note_latency(model, time.perf_counter() - t0)
        resq.put((replica, "ok", out))

    def _attempt_with_hedge(self, model: str, cls: str,
                            candidates: List[Replica], path: str,
                            body, headers, timeout: float,
                            preferred: Optional[Replica] = None):
        """The send engine: primary attempt, one optional hedge when the
        primary outlives the tracked p99, then bounded failover to the
        remaining candidates. First acceptable outcome wins. `preferred`
        (the canary split's assignment) pins the primary pick; failover
        and hedging still spread over the rest of the pool."""
        deadline = time.monotonic() + timeout
        remaining = list(candidates)
        resq: "queue.Queue" = queue.Queue()
        primary = preferred if preferred in remaining \
            else self._pick(remaining)
        remaining.remove(primary)
        # allow() consumes a half-open probe slot; every candidate —
        # including a replacement after the first pick was denied — must
        # pass it before being fired at
        while not self.breaker(primary, model).allow():
            if not remaining:
                return self._json_response(
                    503, {"error": "no healthy replica available"},
                    retry_after=retry_after_seconds(1, 1, draining=True,
                                                    rng=self._rng))
            primary = remaining.pop(
                remaining.index(self._pick(remaining)))
        self._fire(primary, model, path, body, headers, timeout, resq)
        launched, attempts = 1, 1
        hedged = False
        hedge_after = self.hedge_delay(model)
        last_overload = None
        while True:
            wait = max(0.0, deadline - time.monotonic())
            if launched == 1 and not hedged and hedge_after is not None \
                    and remaining:
                try:
                    outcome = resq.get(timeout=min(wait, hedge_after))
                except queue.Empty:
                    if wait <= hedge_after:
                        # the request DEADLINE expired, not the hedge
                        # trigger — a duplicate send now is pure waste
                        return self._json_response(
                            504, {"error": "router deadline exceeded "
                                           "waiting for a replica"})
                    # primary is a straggler: fire one hedge at a second
                    # replica, first answer wins (predict is idempotent).
                    # Like failover below, keep picking until a spare's
                    # breaker admits the send — one denied pick must not
                    # forfeit the hedge while closed-breaker candidates
                    # remain (denied picks stay in `remaining`: they are
                    # still legitimate failover targets later)
                    hedged = True
                    pool = list(remaining)
                    while pool:
                        spare = self._pick(pool)
                        pool.remove(spare)
                        if not self.breaker(spare, model).allow():
                            continue
                        remaining.remove(spare)
                        monitor.counter(
                            "serving_router_hedges_total",
                            "Hedged (duplicate) predict sends",
                            labels=("model",)).inc(model=model)
                        flight.note(monitor.current_context(), "hedge",
                                    replica=spare.name, model=model)
                        with monitor.span("serving/hedge", model=model,
                                          replica=spare.name):
                            self._fire(spare, model, path, body, headers,
                                       timeout, resq)
                        launched += 1
                        break
                    continue
            else:
                try:
                    outcome = resq.get(timeout=wait if wait > 0 else 0.05)
                except queue.Empty:
                    return self._json_response(
                        504, {"error": "router deadline exceeded waiting "
                                       "for a replica"})
            replica, kind, result = outcome
            launched -= 1
            if kind == "ok":
                code, hdrs, payload = result
                keep = [(k, v) for k, v in hdrs.items()
                        if k.lower() in ("content-type", "retry-after")]
                keep.append(("X-Served-By", replica.name))
                flight.note(monitor.current_context(), "served_by",
                            replica=replica.name, hedged=hedged)
                return code, keep, payload
            if kind == "overloaded":
                last_overload = result
            # error/server_error/overloaded: fail over while we still can
            if launched > 0:
                continue                      # a hedge twin is still out
            if attempts < self.max_attempts and time.monotonic() < deadline:
                # keep picking until a candidate's breaker admits the
                # failover — a single denied pick (half-open slot taken
                # since the filter) must not forfeit the other backends
                fired = False
                while remaining:
                    nxt = self._pick(remaining)
                    remaining.remove(nxt)
                    if not self.breaker(nxt, model).allow():
                        continue
                    monitor.counter("serving_router_retries_total",
                                    "Failover re-sends after a replica "
                                    "failure", labels=("model",)).inc(
                        model=model)
                    flight.note(monitor.current_context(), "failover",
                                replica=nxt.name, model=model)
                    self._fire(nxt, model, path, body, headers, timeout,
                               resq)
                    launched += 1
                    attempts += 1
                    fired = True
                    break
                if fired:
                    continue
            if last_overload is not None:
                code, hdrs, payload = last_overload
                keep = [(k, v) for k, v in hdrs.items()
                        if k.lower() in ("content-type", "retry-after")]
                return code, keep, payload
            return self._json_response(
                503, {"error": "all candidate replicas failed"},
                retry_after=retry_after_seconds(1, 1, draining=True,
                                                rng=self._rng))

    # ------------------------------------------------------- kv fabric
    @staticmethod
    def _prompt_of(body: Optional[bytes]):
        """Token ids of a generate body, or None when unparseable (the
        fabric features degrade to plain routing, never reject)."""
        try:
            doc = json.loads(body or b"{}")
        except (ValueError, TypeError):
            return None
        prompt = doc.get("prompt") if isinstance(doc, dict) else None
        if isinstance(prompt, (list, tuple)) and prompt:
            return list(prompt)
        return None

    def _affinity_pick(self, model: str, prompt,
                       candidates: List[Replica]) -> Optional[Replica]:
        """Prefix-affinity preference: the replica advertising ownership
        of the prompt's leading page-aligned block (per its /readyz
        heartbeat digest), guarded by power-of-two-choices — one random
        rival with strictly lower in-flight still wins, so a hot prefix
        cannot melt its owner. Ties break to the owner (the cache hit
        is worth more than a one-request queue edge)."""
        if not self.affinity or prompt is None or len(candidates) < 2:
            return None
        owners, dig_cache = [], {}
        for r in candidates:
            own = (getattr(r, "kv_ownership", None) or {}).get(model)
            if not isinstance(own, dict):
                continue
            block = int(own.get("block") or 0)
            if block < 1 or len(prompt) < block:
                continue
            if block not in dig_cache:
                d = kvfabric.leading_digest(prompt, block)
                dig_cache[block] = None if d is None else d.hex()[:16]
            if dig_cache[block] is not None \
                    and dig_cache[block] in (own.get("digests") or ()):
                owners.append(r)
        outcomes = monitor.counter(
            "serving_router_affinity_requests_total",
            "Generate routing decisions by the prefix-affinity pick "
            "(owner = steered to the advertising replica, fallback = "
            "p2c load guard overrode the owner, none = no replica "
            "advertised the prefix)", labels=("model", "outcome"))
        if not owners:
            outcomes.inc(model=model, outcome="none")
            return None
        owner = owners[0] if len(owners) == 1 else self._pick(owners)
        others = [r for r in candidates if r is not owner]
        rival = self._rng.choice(others) if others else None
        if rival is not None and rival.inflight() < owner.inflight():
            outcomes.inc(model=model, outcome="fallback")
            return rival
        outcomes.inc(model=model, outcome="owner")
        flight.note(monitor.current_context(), "affinity",
                    replica=owner.name, model=model)
        return owner

    def _disagg_prefill(self, model: str, prompt,
                        prefills: List[Replica],
                        target: Replica) -> bool:
        """Disaggregated prefill: export the prompt's KV pages from a
        prefill replica, land them on `target` (the decode replica about
        to take the stream). True on success; ANY failure — the prefill
        replica dying mid-transfer included — is metered, postmortemed
        with the dead peer's name, and answered False so the caller
        falls back to local prefill. Never a 5xx of the router's
        making."""
        pre = prefills[0] if len(prefills) == 1 else self._pick(prefills)
        t0 = time.perf_counter()
        try:
            with monitor.span("serving/disagg_transfer", model=model,
                              prefill=pre.name, decode=target.name):
                pre.inflight_add(1)
                try:
                    code, _, blob = self._transport(
                        pre, f"/v1/models/{model}/kv/export",
                        json.dumps({"prompt": prompt}).encode(),
                        {"Content-Type": "application/json"},
                        self.disagg_timeout_s)
                finally:
                    pre.inflight_add(-1)
                if code != 200:
                    raise ReplicaTransportError(
                        f"{pre.name}: kv export answered {code}")
                code, _, _out = self._transport(
                    target, f"/v1/models/{model}/kv/import", blob,
                    {"Content-Type": "application/octet-stream"},
                    self.disagg_timeout_s)
                if code != 200:
                    raise ReplicaTransportError(
                        f"{target.name}: kv import answered {code}")
        except ReplicaTransportError as e:
            monitor.counter(
                "serving_transfer_failovers_total",
                "Disaggregated prefills abandoned mid-transfer "
                "(stream fell back to local prefill on the decode "
                "replica)", labels=("model",)).inc(model=model)
            flight.note(monitor.current_context(), "disagg_failover",
                        model=model, peer=pre.name, error=str(e))
            # the dead transfer peer is an SLO event: postmortem while
            # the request evidence is still in the flight ring
            flight.trip("transfer_peer_lost", model=model,
                        peer=pre.name, decode=target.name,
                        error=str(e))
            log.warning("router: disaggregated prefill via %s failed "
                        "(%s) — local prefill on %s", pre.name, e,
                        target.name)
            return False
        monitor.counter(
            "serving_transfer_orchestrations_total",
            "Disaggregated prefill transfers completed by the router "
            "(export from a prefill replica + import on the decode "
            "replica)", labels=("model",)).inc(model=model)
        flight.note(monitor.current_context(), "disagg_transfer",
                    model=model, prefill=pre.name, decode=target.name,
                    bytes=len(blob),
                    ms=round((time.perf_counter() - t0) * 1e3, 2))
        return True

    # ------------------------------------------------------------ streaming
    def route_generate(self, model: str, body: bytes,
                       headers: Dict[str, str],
                       timeout: Optional[float] = None):
        """Route one token-streaming generate call. Shedding, breakers
        and priority classes apply exactly as for predict; hedging does
        NOT (a duplicate stream doubles decode work and the winner is
        ambiguous mid-stream), and failover only happens BEFORE the
        replica has answered — once bytes flow, the stream is committed.

        Returns either ``("relay", code, headers, body)`` for terminal
        outcomes the handler sends as-is, or
        ``("stream", code, headers, resp, done_cb)`` where `resp` is the
        replica's live chunked response to copy through and `done_cb(ok)`
        MUST be called when the copy ends (breaker + in-flight
        accounting)."""
        t0 = time.perf_counter()
        cls = self._classify(headers)
        incoming = _pop_traceparent(headers)
        ctx = flight.request_context(incoming, "router")
        if ctx is not None:
            headers[monitor.TRACEPARENT_HEADER] = ctx.header()
        elif incoming is not None:
            headers[monitor.TRACEPARENT_HEADER] = incoming
        fr = flight.begin(ctx, "route_stream", model=model, cls=cls)
        timeout = self.timeout_s if timeout is None else float(timeout)
        code_box = {"code": 500}

        def meter(code: int):
            code_box["code"] = code
            monitor.counter("serving_router_stream_requests_total",
                            "Routed generate (token-stream) requests",
                            labels=("model", "code", "cls")).inc(
                model=model, code=str(code), cls=cls)

        def relay(code, hdrs, payload):
            meter(code)
            if ctx is not None:
                hdrs = list(hdrs) + [("X-Trace-Id", ctx.trace_id)]
            flight.finish(fr, _outcome_of(code), code=code)
            return ("relay", code, hdrs, payload)

        with monitor.bind_context(ctx), \
                monitor.span("serving/route", model=model, cls=cls,
                             stream=1):
            healthy = list(self._replicas_fn())
            if not healthy:
                monitor.counter("serving_router_no_backend_total",
                                "Requests refused for lack of a routable "
                                "replica (none healthy or all breakers "
                                "open)").inc()
                c, h, b = self._json_response(
                    503, {"error": "no healthy replica available"},
                    retry_after=retry_after_seconds(1, 1, draining=True,
                                                    rng=self._rng))
                return relay(c, h, b)
            if self._shed_check(cls, healthy):
                monitor.counter("serving_router_shed_total",
                                "Requests shed by priority class",
                                labels=("cls",)).inc(cls=cls)
                used = sum(r.inflight() for r in healthy)
                cap = self.per_replica_inflight * max(1, len(healthy))
                flight.note(ctx, "shed", cls=cls, inflight=used,
                            capacity=cap)
                c, h, b = self._json_response(
                    429, {"error": f"fleet saturated; class {cls!r} is "
                                   "being shed", "class": cls},
                    retry_after=retry_after_seconds(used, cap,
                                                    rng=self._rng))
                return relay(c, h, b)
            path = f"/v1/models/{model}/generate"
            if headers.get("__query__"):
                path += "?" + headers.pop("__query__")
            pool, preferred = self._canary_split(healthy, model)
            remaining = [r for r in pool
                         if self.breaker(r, model).would_allow()]
            # ---- KV fabric: role split, prefix affinity, disaggregation
            prefills = [r for r in healthy
                        if getattr(r, "kv_role", "mixed") == "prefill"]
            decode_pool = [r for r in remaining
                           if getattr(r, "kv_role", "mixed") != "prefill"]
            if decode_pool:
                # prefill-only replicas take decode streams only when
                # nothing else is routable: availability beats the split
                remaining = decode_pool
            prompt = self._prompt_of(body)
            if preferred is None:
                preferred = self._affinity_pick(model, prompt, remaining)
            if (prefills and remaining and prompt is not None
                    and self.disagg_min_tokens is not None
                    and len(prompt) >= self.disagg_min_tokens):
                target = preferred if preferred in remaining \
                    else self._pick(remaining)
                if self._disagg_prefill(model, prompt, prefills, target):
                    # the shipped pages live on `target`: pin the stream
                    # there (failover still covers a later death — the
                    # fallback replica just prefills locally)
                    preferred = target
            backpressure = None
            while remaining:
                if preferred is not None and preferred in remaining:
                    replica, preferred = preferred, None
                else:
                    replica = self._pick(remaining)
                remaining.remove(replica)
                breaker = self.breaker(replica, model)
                if not breaker.allow():
                    continue
                replica.inflight_add(1)
                try:
                    resp = urllib.request.urlopen(urllib.request.Request(
                        replica.url + path, data=body,
                        headers=dict(headers)), timeout=timeout)
                except urllib.error.HTTPError as e:
                    replica.inflight_add(-1)
                    if e.code in (429, 503, 504):
                        # backpressure, not brokenness; keep the LOWEST
                        # code seen as the fallback relay — 429/503 carry
                        # Retry-After guidance polite clients act on, a
                        # bare 504 would read as a hard failure
                        breaker.release()
                        if backpressure is None or e.code < backpressure[0]:
                            backpressure = (e.code,
                                            list(e.headers.items()),
                                            e.read())
                        else:
                            e.read()
                        continue
                    breaker.record_failure()
                    monitor.counter(
                        "serving_router_replica_errors_total",
                        "Replica-level failures seen by the router",
                        labels=("replica", "kind")).inc(
                        replica=replica.name, kind=f"http_{e.code}")
                    e.read()
                    continue
                except Exception as e:              # noqa: BLE001 — wire
                    replica.inflight_add(-1)
                    breaker.record_failure()
                    monitor.counter(
                        "serving_router_replica_errors_total",
                        "Replica-level failures seen by the router",
                        labels=("replica", "kind")).inc(
                        replica=replica.name, kind="transport")
                    log.warning("router: generate connect to %s failed: "
                                "%s", replica.name, e)
                    continue

                def done(ok: bool, _r=replica, _b=breaker,
                         _code=resp.status):
                    _r.inflight_add(-1)
                    if ok:
                        _b.record_success()
                        self._note_latency(model,
                                           time.perf_counter() - t0)
                    else:
                        _b.record_failure()
                    flight.finish(fr, "ok" if ok else "stream_broken",
                                  code=_code, replica=_r.name)

                flight.note(ctx, "stream_committed",
                            replica=replica.name, model=model)
                keep = [(k, v) for k, v in resp.headers.items()
                        if k.lower() in ("content-type", "retry-after",
                                         "x-model-version")]
                keep.append(("X-Served-By", replica.name))
                if ctx is not None:
                    keep.append(("X-Trace-Id", ctx.trace_id))
                meter(resp.status)
                return ("stream", resp.status, keep, resp, done)
            if backpressure is not None:
                code, hdrs, payload = backpressure
                keep = [(k, v) for k, v in hdrs
                        if k.lower() in ("content-type", "retry-after")]
                return relay(code, keep, payload)
            c, h, b = self._json_response(
                503, {"error": "all candidate replicas failed"},
                retry_after=retry_after_seconds(1, 1, draining=True,
                                                rng=self._rng))
            return relay(c, h, b)

    # --------------------------------------------------------------- admin
    def fan_out(self, verb_path: str, body: Optional[bytes],
                headers: Dict[str, str], timeout: float = 300.0) -> dict:
        """Broadcast an admin call (swap/rollback) to every healthy
        replica — in parallel, so the mixed-version window during a swap
        is one warm time, not N of them; per-replica outcomes, never an
        exception."""
        results: Dict[str, dict] = {}
        lock = threading.Lock()

        def _one(r: Replica):
            try:
                code, _, payload = self._transport(
                    r, verb_path, body, dict(headers), timeout)
                try:
                    doc = json.loads(payload)
                except ValueError:
                    doc = {"raw": payload.decode("utf-8", "replace")}
                out = {"code": code, "body": doc}
            except ReplicaTransportError as e:
                out = {"code": 0, "error": str(e)}
            with lock:
                results[r.name] = out

        threads = [threading.Thread(target=_one, args=(r,), daemon=True,
                                    name=f"fanout-{r.name}")
                   for r in list(self._replicas_fn())]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "DL4JCUDA-Router/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    @property
    def _rs(self) -> "RouterServer":
        return self.server.router_server       # type: ignore[attr-defined]

    def _reply(self, code: int, headers, body: bytes):
        self.send_response(code)
        seen_ct = False
        for k, v in headers:
            if k.lower() == "content-type":
                seen_ct = True
            self.send_header(k, v)
        if not seen_ct:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200, extra=()):
        self._reply(code, [("Content-Type", "application/json")]
                    + list(extra), json.dumps(obj).encode())

    def _body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except (TypeError, ValueError):
            length = 0
        return self.rfile.read(max(0, length))

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._json({"status": "alive", "role": "router"})
            return
        if url.path == "/readyz":
            healthy = self._rs.router._replicas_fn()
            if self._rs.draining:
                self._json({"status": "draining"}, code=503,
                           extra=(("Retry-After", str(retry_after_seconds(
                               1, 1, draining=True,
                               rng=self._rs.router._rng))),))
            elif healthy:
                self._json({"status": "ready",
                            "replicas": [r.name for r in healthy]})
            else:
                self._json({"status": "no_healthy_replicas"}, code=503,
                           extra=(("Retry-After", str(retry_after_seconds(
                               1, 1, draining=True,
                               rng=self._rs.router._rng))),))
            return
        if url.path == "/metrics":
            body, ctype = metrics_payload(url.query)
            self._reply(200, [("Content-Type", ctype)], body)
            return
        if url.path == "/v1/timeseries":
            ring = (self._rs.timeseries_ring
                    or timeseries_mod.default_ring())
            self._json(timeseries_doc(ring, url.query))
            return
        if url.path == "/v1/slo":
            self._slo()
            return
        if url.path == "/v1/fleet":
            sup = self._rs.supervisor
            doc = sup.describe() if sup is not None else {"replicas": []}
            rollout = self._rs.rollout
            if rollout is not None:
                doc["rollout"] = rollout.describe()
            self._json(doc)
            return
        if url.path == "/v1/debug/flight":
            # fleet-wide view: the router's own ring plus every healthy
            # replica's — one endpoint answers "what happened to request
            # X" regardless of which process served it. Fetched in
            # PARALLEL (same pattern as fan_out): N slow/dead replicas
            # cost one 5 s timeout total, not N of them.
            doc = {"router": flight.snapshot(), "replicas": {}}
            lock = threading.Lock()

            def _one(r: Replica):
                try:
                    code, _, payload = self._rs.router._transport(
                        r, "/v1/debug/flight", None, {}, 5.0)
                    out = json.loads(payload) if code == 200 \
                        else {"error": f"http_{code}"}
                except (ReplicaTransportError, ValueError) as e:
                    out = {"error": str(e)}
                with lock:
                    doc["replicas"][r.name] = out

            threads = [threading.Thread(target=_one, args=(r,),
                                        daemon=True,
                                        name=f"flight-{r.name}")
                       for r in self._rs.router._replicas_fn()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._json(doc)
            return
        if url.path.startswith("/v1/models"):
            # model metadata rides on any healthy replica
            healthy = self._rs.router._replicas_fn()
            if not healthy:
                self._json({"error": "no healthy replica"}, code=503)
                return
            try:
                code, hdrs, payload = self._rs.router._transport(
                    healthy[0], url.path, None, {}, 10.0)
                self._reply(code, [(k, v) for k, v in hdrs.items()
                                   if k.lower() == "content-type"], payload)
            except ReplicaTransportError as e:
                self._json({"error": str(e)}, code=503)
            return
        self._json({"error": "not found"}, code=404)

    def _slo(self):
        """GET /v1/slo — the fleet SLO verdict: the router's own
        engine's verdict plus every healthy replica's /v1/slo, fetched
        in PARALLEL (one 5 s budget total, same pattern as
        /v1/debug/flight), folded into one worst-state-wins summary."""
        engine = self._rs.slo_engine or slo_mod.default_engine()
        doc = {"router": (engine.verdict() if engine is not None
                          else {"enabled": False}),
               "replicas": {}}
        lock = threading.Lock()

        def _one(r: Replica):
            try:
                code, _, payload = self._rs.router._transport(
                    r, "/v1/slo", None, {}, 5.0)
                out = json.loads(payload) if code == 200 \
                    else {"error": f"http_{code}"}
            except (ReplicaTransportError, ValueError) as e:
                out = {"error": str(e)}
            with lock:
                doc["replicas"][r.name] = out

        threads = [threading.Thread(target=_one, args=(r,), daemon=True,
                                    name=f"slo-{r.name}")
                   for r in self._rs.router._replicas_fn()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        order = {"ok": 0, "pending": 1, "firing": 2}
        worst, firing, unreachable, reporting = "ok", [], [], 0
        verdicts = [("router", doc["router"])] \
            + sorted(doc["replicas"].items())
        for name, v in verdicts:
            if not v.get("enabled"):
                if "error" in v:
                    unreachable.append(name)
                continue
            reporting += 1
            state = v.get("state", "ok")
            if order.get(state, 0) > order[worst]:
                worst = state
            for obj in v.get("objectives", []):
                for alert in obj.get("alerts", []):
                    if alert.get("state") == "firing":
                        firing.append(
                            f"{name}:{obj['name']}:{alert['severity']}")
        doc["fleet"] = {"state": worst, "reporting": reporting,
                        "unreachable": unreachable, "firing": firing}
        self._json(doc)

    def do_POST(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if parts[:2] != ["v1", "models"] or len(parts) != 4:
            self._json({"error": "not found"}, code=404)
            return
        name, verb = parts[2], parts[3]
        body = self._body()
        if verb == "predict":
            headers = {k: v for k, v in self.headers.items()
                       if k.lower() in ("content-type", "accept",
                                        "x-priority", "traceparent")}
            if url.query:
                headers["__query__"] = url.query
            code, hdrs, payload = self._rs.router.route_predict(
                name, body, headers)
            self._reply(code, hdrs, payload)
            return
        if verb == "generate":
            headers = {k: v for k, v in self.headers.items()
                       if k.lower() in ("content-type", "accept",
                                        "x-priority", "traceparent")}
            if url.query:
                headers["__query__"] = url.query
            out = self._rs.router.route_generate(name, body, headers)
            if out[0] == "relay":
                _, code, hdrs, payload = out
                self._reply(code, hdrs, payload)
                return
            _, code, hdrs, resp, done = out
            # live token stream: re-chunk the replica's SSE bytes through
            # as they arrive — the router adds no buffering, so TTFT and
            # inter-token latency survive the proxy hop
            self.send_response(code)
            for k, v in hdrs:
                self.send_header(k, v)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            ok, client_gone = True, False
            while True:
                try:
                    piece = resp.read1(65536)
                except OSError as e:        # replica died mid-stream
                    ok = False
                    log.warning("router: replica stream for %s broke: %s",
                                name, e)
                    break
                if not piece:
                    break
                try:
                    self.wfile.write(f"{len(piece):X}\r\n".encode())
                    self.wfile.write(piece)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()
                except OSError:             # client hung up — NOT the
                    client_gone = True      # replica's fault; closing
                    break                   # resp cancels its slot
            if not client_gone:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    client_gone = True
            try:
                resp.close()
            finally:
                done(ok)
            return
        if verb in ("swap", "rollback"):
            rollout = self._rs.rollout
            if rollout is not None and rollout.holds_admin():
                # a manual admin call racing an in-flight canary must
                # lose LOUDLY: interleaving a fan-out swap with the
                # controller's canary/promote sequence would fork the
                # fleet's version history mid-evaluation
                monitor.counter(
                    "serving_rollout_admin_conflicts_total",
                    "Manual swap/rollback calls refused (409) because a "
                    "rollout held the admin surface",
                    labels=("verb",)).inc(verb=verb)
                self._json({"error": f"{verb} rejected: a rollout is in "
                                     "progress and holds the fleet admin "
                                     "surface; retry after it settles",
                            "rollout": rollout.describe()}, code=409)
                return
            results = self._rs.router.fan_out(
                f"/v1/models/{name}/{verb}", body,
                {"Content-Type": "application/json"})
            ok = bool(results) and all(r.get("code") == 200
                                       for r in results.values())
            sup = self._rs.supervisor
            skipped = [r.name for r in (sup.replicas if sup else [])
                       if r.name not in results]
            if ok and sup is not None:
                # the fan-out reaches only currently-healthy replicas; a
                # replica restarted later relaunches from its ReplicaSpec
                # — update the spec so fresh incarnations load the
                # post-admin source, not the boot-time one. For swap the
                # source came in the request body; for rollback it is
                # whatever version the replicas re-activated (their
                # responses name it) — without this rewrite a restarted
                # replica would silently rejoin on the ROLLED-BACK-FROM
                # version.
                src = None
                if verb == "swap":
                    try:
                        src = json.loads(body or b"{}").get("source")
                    except ValueError:
                        src = None
                else:
                    for out in results.values():
                        active = out.get("body", {}).get("active") or {}
                        if active.get("source"):
                            src = active["source"]
                            break
                if src:
                    for r in sup.replicas:
                        if r.spec is not None:
                            r.spec.models = [
                                (n, src if n == name else s)
                                for n, s in r.spec.models]
                            r.spec.lms = [
                                (n, src if n == name else s)
                                for n, s in r.spec.lms]
            self._json({"model": name, "verb": verb, "ok": ok,
                        "replicas": results,
                        "skipped_unhealthy": skipped},
                       code=200 if ok else 503)
            return
        self._json({"error": "not found"}, code=404)


class RouterServer:
    """HTTP front end over a ResilientRouter (and optionally the
    supervisor whose fleet it routes)."""

    def __init__(self, router: ResilientRouter, supervisor=None,
                 host: str = "127.0.0.1", port: int = 0,
                 slo_engine=None, timeseries_ring=None, rollout=None):
        self.router = router
        self.supervisor = supervisor
        #: attached RolloutController (set late via ``rs.rollout = rc`` is
        #: fine) — while it holds the admin surface, manual swap/rollback
        #: fan-outs are refused with 409 instead of interleaving
        self.rollout = rollout
        # GET /v1/slo and /v1/timeseries sources; None falls back to
        # the process defaults the CLI's --slo-* flags install
        self.slo_engine = slo_engine
        self.timeseries_ring = timeseries_ring
        #: flipped before teardown: /readyz -> 503 so the balancer
        #: drains us while in-flight work finishes (see cli._main_fleet)
        self.draining = False
        self._httpd = ThreadingHTTPServer((host, port), _RouterHandler)
        self._httpd.router_server = self       # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="RouterServer")
        self._thread.start()
        log.info("router: listening on http://%s:%d", host, self.port)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
