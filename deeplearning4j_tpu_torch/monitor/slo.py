"""Declarative SLO objectives and multi-window burn-rate alerting.

`monitor/timeseries.py` supplies windowed evidence; this module renders
the verdict. An `Objective` declares what "good" means over one metric
family — availability (the non-5xx share of responses) or latency (the
share of requests under a threshold) against a target like 0.999. A
`BurnRule` asks how fast the error budget is burning over a long AND a
short window (multi-window multi-burn-rate, the SRE-workbook shape:
the long window proves the burn is *sustained*, the short window proves
it is *still happening* — ANDed they page fast on real incidents
without flapping on noise). The engine runs one alert state machine per
(objective, rule):

    inactive -> pending (condition true, waiting out `for_s`)
             -> firing  (`flight.trip()` fires, so the alert postmortem
                         auto-carries the flight records explaining it)
             -> inactive (condition clear for `keep_firing_s` — brief
                          dips mid-incident must not resolve the page)

The default rule pair is the workbook's page/ticket split: 14.4x burn
over 1h AND 5m (a 99.9% SLO's monthly budget gone in ~2 days) pages;
6x over 6h AND 30m tickets. Every window, threshold and the clock are
injectable — tests drive the full lifecycle on a fake clock with a
hand-sampled ring.

``GET /v1/slo`` on ModelServer/RouterServer serves `verdict()`; the
router additionally aggregates per-replica verdicts into one fleet
view. Zero-cost contract as everywhere in monitor/: no engine exists
and nothing evaluates until `enable_slo()` (or an ``--slo-*`` flag),
and evaluation rides the sampler thread — never the request path.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.monitor import flight, metrics
from deeplearning4j_tpu_torch.monitor.timeseries import TimeSeriesRing

#: slo_alert_state gauge encoding
STATE_INACTIVE, STATE_PENDING, STATE_FIRING = 0, 1, 2
_STATE_NAMES = {STATE_INACTIVE: "inactive", STATE_PENDING: "pending",
                STATE_FIRING: "firing"}


def _round(v: Optional[float], ndigits: int = 4) -> Optional[float]:
    return None if v is None else round(float(v), ndigits)


def default_bad_code(code: str) -> bool:
    """Availability's default badness predicate: 5xx. 504 is named for
    emphasis — a router-originated deadline is an availability error
    even though admission-control 429/503 are not."""
    return code.startswith("5") or code == "504"


class Objective:
    """One SLO: what fraction of events must be good.

    kind="availability": `family` is a counter with a status-code label
    (`code_label`); codes matching `bad_code` burn budget. The ratio is
    bad/total over the window — no traffic means no verdict (None), so
    an idle fleet never pages.

    kind="latency": `family` is a histogram of seconds; observations
    over `threshold_s` burn budget.

    `target` is the promised good fraction (0.99 -> 1% error budget),
    `match` pins extra labels (e.g. model="m"), and `reason` names the
    `flight.trip` postmortem fired when a rule over this objective
    starts firing.
    """

    def __init__(self, name: str, kind: str, family: str, target: float,
                 threshold_s: Optional[float] = None,
                 match: Optional[Dict[str, str]] = None,
                 code_label: str = "code",
                 bad_code: Callable[[str], bool] = default_bad_code,
                 reason: Optional[str] = None):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if kind == "latency" and threshold_s is None:
            raise ValueError("latency objective needs threshold_s")
        self.name = str(name)
        self.kind = kind
        self.family = family
        self.target = float(target)
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.match = dict(match or {})
        self.code_label = code_label
        self.bad_code = bad_code
        self.reason = reason or f"slo_{kind}_burn"

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def error_ratio(self, ring: TimeSeriesRing,
                    window_s: float) -> Optional[float]:
        """Bad fraction over the window; None without traffic or data
        (absence of evidence is not a burn)."""
        if self.kind == "availability":
            by_code = ring.increase_by(self.family, window_s,
                                       self.code_label, **self.match)
            if not by_code:
                return None
            total = sum(by_code.values())
            if total <= 0:
                return None
            bad = sum(v for code, v in by_code.items()
                      if self.bad_code(code))
            return bad / total
        good = ring.fraction_le(self.family, window_s, self.threshold_s,
                                **self.match)
        return None if good is None else 1.0 - good

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind, "family": self.family,
                "target": self.target, "threshold_s": self.threshold_s,
                "match": self.match or None, "reason": self.reason}


class BurnRule:
    """One multi-window burn-rate rule: alert when the error budget
    burns at >= `burn_threshold` times the sustainable rate over BOTH
    the long and the short window (burn = error_ratio / (1 - target):
    1.0 means spending exactly the budget)."""

    def __init__(self, severity: str, long_window_s: float,
                 short_window_s: float, burn_threshold: float,
                 for_s: float = 0.0, keep_firing_s: float = 60.0):
        self.severity = str(severity)
        self.long_window_s = float(long_window_s)
        self.short_window_s = float(short_window_s)
        self.burn_threshold = float(burn_threshold)
        self.for_s = float(for_s)
        self.keep_firing_s = float(keep_firing_s)

    def describe(self) -> dict:
        return {"severity": self.severity,
                "long_window_s": self.long_window_s,
                "short_window_s": self.short_window_s,
                "burn_threshold": self.burn_threshold,
                "for_s": self.for_s, "keep_firing_s": self.keep_firing_s}


#: the SRE-workbook page/ticket pair
DEFAULT_RULES = (
    BurnRule("page", 3600.0, 300.0, 14.4, keep_firing_s=120.0),
    BurnRule("ticket", 21600.0, 1800.0, 6.0, keep_firing_s=600.0),
)


class _Alert:
    """One (objective, rule) alert state machine. Transitions are
    edge-triggered — update() reports "fired"/"resolved" exactly once
    per transition, so concurrent evaluate() calls cannot double-fire.
    """

    def __init__(self, objective: Objective, rule: BurnRule):
        self.objective = objective
        self.rule = rule
        self.state = STATE_INACTIVE
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.burn_long: Optional[float] = None
        self.burn_short: Optional[float] = None

    def update(self, now: float, burn_long: Optional[float],
               burn_short: Optional[float]) -> Optional[str]:
        self.burn_long, self.burn_short = burn_long, burn_short
        threshold = self.rule.burn_threshold
        # AND-gate: both windows must show the burn, and both must have
        # evidence — a no-traffic window (None) can never fire
        cond = (burn_long is not None and burn_short is not None
                and burn_long >= threshold and burn_short >= threshold)
        if self.state == STATE_INACTIVE:
            if not cond:
                return None
            self.state = STATE_PENDING
            self.pending_since = now
            # fall through: for_s == 0 fires on the same evaluation
        if self.state == STATE_PENDING:
            if not cond:
                self.state = STATE_INACTIVE
                self.pending_since = None
                return None
            if now - self.pending_since >= self.rule.for_s:
                self.state = STATE_FIRING
                self.firing_since = now
                self.clear_since = None
                return "fired"
            return None
        # firing: flap suppression — the condition must stay clear for
        # keep_firing_s before the alert resolves
        if cond:
            self.clear_since = None
            return None
        if self.clear_since is None:
            self.clear_since = now
        if now - self.clear_since >= self.rule.keep_firing_s:
            self.state = STATE_INACTIVE
            self.pending_since = self.firing_since = self.clear_since = None
            return "resolved"
        return None

    def describe(self) -> dict:
        return {"severity": self.rule.severity,
                "state": _STATE_NAMES[self.state],
                "burn_long": _round(self.burn_long),
                "burn_short": _round(self.burn_short),
                "burn_threshold": self.rule.burn_threshold,
                "long_window_s": self.rule.long_window_s,
                "short_window_s": self.rule.short_window_s}


class SLOEngine:
    """Evaluate objectives x rules over a ring; keep alert state, the
    transition history and the `slo_*` metric families current; fire a
    flight postmortem on every alert firing (so the page carries the
    slow-request records that explain it)."""

    def __init__(self, ring: TimeSeriesRing,
                 objectives: Sequence[Objective],
                 rules: Sequence[BurnRule] = DEFAULT_RULES,
                 time_fn: Optional[Callable[[], float]] = None,
                 wall_fn: Callable[[], float] = time.time,
                 trip_fn: Optional[Callable] = None,
                 history_limit: int = 256):
        self.ring = ring
        self.objectives = list(objectives)
        self.rules = tuple(rules)
        if not self.objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        if not self.rules:
            raise ValueError("SLOEngine needs at least one rule")
        self._time = time_fn if time_fn is not None else ring._time
        self._wall = wall_fn
        self._trip = trip_fn if trip_fn is not None else flight.trip
        self._lock = threading.Lock()
        self._alerts = {(o.name, r.severity): _Alert(o, r)
                        for o in self.objectives for r in self.rules}
        self._history: deque = deque(maxlen=int(history_limit))
        self._last_ratio: Dict[str, Optional[float]] = {}

    def attach(self) -> "SLOEngine":
        """Subscribe to the ring so every sample evaluates the rules."""
        self.ring.add_listener(self.evaluate)
        return self

    def evaluate(self):
        """One pass over every objective and rule: advance the state
        machines, export gauges, record transitions. Safe to call
        concurrently (sampler thread + verdict endpoints)."""
        now = self._time()
        trips = []
        with self._lock:
            for obj in self.objectives:
                ratio_cache: Dict[float, Optional[float]] = {}

                def ratio(window_s, _obj=obj, _cache=ratio_cache):
                    if window_s not in _cache:
                        _cache[window_s] = _obj.error_ratio(self.ring,
                                                            window_s)
                    return _cache[window_s]

                for rule in self.rules:
                    r_long = ratio(rule.long_window_s)
                    r_short = ratio(rule.short_window_s)
                    burn_long = (None if r_long is None
                                 else r_long / obj.budget)
                    burn_short = (None if r_short is None
                                  else r_short / obj.budget)
                    alert = self._alerts[(obj.name, rule.severity)]
                    event = alert.update(now, burn_long, burn_short)
                    self._export(obj, rule, alert)
                    if event is not None:
                        self._history.append(
                            {"unix": round(self._wall(), 3),
                             "objective": obj.name,
                             "severity": rule.severity, "event": event,
                             "burn_long": _round(burn_long),
                             "burn_short": _round(burn_short),
                             "burn_threshold": rule.burn_threshold,
                             "reason": obj.reason})
                        metrics.counter(
                            "slo_alerts_total",
                            "Burn-rate alert transitions",
                            labels=("objective", "severity", "event"),
                        ).inc(objective=obj.name, severity=rule.severity,
                              event=event)
                        if event == "fired":
                            trips.append((obj, rule, burn_long, burn_short))
                # compliance gauge over the first (page) rule's long
                # window — the at-a-glance "how are we doing" number
                r0 = ratio(self.rules[0].long_window_s)
                good = None if r0 is None else 1.0 - r0
                self._last_ratio[obj.name] = good
                if good is not None:
                    metrics.gauge(
                        "slo_objective_ratio",
                        "Measured good fraction per objective over the "
                        "page rule's long window",
                        labels=("objective",)).set(round(good, 6),
                                                   objective=obj.name)
        # postmortems OUTSIDE the engine lock: trip() writes a file, and
        # a slow disk must not stall the sampler or a verdict endpoint
        for obj, rule, burn_long, burn_short in trips:
            self._trip(obj.reason, objective=obj.name,
                       severity=rule.severity,
                       burn_long=_round(burn_long),
                       burn_short=_round(burn_short),
                       burn_threshold=rule.burn_threshold,
                       long_window_s=rule.long_window_s,
                       short_window_s=rule.short_window_s,
                       target=obj.target)

    def _export(self, obj: Objective, rule: BurnRule, alert: _Alert):
        burn_gauge = metrics.gauge(
            "slo_burn_rate",
            "Error-budget burn rate per objective, severity and window "
            "(1.0 = spending exactly the budget)",
            labels=("objective", "severity", "window"))
        if alert.burn_long is not None:
            burn_gauge.set(round(alert.burn_long, 6), objective=obj.name,
                           severity=rule.severity, window="long")
        if alert.burn_short is not None:
            burn_gauge.set(round(alert.burn_short, 6), objective=obj.name,
                           severity=rule.severity, window="short")
        metrics.gauge(
            "slo_alert_state",
            "Alert state per objective and severity: 0=inactive "
            "1=pending 2=firing",
            labels=("objective", "severity")).set(
            alert.state, objective=obj.name, severity=rule.severity)

    def verdict(self) -> dict:
        """The GET /v1/slo document: per-objective burns and alert
        states plus recent transitions. Evaluates fresh first, so the
        verdict is as current as the newest sample."""
        self.evaluate()
        with self._lock:
            objectives = []
            worst = STATE_INACTIVE
            for obj in self.objectives:
                alerts = [self._alerts[(obj.name, r.severity)]
                          for r in self.rules]
                worst = max([worst] + [a.state for a in alerts])
                doc = obj.describe()
                doc["ratio"] = _round(self._last_ratio.get(obj.name), 6)
                doc["alerts"] = [a.describe() for a in alerts]
                objectives.append(doc)
            history = list(self._history)[-32:]
        state = "ok" if worst == STATE_INACTIVE else _STATE_NAMES[worst]
        return {"enabled": True, "now_unix": round(self._wall(), 3),
                "state": state, "objectives": objectives,
                "history": history}

    def history(self) -> List[dict]:
        """Every recorded alert transition, oldest first."""
        with self._lock:
            return list(self._history)

    def alert_state(self, objective: str, severity: str) -> str:
        with self._lock:
            alert = self._alerts.get((objective, severity))
            return _STATE_NAMES[alert.state] if alert else "unknown"


def router_objectives(slo_p99_ms: Optional[float] = None,
                      availability_target: Optional[float] = None,
                      bad_code: Callable[[str], bool] = default_bad_code,
                      ) -> List[Objective]:
    """The router-side objectives the fleet CLI wires from --slo-*
    flags: availability over serving_router_requests_total, and the
    p99 latency SLO over serving_router_request_seconds — preserving
    the historical --slo-p99-ms semantics and its `p99_breach`
    postmortem reason (the every-16th-sample check this engine
    replaced)."""
    out = []
    if availability_target is not None:
        out.append(Objective("router_availability", "availability",
                             "serving_router_requests_total",
                             availability_target, bad_code=bad_code,
                             reason="slo_availability_burn"))
    if slo_p99_ms is not None:
        out.append(Objective("router_latency_p99", "latency",
                             "serving_router_request_seconds", 0.99,
                             threshold_s=float(slo_p99_ms) / 1e3,
                             reason="p99_breach"))
    return out


def server_objectives(slo_p99_ms: Optional[float] = None,
                      availability_target: Optional[float] = None,
                      bad_code: Callable[[str], bool] = default_bad_code,
                      ) -> List[Objective]:
    """Replica-side equivalents over serving_requests_total /
    serving_request_seconds (subprocess replicas run their own engine,
    aggregated by the router's /v1/slo fan-out)."""
    out = []
    if availability_target is not None:
        out.append(Objective("availability", "availability",
                             "serving_requests_total",
                             availability_target, bad_code=bad_code,
                             reason="slo_availability_burn"))
    if slo_p99_ms is not None:
        out.append(Objective("latency_p99", "latency",
                             "serving_request_seconds", 0.99,
                             threshold_s=float(slo_p99_ms) / 1e3,
                             reason="p99_breach"))
    return out


# -------------------------------------------------------------------------
# process-default engine — same zero-cost seam as the ring: nothing
# exists or evaluates until enable_slo().
_module_lock = threading.Lock()
_engine: Optional[SLOEngine] = None


def enable_slo(objectives: Sequence[Objective],
               rules: Sequence[BurnRule] = DEFAULT_RULES,
               ring: Optional[TimeSeriesRing] = None, **kw) -> SLOEngine:
    """Install the process-default engine over `ring` (default: the
    default time-series ring, which must be enabled first) and attach
    it so every sample evaluates the rules. Returns the existing engine
    when one is already installed."""
    global _engine
    from deeplearning4j_tpu_torch.monitor import timeseries
    if ring is None:
        ring = timeseries.default_ring()
        if ring is None:
            raise RuntimeError("enable_slo needs enable_timeseries() "
                               "first (or an explicit ring=)")
    with _module_lock:
        if _engine is None:
            _engine = SLOEngine(ring, objectives, rules=rules,
                                **kw).attach()
        return _engine


def disable_slo():
    """Drop the process-default engine (idempotent). Disable before
    `timeseries.disable_timeseries()` — an attached engine evaluates on
    every sample of whatever ring it holds."""
    global _engine
    with _module_lock:
        _engine = None


def slo_enabled() -> bool:
    return _engine is not None


def default_engine() -> Optional[SLOEngine]:
    """The process-default engine, or None while disabled."""
    return _engine
