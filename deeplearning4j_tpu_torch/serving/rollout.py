"""SLO-gated continuous rollout: checkpoint -> canary -> verdict ->
promote / auto-rollback.

Counterpart of the JAX package's `serving/rollout.py` (framework-neutral:
no torch). The missing loop between training and serving: ResilientTrainer
writes checkpoints (and, through its eval gate or
``CheckpointManager.bless``, a ``blessed.json`` manifest naming the one
that passed eval); the RolloutController here tails that
manifest, deploys the new version as a **canary on one replica** behind
the ResilientRouter (the router keeps the canary's live-traffic share
bounded — see ``ResilientRouter.canary_fraction``), judges it over a
bounded observation window, then either **promotes fleet-wide** with a
staggered swap fan-out or **auto-rolls back**, firing a
``flight.trip("rollout_rejected")`` postmortem that names the regressing
metric and the slow trace ids.

Verdict inputs (all fetched per replica over the same transport the
router uses, so fakes in tests work unchanged):

- **accuracy probe set** — deterministic labelled examples POSTed to the
  canary right after deploy; a model that scrambles its outputs is
  rejected in seconds, before real traffic is burned;
- **availability** — the canary replica's own ``/v1/slo`` verdict
  (monitor/slo.py's burn-rate engine) vs the incumbents';
- **latency** — ``/v1/timeseries`` p99 of ``serving_request_seconds``
  over the observation window, canary vs incumbent. The window opens
  when the canary's swap returns (the port's one departure from the
  reference, whose window opens before the swap call): the swap loads
  and warms the candidate's whole bucket ladder first, so the requests
  the replica answered as the incumbent while it loaded the candidate
  are not counted as the candidate's.

While a rollout is in flight the controller *holds the fleet admin
surface*: manual ``swap``/``rollback`` fan-outs through the RouterServer
are refused with 409 (they would interleave with the canary/promote
sequence and fork the fleet's version history).

Deliberately tick()-driven with injectable time/sleep/transport seams —
the same testing contract as ReplicaSupervisor — so every decision path
is unit-testable without wall-clock waits.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

#: controller states, also exported as the serving_rollout_state gauge
ROLLOUT_STATES = ("idle", "canary", "promoting", "rolling_back")


def read_blessed(directory: str) -> Optional[dict]:
    """The trainer-side blessing contract (CheckpointManager.bless):
    ``<dir>/blessed.json`` names the newest eval-approved checkpoint.
    Returns the manifest dict with ``path`` resolved to an existing
    file, or None (no blessing yet, or the blessed file vanished)."""
    manifest = os.path.join(directory, "blessed.json")
    try:
        with open(manifest) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    path = doc.get("path")
    if not path and doc.get("file"):
        path = os.path.join(directory, doc["file"])
    if not path or not os.path.exists(path):
        return None
    doc["path"] = path
    return doc


def _latest_manifest_entry(directory: str) -> Optional[dict]:
    """Raw-directory watch mode: newest manifest.json entry whose file
    exists. Read-only — no CheckpointManager instantiation (its init
    sweeps tmp files, which a watcher must not do to a live trainer's
    directory)."""
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    for entry in reversed(manifest.get("checkpoints", [])):
        path = os.path.join(directory, entry.get("file", ""))
        if entry.get("file") and os.path.exists(path):
            return {**entry, "path": path}
    return None


class RolloutController:
    """Watch a checkpoint directory, canary new versions, promote or
    roll back on SLO evidence.

    Parameters:

    - ``supervisor`` / ``router`` — the fleet being rolled;
    - ``directory`` — checkpoint dir to tail; ``watch`` selects the
      eval-gated ``blessed.json`` manifest (default) or the raw
      ``latest`` manifest entry;
    - ``model`` — served model name the rollout swaps;
    - ``observe_s`` — canary observation window; the verdict is taken
      at its end (extended up to ``observe_extend`` × while the canary
      has seen fewer than ``min_canary_requests`` requests);
    - ``max_error_ratio_increase`` — canary error ratio may exceed the
      incumbents' by at most this much;
    - ``max_p99_ratio`` / ``p99_floor_ms`` — canary p99 may be at most
      ``max_p99_ratio`` × incumbent p99, ignored below the floor (a
      3 ms vs 1 ms "regression" is noise, not a verdict);
    - ``probe_set`` — optional ``[(example, expected_class), ...]``
      accuracy probes POSTed to the canary immediately after deploy;
      accuracy below ``probe_min_accuracy`` rejects on the spot;
    - ``promote_stagger_s`` — pause between per-replica swaps during
      fleet-wide promotion (one bad swap aborts before the fleet turns).

    time_fn / wall_fn / sleep_fn / transport are injectable seams;
    tests drive ``tick(now)`` directly and never touch the wall clock.
    """

    def __init__(self, supervisor, router, directory: str, model: str,
                 watch: str = "blessed",
                 poll_interval_s: float = 5.0,
                 observe_s: float = 30.0,
                 observe_extend: float = 3.0,
                 min_canary_requests: int = 20,
                 max_error_ratio_increase: float = 0.02,
                 max_p99_ratio: float = 1.5,
                 p99_floor_ms: float = 10.0,
                 probe_set: Optional[Sequence[Tuple[object, int]]] = None,
                 probe_min_accuracy: float = 0.8,
                 promote_stagger_s: float = 1.0,
                 admin_timeout_s: float = 30.0,
                 time_fn: Callable[[], float] = time.monotonic,
                 wall_fn: Callable[[], float] = time.time,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 transport=None):
        if watch not in ("blessed", "latest"):
            raise ValueError(f"watch must be 'blessed' or 'latest', "
                             f"got {watch!r}")
        if observe_s <= 0 or poll_interval_s <= 0:
            raise ValueError("observe_s and poll_interval_s must be > 0")
        if not 0.0 <= float(probe_min_accuracy) <= 1.0:
            raise ValueError("probe_min_accuracy must be in [0, 1]")
        if float(max_p99_ratio) < 1.0:
            raise ValueError("max_p99_ratio must be >= 1.0")
        self.supervisor = supervisor
        self.router = router
        self.directory = directory
        self.model = model
        self.watch = watch
        self.poll_interval_s = float(poll_interval_s)
        self.observe_s = float(observe_s)
        self.observe_extend = max(1.0, float(observe_extend))
        self.min_canary_requests = int(min_canary_requests)
        self.max_error_ratio_increase = float(max_error_ratio_increase)
        self.max_p99_ratio = float(max_p99_ratio)
        self.p99_floor_ms = float(p99_floor_ms)
        self.probe_set = list(probe_set) if probe_set else None
        self.probe_min_accuracy = float(probe_min_accuracy)
        self.promote_stagger_s = float(promote_stagger_s)
        self.admin_timeout_s = float(admin_timeout_s)
        self._time = time_fn
        self._wall = wall_fn
        self._sleep = sleep_fn
        self._transport = transport if transport is not None \
            else router._transport
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.rollout.RolloutController._lock")
        self.state = "idle"
        self.rollout_generation = 0
        self.canary: Optional[dict] = None
        self.last_verdict: Optional[dict] = None
        self.history: List[dict] = []
        #: identities (sha256 / file) already decided — a rejected
        #: checkpoint must not be re-canaried every poll
        self._decided = set()
        self.current_source = self._incumbent_source()
        self._next_poll = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ plumbing
    def _incumbent_source(self) -> Optional[str]:
        for r in self.supervisor.replicas:
            if r.spec is None:
                continue
            for name, src in list(r.spec.models) + list(r.spec.lms):
                if name == self.model:
                    return src
        return None

    def holds_admin(self) -> bool:
        """True while a rollout is using the fleet admin surface —
        RouterServer refuses manual swap/rollback with 409 meanwhile."""
        with self._lock:
            return self.state != "idle"

    def describe(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "model": self.model,
                    "watch": self.watch,
                    "directory": self.directory,
                    "rollout_generation": self.rollout_generation,
                    "current_source": self.current_source,
                    "canary": dict(self.canary) if self.canary else None,
                    "last_verdict": self.last_verdict,
                    "decisions": list(self.history[-16:])}

    def _set_state(self, state: str):
        # callers hold self._lock
        self.state = state
        monitor.gauge("serving_rollout_state",
                      "RolloutController state "
                      "(0 idle, 1 canary, 2 promoting, 3 rolling_back)"
                      ).set(float(ROLLOUT_STATES.index(state)))

    # -------------------------------------------------------------- thread
    def start(self, interval_s: Optional[float] = None):
        """Run the controller loop in a background thread (tick every
        ``interval_s``, default min(1, poll_interval_s))."""
        if self._thread is not None:
            return self
        tick_every = float(interval_s) if interval_s is not None \
            else min(1.0, self.poll_interval_s)
        self._stop.clear()

        def _loop():
            while not self._stop.wait(tick_every):
                try:
                    self.tick()
                except Exception:       # noqa: BLE001 — a crashed
                    # controller loop would silently freeze rollouts;
                    # log loud and keep ticking
                    log.exception("rollout: tick failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="rollout-controller")
        self._thread.start()
        log.info("rollout: watching %s (%s) for model %r",
                 self.directory, self.watch, self.model)
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    # ---------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None):
        """One deterministic control-loop step."""
        now = self._time() if now is None else now
        with self._lock:
            state = self.state
        if state == "idle":
            if now < self._next_poll:
                return
            self._next_poll = now + self.poll_interval_s
            cand = self._poll_source()
            if cand is not None:
                self._start_canary(cand, now)
        elif state == "canary":
            self._observe(now)
        # promoting / rolling_back are transient within a single tick

    # -------------------------------------------------------------- watch
    def _poll_source(self) -> Optional[dict]:
        """Next undecided candidate: {"path", "identity", ...} or None."""
        doc = read_blessed(self.directory) if self.watch == "blessed" \
            else _latest_manifest_entry(self.directory)
        if doc is None:
            return None
        identity = doc.get("sha256") or f"file:{os.path.basename(doc['path'])}"
        if identity in self._decided or doc["path"] == self.current_source:
            return None
        return {"path": doc["path"], "identity": identity,
                "metrics": doc.get("metrics"),
                "iteration": doc.get("iteration")}

    # ------------------------------------------------------------- canary
    def _admin(self, replica, verb: str, body: Optional[dict] = None):
        """POST /v1/models/{model}/{verb} to ONE replica (not fan_out —
        the whole point of a canary is one replica at a time). Returns
        (ok, response_doc)."""
        payload = json.dumps(body or {}).encode("utf-8")
        from deeplearning4j_tpu_torch.serving.router import ReplicaTransportError
        try:
            code, _, raw = self._transport(
                replica, f"/v1/models/{self.model}/{verb}", payload,
                {"Content-Type": "application/json"}, self.admin_timeout_s)
        except ReplicaTransportError as e:
            return False, {"error": str(e)}
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            doc = {}
        return code == 200, doc

    def _pick_canary_replica(self):
        ready = [r for r in self.supervisor.healthy()
                 if r.role != "canary"
                 and getattr(r, "scaledown", None) is None]
        if len(ready) < 2:
            # never canary the only serving replica: a bad version
            # would take 100% of traffic, which is exactly what a
            # canary exists to prevent
            return None
        return min(ready, key=lambda r: r.inflight())

    def _start_canary(self, cand: dict, now: float):
        replica = self._pick_canary_replica()
        if replica is None:
            log.info("rollout: candidate %s waiting — need >= 2 ready "
                     "replicas to canary", cand["identity"])
            return
        t_swap = self._time()
        ok, doc = self._admin(replica, "swap", {"source": cand["path"]})
        # the canary is observed from the moment its swap returns (the
        # candidate live, its whole bucket ladder warmed by the swap):
        # what the replica answered as the incumbent while it loaded the
        # candidate is not counted as the candidate's latency
        now = now + (self._time() - t_swap)
        if not ok:
            self._decided.add(cand["identity"])
            monitor.counter("serving_rollout_deploy_failures_total",
                            "Canary deploy (swap) attempts that failed"
                            ).inc()
            decision = {"decision": "deploy_failed", "at": self._wall(),
                        "source": cand["path"],
                        "identity": cand["identity"],
                        "error": doc.get("error")}
            with self._lock:
                self.history.append(decision)
                self.last_verdict = decision
            log.error("rollout: canary deploy of %s on %s failed: %s",
                      cand["path"], replica.name, doc.get("error"))
            return
        with self._lock:
            self.rollout_generation += 1
            gen = self.rollout_generation
            self.canary = {
                "replica": replica.name,
                "replica_generation": replica.generation,
                "source": cand["path"],
                "identity": cand["identity"],
                "started_unix": self._wall(),
                "started": now,
                "observe_until": now + self.observe_s,
                "deadline": now + self.observe_s * self.observe_extend,
            }
            self._set_state("canary")
        replica.set_role("canary", gen)
        monitor.counter("serving_rollout_canaries_total",
                        "Canary deployments started").inc()
        log.warning("rollout: canary %s -> %s (gen %d, observing %.0fs)",
                    cand["path"], replica.name, gen, self.observe_s)
        # deterministic fast path: labelled probes catch a garbage model
        # in seconds, before live traffic has to burn for the verdict
        acc = self._run_probes(replica)
        if acc is not None and acc < self.probe_min_accuracy:
            self._reject(replica, "probe_accuracy", now,
                         details={"probe_accuracy": round(acc, 4),
                                  "probe_floor": self.probe_min_accuracy})

    def _run_probes(self, replica) -> Optional[float]:
        """Accuracy over the probe set against the canary replica, or
        None when no probe set is configured / nothing could be scored."""
        if not self.probe_set:
            return None
        from deeplearning4j_tpu_torch.serving.router import ReplicaTransportError
        correct = scored = 0
        for example, expected in self.probe_set:
            body = json.dumps(
                {"inputs": [np.asarray(example).tolist()]}).encode("utf-8")
            try:
                code, _, raw = self._transport(
                    replica, f"/v1/models/{self.model}/predict", body,
                    {"Content-Type": "application/json"}, 10.0)
            except ReplicaTransportError:
                continue
            if code != 200:
                continue
            try:
                outputs = json.loads(raw).get("outputs")
                pred = int(np.argmax(np.asarray(outputs[0])))
            except (ValueError, TypeError, IndexError):
                continue
            scored += 1
            correct += int(pred == int(expected))
        return correct / scored if scored else None

    # ------------------------------------------------------------- verdict
    def _replica_stats(self, replica, window_s: float) -> dict:
        """Verdict inputs from one replica: /v1/slo (availability burn)
        + /v1/timeseries (windowed p99 + request count)."""
        from deeplearning4j_tpu_torch.serving.router import ReplicaTransportError
        out = {"requests": None, "error_ratio": None, "p99_ms": None,
               "slo_state": None}
        try:
            code, _, raw = self._transport(replica, "/v1/slo", None, {}, 5.0)
            doc = json.loads(raw) if code == 200 else {}
        except (ReplicaTransportError, ValueError):
            doc = {}
        if doc.get("enabled"):
            out["slo_state"] = doc.get("state")
            for obj in doc.get("objectives", []):
                if obj.get("kind") == "availability":
                    # the engine exports the measured GOOD fraction
                    ratio = obj.get("ratio")
                    out["error_ratio"] = (None if ratio is None
                                          else round(1.0 - ratio, 6))
                    break
        path = (f"/v1/timeseries?series=serving_request_seconds"
                f"&window={window_s:g}&model={self.model}")
        try:
            code, _, raw = self._transport(replica, path, None, {}, 5.0)
            doc = json.loads(raw) if code == 200 else {}
        except (ReplicaTransportError, ValueError):
            doc = {}
        if doc.get("enabled") and "error" not in doc:
            out["requests"] = doc.get("count")
            p99 = doc.get("p99")
            out["p99_ms"] = None if p99 is None else p99 * 1e3
        return out

    def _slow_traces(self, replica, limit: int = 5) -> List[str]:
        """Slowest recent trace ids from the canary's flight recorder —
        the postmortem names the requests that burned the budget."""
        from deeplearning4j_tpu_torch.serving.router import ReplicaTransportError
        try:
            code, _, raw = self._transport(replica, "/v1/debug/flight",
                                           None, {}, 5.0)
            doc = json.loads(raw) if code == 200 else {}
        except (ReplicaTransportError, ValueError):
            return []
        records = [r for r in doc.get("records", [])
                   if r.get("trace_id") and r.get("duration_ms") is not None]
        records.sort(key=lambda r: r["duration_ms"], reverse=True)
        return [r["trace_id"] for r in records[:limit]]

    @staticmethod
    def _aggregate(stats: List[dict]) -> dict:
        """Pool incumbent stats: request-weighted when counts exist."""
        out = {"requests": None, "error_ratio": None, "p99_ms": None,
               "firing": False}
        reqs = [s["requests"] for s in stats if s["requests"]]
        if reqs:
            out["requests"] = sum(reqs)
        ers = [s["error_ratio"] for s in stats
               if s["error_ratio"] is not None]
        if ers:
            out["error_ratio"] = sum(ers) / len(ers)
        p99s = [s["p99_ms"] for s in stats if s["p99_ms"] is not None]
        if p99s:
            out["p99_ms"] = sorted(p99s)[len(p99s) // 2]     # median
        out["firing"] = any(s["slo_state"] == "firing" for s in stats)
        return out

    def _observe(self, now: float):
        with self._lock:
            canary = dict(self.canary) if self.canary else None
        if canary is None:                    # raced with stop/reject
            return
        replica = next((r for r in self.supervisor.replicas
                        if r.name == canary["replica"]), None)
        if (replica is None
                or replica.generation != canary["replica_generation"]
                or replica.state in ("dead", "stopped")):
            # the canary crashed or was replaced mid-evaluation; its
            # relaunch loaded the INCUMBENT spec (canary deploys never
            # rewrite ReplicaSpec), so there is nothing to swap back —
            # just record the rejection
            self._reject(replica, "canary_crashed", now, swap_back=False)
            return
        if now < canary["observe_until"]:
            return
        window = max(now - canary["started"], 1.0)
        canary_stats = self._replica_stats(replica, window)
        if ((canary_stats["requests"] or 0) < self.min_canary_requests
                and now < canary["deadline"]):
            return                            # extend: not enough evidence
        incumbents = [r for r in self.supervisor.healthy()
                      if r.name != replica.name and r.role != "canary"]
        base = self._aggregate(
            [self._replica_stats(r, window) for r in incumbents])
        metric, details = self._verdict(canary_stats, base)
        if metric is None:
            self._promote(replica, canary, now,
                          {"canary": canary_stats, "incumbent": base})
        else:
            details.update({"canary": canary_stats, "incumbent": base})
            self._reject(replica, metric, now, details=details)

    def _verdict(self, c: dict, base: dict):
        """(regressing_metric, details) — metric None means promote."""
        if (c["requests"] or 0) < self.min_canary_requests:
            return "insufficient_traffic", {
                "canary_requests": c["requests"] or 0,
                "required": self.min_canary_requests}
        if c["slo_state"] == "firing" and not base["firing"]:
            return "slo_burn", {"canary_slo_state": c["slo_state"]}
        if c["error_ratio"] is not None:
            allowed = (base["error_ratio"] or 0.0) \
                + self.max_error_ratio_increase
            if c["error_ratio"] > allowed:
                return "error_ratio", {
                    "canary_error_ratio": round(c["error_ratio"], 6),
                    "allowed_error_ratio": round(allowed, 6)}
        if (c["p99_ms"] is not None and base["p99_ms"] is not None
                and c["p99_ms"] > self.p99_floor_ms
                and c["p99_ms"] > base["p99_ms"] * self.max_p99_ratio):
            return "latency_p99", {
                "canary_p99_ms": round(c["p99_ms"], 3),
                "incumbent_p99_ms": round(base["p99_ms"], 3),
                "max_p99_ratio": self.max_p99_ratio}
        return None, {}

    # ------------------------------------------------------------- promote
    def _promote(self, replica, canary: dict, now: float, stats: dict):
        with self._lock:
            self._set_state("promoting")
            gen = self.rollout_generation
        t0 = self._time()
        targets = [r for r in self.supervisor.healthy()
                   if r.name != replica.name and r.role != "canary"
                   and getattr(r, "scaledown", None) is None]
        swapped = []
        failed = None
        for i, target in enumerate(targets):
            if i and self.promote_stagger_s > 0:
                self._sleep(self.promote_stagger_s)
            ok, doc = self._admin(target, "swap",
                                  {"source": canary["source"]})
            if not ok:
                failed = (target, doc.get("error"))
                break
            swapped.append(target)
        if failed is not None:
            # one bad swap aborts the fan-out and reverts the replicas
            # already turned — a half-promoted fleet is the worst state
            target, err = failed
            log.error("rollout: promote swap failed on %s (%s); "
                      "reverting %d already-swapped replicas",
                      target.name, err, len(swapped))
            for r in swapped:
                self._admin(r, "rollback")
            self._reject(replica, "promote_swap_failed", now,
                         details={"failed_replica": target.name,
                                  "error": err, "reverted":
                                      [r.name for r in swapped]})
            return
        # restart durability (same contract as RouterServer swap): a
        # replica relaunched later must come up on the promoted source
        for r in self.supervisor.replicas:
            if r.spec is not None:
                r.spec.models = [(n, canary["source"] if n == self.model
                                  else s) for n, s in r.spec.models]
                r.spec.lms = [(n, canary["source"] if n == self.model
                               else s) for n, s in r.spec.lms]
        replica.set_role("stable", gen)
        for r in targets:
            r.set_role("stable", gen)
        promote_s = self._time() - t0
        decision = {"decision": "promoted", "at": self._wall(),
                    "source": canary["source"],
                    "identity": canary["identity"],
                    "replicas": [replica.name] + [r.name for r in targets],
                    "observe_s": round(now - canary["started"], 3),
                    "promote_s": round(promote_s, 3),
                    "stats": stats}
        with self._lock:
            self._decided.add(canary["identity"])
            self.current_source = canary["source"]
            self.canary = None
            self.last_verdict = decision
            self.history.append(decision)
            self._set_state("idle")
        monitor.counter("serving_rollout_promotions_total",
                        "Canaries promoted fleet-wide").inc()
        monitor.histogram("serving_rollout_promote_seconds",
                          "Fleet-wide staggered promotion fan-out "
                          "duration").observe(promote_s)
        log.warning("rollout: PROMOTED %s fleet-wide (%d replicas, "
                    "%.2fs fan-out)", canary["source"],
                    1 + len(targets), promote_s)

    # ------------------------------------------------------------ rollback
    def _reject(self, replica, metric: str, now: float,
                details: Optional[dict] = None, swap_back: bool = True):
        with self._lock:
            canary = dict(self.canary) if self.canary else {}
            self._set_state("rolling_back")
            gen = self.rollout_generation
        slow = self._slow_traces(replica) if replica is not None else []
        rolled_back = False
        if swap_back and replica is not None:
            ok, doc = self._admin(replica, "rollback")
            rolled_back = ok
            if not ok:
                # the replica still serves the rejected version — kill
                # it so the supervisor relaunches from the (incumbent)
                # ReplicaSpec; loud, but strictly better than leaving a
                # known-bad canary in the routing set
                log.error("rollout: rollback on %s failed (%s) — killing "
                          "so the supervisor relaunches on the incumbent",
                          replica.name, doc.get("error"))
                replica.kill()
        if replica is not None:
            replica.set_role("stable", gen)
        # decision-time clock, not tick-start `now`: a probe rejection
        # spends its detection latency INSIDE this tick (probe POSTs,
        # rollback), and that time belongs in the banked detect series
        decided = self._time()
        detect_s = decided - canary.get("started", now if now is not None
                                        else decided)
        decision = {"decision": "rejected", "at": self._wall(),
                    "metric": metric,
                    "source": canary.get("source"),
                    "identity": canary.get("identity"),
                    "replica": canary.get("replica"),
                    "detect_s": round(detect_s, 3),
                    "rolled_back": rolled_back,
                    "slow_traces": slow,
                    "details": details or {}}
        with self._lock:
            if canary.get("identity"):
                self._decided.add(canary["identity"])
            self.canary = None
            self.last_verdict = decision
            self.history.append(decision)
            self._set_state("idle")
        monitor.counter("serving_rollout_rollbacks_total",
                        "Canaries auto-rolled back by regressing metric",
                        labels=("metric",)).inc(metric=metric)
        monitor.histogram("serving_rollout_rollback_detect_seconds",
                          "Canary deploy -> rollback decision latency",
                          buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0,
                                   300.0, 600.0)).observe(detect_s)
        # the postmortem is the rollout's receipt: WHAT regressed, WHICH
        # requests burned, and the exact source that was rejected.
        # Tripped outside the lock (flight dumps to disk).
        flight.trip("rollout_rejected", model=self.model, metric=metric,
                    source=canary.get("source"),
                    canary_replica=canary.get("replica"),
                    detect_s=round(detect_s, 3),
                    slow_traces=slow or None,
                    **{k: v for k, v in (details or {}).items()
                       if isinstance(v, (int, float, str, bool))})
        log.error("rollout: REJECTED %s — regressing metric %r "
                  "(detected in %.1fs, rolled_back=%s)",
                  canary.get("source"), metric, detect_s, rolled_back)
