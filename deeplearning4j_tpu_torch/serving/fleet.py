"""ReplicaSupervisor — process supervision for a fleet of serving replicas.

Counterpart of the JAX package's `serving/fleet.py`. `ResilientTrainer`
makes *training* survive faults; this module is the serving counterpart
at fleet scope. One replica crash, one wedged batcher,
or one slow model must never take the endpoint down: the supervisor runs N
model-serving replicas, watches them the way a container runtime watches
pods, and keeps the fleet converged on "N healthy":

- **Probes with deadlines.** Every supervision tick, each replica is
  health-checked over its own HTTP surface: ``/healthz`` (liveness) then
  ``/readyz`` (warmed + not draining), each under ``probe_timeout_s``. A
  wedged replica — event loop alive but the process stuck — answers
  slowly or not at all; the deadline converts "slow" into "failed",
  which a bare TCP connect check never would.
- **Crash restarts with jittered exponential backoff.** A replica whose
  process died (SIGKILL, OOM, segfault) is relaunched after
  ``backoff * 2^attempt`` seconds, jittered to half its value so a
  correlated fleet-wide crash does not produce a synchronized restart
  stampede against the checkpoint store.
- **Drain + replace after K consecutive probe failures.** A replica that
  is alive but failed ``unhealthy_after`` probes in a row is presumed
  wedged: it is killed (a wedged process cannot be trusted to drain) and
  replaced by a fresh incarnation, bumping ``replica.generation`` so the
  router's circuit breakers start clean.
- **Restart budget.** More than ``restart_budget`` restarts inside
  ``restart_budget_window_s`` marks the replica ``dead`` (crash-looping —
  a bad model, a poisoned checkpoint, a broken host); the supervisor
  stops burning capacity on it and the gap shows on /metrics
  (`serving_fleet_replicas{state="dead"}`) for a human to page on.

Replicas come in two shapes sharing the `Replica` contract:
`SubprocessReplica` (a real ``python -m deeplearning4j_tpu_torch.serving``
process — full isolation, SIGKILL-able, its own CUDA context, what
`deeplearning4j_tpu_torch.tools.serve_chaos` drives) and
`InProcessReplica` (a ModelServer in this process — cheap, what most
tests drive). The supervision logic never cares which.

Every replica runs its networks on ``ReplicaSpec.device`` (default
``"cuda"``), passed explicitly to each incarnation: a subprocess replica
gets ``--device``, an in-process one a ``ModelRegistry(device=...)``.
Nothing falls back to the CPU — a replica that cannot start on the card
fails its launch, and the restart budget marks it dead.

Determinism: the supervision loop is a thin timer around `tick()`, and
`tick()` plus the injectable `time_fn` / `rng` / `probe_fn` seams make
every policy decision (backoff arithmetic, budget exhaustion, K-failure
replacement) unit-testable with a fake clock — no sleeps-and-hope.
"""
from __future__ import annotations

import json
import logging
import os
import queue as _queue
import subprocess
import sys
import threading
import time
import random as _random
import urllib.error
import urllib.request
from typing import Callable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

#: replica lifecycle states (the serving_fleet_replicas{state} gauge keys).
#: "draining" is the autoscaler's scale-down limbo: out of the routing
#: set, finishing in-flight work, /readyz already answering not-ready.
REPLICA_STATES = ("starting", "ready", "unhealthy", "backoff", "dead",
                  "stopped", "draining")

#: rollout roles a replica can hold (serving/rollout.py sets these;
#: the router's canary split and /v1/fleet read them)
REPLICA_ROLES = ("stable", "canary")


class ReplicaSpec:
    """What one replica serves: the deploy arguments every incarnation of
    the replica is (re)built from."""

    def __init__(self, models: Sequence[Tuple[str, object]],
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 max_delay_ms: float = 5.0, queue_limit: int = 256,
                 default_deadline_s: float = 30.0,
                 host: str = "127.0.0.1",
                 enable_faults: bool = False,
                 lms: Sequence[Tuple[str, object]] = (),
                 decode=None,
                 trace_out: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 flight: bool = True,
                 flight_records: int = 512,
                 slo_availability: Optional[float] = None,
                 slo_p99_ms: Optional[float] = None,
                 slo_sample_interval_s: float = 5.0,
                 slo_windows: Optional[str] = None,
                 kv_role: str = "mixed",
                 device: str = "cuda"):
        self.models = list(models)              # [(name, source), ...]
        self.buckets = tuple(int(b) for b in buckets)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = float(default_deadline_s)
        self.host = host
        self.enable_faults = bool(enable_faults)
        #: decode (LM) servables: [(name, source), ...] + one shared
        #: DecodeConfig (serving/decode.py); None decode = library default
        self.lms = list(lms)
        self.decode = decode
        #: base trace path: subprocess replicas save their own segment
        #: to <stem>.<replica-name><ext> on graceful drain, so
        #: a trace merge can stitch the whole fleet
        self.trace_out = trace_out
        #: flight-recorder postmortem directory threaded to every replica
        self.postmortem_dir = postmortem_dir
        #: flight-recorder opt-out + ring size, threaded to every replica
        #: (an operator's --no-flight must disable the WHOLE fleet's
        #: recorder, not just the router's)
        self.flight = bool(flight)
        self.flight_records = int(flight_records)
        #: replica-side SLO engine knobs (monitor/slo.py), threaded as
        #: --slo-* flags so each subprocess replica runs its own
        #: objectives and the router's /v1/slo fan-out aggregates them
        self.slo_availability = (None if slo_availability is None
                                 else float(slo_availability))
        self.slo_p99_ms = None if slo_p99_ms is None else float(slo_p99_ms)
        self.slo_sample_interval_s = float(slo_sample_interval_s)
        self.slo_windows = slo_windows
        #: default KV-fabric disaggregation role for replicas built from
        #: this spec; a factory may override per replica (replica.kv_role)
        #: for mixed prefill/decode fleets
        if kv_role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f'kv_role must be "prefill", "decode" or "mixed", '
                f"got {kv_role!r}")
        self.kv_role = kv_role
        #: torch device every incarnation runs its networks on; a string
        #: so it crosses the process boundary as the CLI's --device
        self.device = str(device)


class Replica:
    """One supervised serving replica. Subclasses provide the process
    mechanics (`launch` / `alive` / `kill` / `stop`); the supervisor and
    router only read the shared fields below."""

    def __init__(self, name: str, spec: Optional[ReplicaSpec] = None):
        self.name = name
        self.spec = spec
        self.url: Optional[str] = None
        self.state = "starting"
        self.generation = 0                  # bumps on every relaunch
        self.consecutive_probe_failures = 0
        # rollout state (serving/rollout.py): "canary" while this replica
        # serves a version under evaluation; rollout_generation bumps on
        # every rollout that touches the replica so operators can line up
        # /v1/fleet with the controller's decisions
        self.role = "stable"
        self.rollout_generation = 0
        # KV-fabric state: the disaggregation role this replica serves
        # under (spec default; factories override for split fleets) and
        # the prefix-ownership advertisement its /readyz heartbeat last
        # published ({model: {"block": N, "digests": [hex16...]}}) — the
        # router's affinity pick reads both
        self.kv_role = spec.kv_role if spec is not None else "mixed"
        self.kv_ownership: dict = {}
        # scale-down bookkeeping (autoscaler): None until this replica is
        # chosen as a drain victim, then a dict tracking the drain steps
        self.scaledown: Optional[dict] = None
        # router-maintained queue-depth signal (power-of-two-choices input)
        self._inflight = 0
        self._inflight_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.fleet.Replica._inflight_lock")
        # supervisor restart bookkeeping
        self.restart_attempt = 0             # backoff exponent
        self.restart_at: Optional[float] = None
        self.restart_times: List[float] = []  # budget window

    # ------------------------------------------------------------ inflight
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def inflight_add(self, delta: int):
        with self._inflight_lock:
            self._inflight = max(0, self._inflight + delta)

    # ------------------------------------------------- subclass contract
    def launch(self):
        """(Re)start the replica; must set `self.url` or raise."""
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def kill(self):
        """Hard-stop (crash analog / wedged process): no drain."""
        raise NotImplementedError

    def stop(self):
        """Graceful stop (drain in-flight work)."""
        self.kill()

    def begin_drain(self):
        """Start a graceful drain WITHOUT waiting for exit (the
        autoscaler's scale-down path): the replica should flip its own
        /readyz to not-ready and finish in-flight work; a later stop()
        reaps it. Default: nothing to signal — stop() does the drain."""

    def set_role(self, role: str, rollout_generation: int):
        """Mark this replica canary/stable (RolloutController). Subclasses
        propagate into the serving process so its own /readyz agrees with
        the fleet view."""
        self.role = role
        self.rollout_generation = int(rollout_generation)

    def describe(self) -> dict:
        doc = {"name": self.name, "url": self.url, "state": self.state,
               "generation": self.generation,
               "role": self.role,
               "rollout_generation": self.rollout_generation,
               "inflight": self.inflight(),
               "kv_role": self.kv_role,
               "probe_failures": self.consecutive_probe_failures}
        if self.kv_ownership:
            doc["kv_ownership"] = self.kv_ownership
        scaledown = getattr(self, "scaledown", None)
        if scaledown is not None:
            doc["scaledown"] = dict(scaledown)
        return doc


class InProcessReplica(Replica):
    """A ModelServer (own registry, own port) inside this process. Cheap
    replica for tests and single-host `--replica-mode inprocess` fleets;
    "crash" = hard listener+batcher stop without drain."""

    def __init__(self, name: str, spec: ReplicaSpec):
        super().__init__(name, spec)
        self._server = None
        self._registry = None

    def launch(self):
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
        from deeplearning4j_tpu_torch.serving.server import ModelServer
        from deeplearning4j_tpu_torch.util.faults import ServingFaults
        registry = ModelRegistry(device=self.spec.device)
        for model_name, source in self.spec.models:
            registry.deploy(model_name, source, buckets=self.spec.buckets,
                            max_delay_ms=self.spec.max_delay_ms,
                            queue_limit=self.spec.queue_limit)
        for model_name, source in self.spec.lms:
            registry.deploy_lm(model_name, source, decode=self.spec.decode)
        self._registry = registry
        self._server = ModelServer(
            registry, host=self.spec.host, port=0,
            default_deadline_s=self.spec.default_deadline_s,
            enable_faults=self.spec.enable_faults,
            # own instance: wedging THIS replica must not wedge every
            # in-process sibling through the module singleton
            faults=ServingFaults(),
            kv_role=self.kv_role)
        self.url = self._server.url

    def alive(self) -> bool:
        return self._server is not None and self._server._thread.is_alive()

    def kill(self):
        if self._server is not None:
            self._server.stop()
        if self._registry is not None:
            self._registry.shutdown(drain=False)
        self._server = self._registry = None

    def stop(self):
        if self._server is not None:
            self._server.drain(timeout=10.0)
        self._server = self._registry = None

    def begin_drain(self):
        if self._server is not None:
            self._server.draining = True     # /readyz -> 503 immediately

    def set_role(self, role: str, rollout_generation: int):
        super().set_role(role, rollout_generation)
        if self._server is not None:
            self._server.role = role
            self._server.rollout_generation = int(rollout_generation)


class SubprocessReplica(Replica):
    """A real ``python -m deeplearning4j_tpu_torch.serving`` child process —
    full crash isolation (SIGKILL-able, OOM-able), its own CUDA context,
    its own /metrics. The CLI fleet mode and the chaos drill run these.
    The child binds port 0 and announces its URL as the first JSON line
    on stdout; launch() blocks until that line (or the deadline).

    The child's stderr goes to ``stderr_path`` (appended, one file per
    replica across its incarnations) when given, else nowhere."""

    def __init__(self, name: str, spec: ReplicaSpec,
                 env: Optional[dict] = None,
                 launch_timeout_s: float = 180.0,
                 stderr_path: Optional[str] = None):
        super().__init__(name, spec)
        self.proc: Optional[subprocess.Popen] = None
        self.env = env
        self.launch_timeout_s = float(launch_timeout_s)
        self.stderr_path = stderr_path
        self.launch_seconds: Optional[float] = None   # of the last launch

    def _argv(self) -> List[str]:
        argv = [sys.executable, "-m", "deeplearning4j_tpu_torch.serving",
                "--host", self.spec.host, "--port", "0",
                "--buckets", ",".join(str(b) for b in self.spec.buckets),
                "--max-delay-ms", str(self.spec.max_delay_ms),
                "--queue-limit", str(self.spec.queue_limit),
                "--deadline-s", str(self.spec.default_deadline_s)]
        for model_name, source in self.spec.models:
            if not isinstance(source, str):
                raise TypeError(
                    f"subprocess replica {self.name}: model source must be "
                    f"a path/zoo name string, got {type(source).__name__}")
            argv += ["--model", f"{model_name}={source}"]
        for model_name, source in self.spec.lms:
            if not isinstance(source, str):
                raise TypeError(
                    f"subprocess replica {self.name}: LM source must be "
                    f"a path/zoo name string, got {type(source).__name__}")
            argv += ["--lm", f"{model_name}={source}"]
        if self.spec.lms and self.spec.decode is not None:
            d = self.spec.decode
            argv += ["--decode-slots", str(d.slots),
                     "--decode-page-size", str(d.page_size),
                     "--decode-queue-limit", str(d.queue_limit)]
            if d.max_context is not None:
                argv += ["--decode-max-context", str(d.max_context)]
            if d.pool_pages is not None:
                argv += ["--decode-pool-pages", str(d.pool_pages)]
            if d.prefill_buckets:
                argv += ["--prefill-buckets",
                         ",".join(str(b) for b in d.prefill_buckets)]
            if d.prefill_chunk_tokens is not None:
                argv += ["--prefill-chunk-tokens",
                         str(d.prefill_chunk_tokens)]
            if not d.prefix_cache:
                argv.append("--no-prefix-cache")
            if d.spill_pages:
                argv += ["--kv-spill-pages", str(d.spill_pages)]
            if d.spec_draft is not None:
                argv += ["--spec-draft", str(d.spec_draft),
                         "--spec-k", str(d.spec_k),
                         "--spec-accept-floor", str(d.spec_accept_floor),
                         "--spec-window", str(d.spec_window)]
                if d.spec_draft_pool_pages is not None:
                    argv += ["--spec-draft-pool-pages",
                             str(d.spec_draft_pool_pages)]
        if self.spec.lms and self.kv_role != "mixed":
            argv += ["--kv-role", self.kv_role]
        if self.spec.enable_faults:
            argv.append("--enable-fault-injection")
        if self.spec.trace_out:
            stem, ext = os.path.splitext(self.spec.trace_out)
            argv += ["--trace-out", f"{stem}.{self.name}{ext or '.json'}"]
        if self.spec.postmortem_dir:
            argv += ["--postmortem-dir", self.spec.postmortem_dir]
        if not self.spec.flight:
            argv.append("--no-flight")
        elif self.spec.flight_records != 512:
            argv += ["--flight-records", str(self.spec.flight_records)]
        if self.spec.slo_availability is not None:
            argv += ["--slo-availability", str(self.spec.slo_availability)]
        if self.spec.slo_p99_ms is not None:
            argv += ["--slo-p99-ms", str(self.spec.slo_p99_ms)]
        if (self.spec.slo_availability is not None
                or self.spec.slo_p99_ms is not None):
            argv += ["--slo-sample-interval-s",
                     str(self.spec.slo_sample_interval_s)]
            if self.spec.slo_windows:
                argv += ["--slo-windows", self.spec.slo_windows]
        # the device is always explicit: the child's entry point defaults
        # to CUDA and raises without it, and never falls back
        argv += ["--device", self.spec.device]
        return argv

    def launch(self):
        err = subprocess.DEVNULL
        if self.stderr_path:
            err = open(self.stderr_path, "a")
        try:
            self.proc = subprocess.Popen(
                self._argv(), stdout=subprocess.PIPE, stderr=err,
                env=self.env, text=True)
        finally:
            if err is not subprocess.DEVNULL:
                err.close()             # the child holds its own copy
        # a silent hung child must not hang launch(): readline() has no
        # deadline of its own, so a reader thread feeds a queue and the
        # timeout lives on the queue get. The thread exits on the EOF
        # that kill() forces.
        proc, lineq = self.proc, _queue.Queue()

        def _read_stdout():
            try:
                for out_line in proc.stdout:
                    lineq.put(out_line)
            except Exception:                 # noqa: BLE001 — fail loud:
                # a dead reader must not leave launch() waiting out its
                # whole deadline on a queue nobody will ever feed
                log.exception("fleet: %s stdout reader failed", self.name)
            finally:
                lineq.put(None)               # EOF/failure marker

        threading.Thread(target=_read_stdout, daemon=True,
                         name=f"{self.name}-stdout").start()
        t0 = time.monotonic()
        deadline = t0 + self.launch_timeout_s
        while True:
            try:
                line = lineq.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except _queue.Empty:
                self.kill()
                raise TimeoutError(
                    f"replica {self.name}: no startup announcement within "
                    f"{self.launch_timeout_s:.0f}s")
            if line is None:                  # EOF — child died in startup
                rc = self.proc.poll()
                raise RuntimeError(
                    f"replica {self.name}: exited rc={rc} before "
                    "announcing its URL")
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict) and doc.get("serving"):
                self.url = doc["serving"]
                # process start to URL announcement: the child has
                # loaded and warmed every servable by then
                self.launch_seconds = time.monotonic() - t0
                return

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()            # SIGTERM -> CLI drains
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.kill()

    def begin_drain(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()            # SIGTERM: CLI flips /readyz
            # 503 and drains in-flight work; the child exits on its own

    def set_role(self, role: str, rollout_generation: int):
        super().set_role(role, rollout_generation)
        if self.url is None:
            return
        # best-effort push into the child so ITS /readyz agrees with the
        # fleet view; the supervisor-side fields above stay authoritative
        # for routing even if the child is briefly unreachable
        body = json.dumps({"role": role,
                           "rollout_generation": int(rollout_generation)})
        req = urllib.request.Request(
            f"{self.url}/v1/rollout/role", data=body.encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5.0):
                pass
        except (urllib.error.URLError, OSError) as e:
            log.warning("fleet: %s role push failed: %s", self.name, e)


class AutoscaleConfig:
    """Load-signal autoscaling policy: track traffic, not a --replicas
    flag. The signal is the router-maintained in-flight count (the same
    queue-depth input power-of-two-choices balances on) against healthy
    capacity: ``utilization = sum(inflight) / (healthy * capacity)``.

    - utilization >= ``high_watermark`` for ``up_after_ticks`` consecutive
      supervision ticks -> add one replica (launched through the same
      spawn/generation/restart-budget machinery as a relaunch);
    - utilization <= ``low_watermark`` for ``down_after_ticks`` ticks ->
      retire one replica by DRAINING it: out of the routing set first,
      its own /readyz confirmed not-ready, in-flight work finished, then
      a graceful stop — never a kill (a forced kill after
      ``drain_timeout_s`` is counted loudly on /metrics);
    - one scaling action per ``cooldown_s``, canaries are never victims,
      and the count stays inside [min_replicas, max_replicas].
    """

    def __init__(self, min_replicas: int, max_replicas: int,
                 capacity_per_replica: int,
                 high_watermark: float = 0.8,
                 low_watermark: float = 0.25,
                 up_after_ticks: int = 2,
                 down_after_ticks: int = 5,
                 cooldown_s: float = 10.0,
                 drain_timeout_s: float = 30.0):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.capacity_per_replica = int(capacity_per_replica)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.up_after_ticks = int(up_after_ticks)
        self.down_after_ticks = int(down_after_ticks)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "autoscale needs 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.capacity_per_replica < 1:
            raise ValueError("autoscale capacity_per_replica must be >= 1")
        if not 0.0 < self.low_watermark < self.high_watermark <= 1.0:
            raise ValueError(
                "autoscale needs 0 < low_watermark < high_watermark <= 1, "
                f"got ({self.low_watermark}, {self.high_watermark})")


def _threaded_spawn(fn: Callable[[], None], name: str):
    """Default relaunch spawner: a daemon thread, returned for joining.
    Tests inject a synchronous spawner to keep tick() deterministic."""
    t = threading.Thread(target=fn, daemon=True, name=name)
    t.start()
    return t


def http_probe(replica: Replica, timeout: float) -> bool:
    """Default probe: /healthz then /readyz, each 200 within `timeout`.
    The /readyz body doubles as the KV-fabric heartbeat: its kv_role and
    kv_ownership fields are stashed on the replica handle so the router's
    prefix-affinity pick always works from the latest advertisement."""
    if not replica.url:
        return False
    body = b""
    for path in ("/healthz", "/readyz"):
        try:
            r = urllib.request.urlopen(replica.url + path, timeout=timeout)
            if r.status != 200:
                return False
            body = r.read()
        except Exception:                     # noqa: BLE001 — any failure
            return False                      # (timeout, 5xx, conn refused)
    try:
        doc = json.loads(body)
    except ValueError:
        return True                           # pre-fabric replica: fine
    if isinstance(doc, dict):
        if doc.get("kv_role") in ("prefill", "decode", "mixed"):
            replica.kv_role = doc["kv_role"]
        own = doc.get("kv_ownership")
        if isinstance(own, dict):
            replica.kv_ownership = own
    return True


class ReplicaSupervisor:
    """Keep N replicas healthy: probe, restart, replace, give up loudly.

    Usage (production shape):

        sup = ReplicaSupervisor(
            lambda i: SubprocessReplica(f"replica-{i}", spec), n_replicas=3)
        sup.start()                   # launch all, wait until ready
        ...
        sup.healthy()                 # the router's routing set
        sup.stop()

    Tests drive `tick()` directly with injected `time_fn`/`probe_fn`.
    """

    def __init__(self, factory: Callable[[int], Replica], n_replicas: int,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 unhealthy_after: int = 3,
                 restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 30.0,
                 restart_budget: int = 5,
                 restart_budget_window_s: float = 600.0,
                 start_deadline_s: float = 300.0,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Optional[_random.Random] = None,
                 probe_fn: Callable[[Replica, float], bool] = http_probe,
                 spawn_fn: Callable = _threaded_spawn,
                 autoscale: Optional[AutoscaleConfig] = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if autoscale is not None and not (
                autoscale.min_replicas <= n_replicas
                <= autoscale.max_replicas):
            raise ValueError(
                f"n_replicas={n_replicas} outside the autoscale range "
                f"[{autoscale.min_replicas}, {autoscale.max_replicas}]")
        self.replicas = [factory(i) for i in range(int(n_replicas))]
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self.probe_interval = float(probe_interval_s)
        self.probe_timeout = float(probe_timeout_s)
        self.unhealthy_after = int(unhealthy_after)
        self.backoff = float(restart_backoff_s)
        self.backoff_max = float(restart_backoff_max_s)
        self.restart_budget = int(restart_budget)
        self.budget_window = float(restart_budget_window_s)
        self.start_deadline = float(start_deadline_s)
        self._time = time_fn
        self._sleep = sleep_fn
        self._rng = rng if rng is not None else _random.Random()
        self._probe = probe_fn
        self._spawn = spawn_fn
        self.autoscale = autoscale
        self._factory = factory
        self._next_index = int(n_replicas)   # names for scaled-up replicas
        self._ticks_above = 0                # consecutive high-utilization
        self._ticks_below = 0                # consecutive low-utilization
        self._scale_ok_at = 0.0              # cooldown gate
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.fleet.ReplicaSupervisor._lock"
        )                                    # serializes tick vs stop

    # ------------------------------------------------------------- metrics
    def _note_restart(self, replica: Replica, reason: str):
        monitor.counter(
            "serving_fleet_restarts_total",
            "Replica restarts by the supervisor (reason: crash = process "
            "died, probe = K consecutive probe failures, launch = "
            "relaunch itself failed)",
            labels=("replica", "reason")).inc(replica=replica.name,
                                              reason=reason)

    def _export_states(self):
        counts = {s: 0 for s in REPLICA_STATES}
        for r in self.replicas:
            counts[r.state] = counts.get(r.state, 0) + 1
        g = monitor.gauge("serving_fleet_replicas",
                          "Replica count per lifecycle state",
                          labels=("state",))
        for s, n in counts.items():
            g.set(n, state=s)
        monitor.gauge("serving_fleet_size",
                      "Configured replica count").set(len(self.replicas))

    # ------------------------------------------------------------ lifecycle
    def start(self, wait_ready: bool = True):
        """Launch every replica (in parallel — subprocess replicas pay a
        runtime-import each), then optionally block until the whole fleet
        probes ready, then start the supervision loop."""
        errors: List[str] = []

        def _launch(r: Replica):
            try:
                r.launch()
            except Exception as e:            # noqa: BLE001
                errors.append(f"{r.name}: {type(e).__name__}: {e}")
                r.state = "unhealthy"

        threads = [threading.Thread(target=_launch, args=(r,), daemon=True,
                                    name=f"launch-{r.name}")
                   for r in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self.stop_replicas()
            raise RuntimeError("fleet launch failed: " + "; ".join(errors))
        if wait_ready:
            deadline = self._time() + self.start_deadline
            pending = list(self.replicas)
            while pending:
                pending = [r for r in pending
                           if not self._probe_once(r, mark=True)]
                if not pending:
                    break
                if self._time() > deadline:
                    self.stop_replicas()
                    raise TimeoutError(
                        "fleet not ready within "
                        f"{self.start_deadline:.0f}s: "
                        f"{[r.name for r in pending]} still unready")
                self._sleep(0.2)
        self._export_states()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ReplicaSupervisor")
        self._thread.start()
        log.info("fleet: supervising %d replicas (%s)", len(self.replicas),
                 ", ".join(f"{r.name}@{r.url}" for r in self.replicas))

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:                 # noqa: BLE001 — keep watching
                log.exception("fleet: supervision tick failed")
            self._sleep(self.probe_interval)

    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == "ready"]

    def describe(self) -> dict:
        doc = {"replicas": [r.describe() for r in self.replicas]}
        if self.autoscale is not None:
            cfg = self.autoscale
            doc["autoscale"] = {
                "min_replicas": cfg.min_replicas,
                "max_replicas": cfg.max_replicas,
                "capacity_per_replica": cfg.capacity_per_replica,
                "high_watermark": cfg.high_watermark,
                "low_watermark": cfg.low_watermark,
            }
        return doc

    def stop_replicas(self):
        for r in self.replicas:
            try:
                r.stop()
            except Exception:                 # noqa: BLE001
                log.exception("fleet: stopping %s failed", r.name)
            r.state = "stopped"
        self._export_states()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 2 * self.probe_interval))
        # give in-flight relaunches a moment to notice the stop flag and
        # clean up their own fresh processes; a hung one stays daemon
        self._join_relaunches(timeout=5.0)
        with self._lock:
            self.stop_replicas()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- the tick
    def _probe_once(self, replica: Replica, mark: bool = False) -> bool:
        t0 = time.perf_counter()
        with monitor.span("serving/probe", replica=replica.name):
            ok = self._probe(replica, self.probe_timeout)
        monitor.histogram("serving_fleet_probe_seconds",
                          "Health-probe round-trip time",
                          labels=("replica",)).observe(
            time.perf_counter() - t0, replica=replica.name)
        if ok and mark:
            replica.state = "ready"
            replica.consecutive_probe_failures = 0
        return ok

    def tick(self):
        """One supervision pass. Deterministic given time_fn/probe_fn:
        probes live replicas, schedules/executes restarts, enforces the
        budget. Called by the loop every probe_interval; tests call it
        directly. Relaunches run via `spawn_fn` (a daemon thread by
        default) so one slow or hung launch never stalls supervision of
        the rest of the fleet — or supervisor.stop()."""
        due: List[Replica] = []
        wedged: List[Tuple[str, int, int]] = []   # postmortems after lock
        with self._lock:
            if self._stop.is_set():
                return
            now = self._time()
            live: List[Replica] = []
            for r in self.replicas:
                if r.state in ("dead", "stopped"):
                    continue
                launching = getattr(r, "_launch_thread", None)
                if launching is not None and launching.is_alive():
                    continue              # relaunch in flight: hands off
                if r.state == "backoff":
                    if now >= (r.restart_at or 0):
                        # transition under the lock BEFORE spawning so
                        # the next tick cannot double-launch
                        r.generation += 1
                        r.consecutive_probe_failures = 0
                        r.restart_at = None
                        r.state = "starting"
                        due.append(r)
                    continue
                if not r.alive():
                    log.warning("fleet: %s process died — scheduling "
                                "restart", r.name)
                    self._note_restart(r, "crash")
                    self._schedule_restart(r, now)
                    continue
                live.append(r)
            # probe live replicas CONCURRENTLY: N wedged replicas cost
            # one probe window per tick, not N of them (each probe is
            # already deadline-bounded by probe_timeout)
            probe_ok = {}
            if len(live) == 1:
                probe_ok[live[0].name] = self._probe_once(live[0])
            elif live:
                probers = [threading.Thread(
                    target=lambda r=r: probe_ok.__setitem__(
                        r.name, self._probe_once(r)),
                    daemon=True, name=f"probe-{r.name}") for r in live]
                for t in probers:
                    t.start()
                for t in probers:
                    # graftlint: disable=blocking-under-lock -- each probe thread is deadline-bounded by probe_timeout (never unbounded); tick() deliberately holds its lock for ONE bounded probe window
                    t.join()
            for r in live:
                if probe_ok[r.name]:
                    if r.state != "ready":
                        log.info("fleet: %s is ready (gen %d)", r.name,
                                 r.generation)
                    r.state = "ready"
                    r.consecutive_probe_failures = 0
                    r.restart_attempt = 0    # stable again: backoff resets
                    continue
                r.consecutive_probe_failures += 1
                monitor.counter("serving_fleet_probe_failures_total",
                                "Failed health probes",
                                labels=("replica",)).inc(replica=r.name)
                # a replica still "starting" (warming its bucket ladder)
                # gets 5x the probe patience before it is presumed wedged
                patience = self.unhealthy_after * (
                    5 if r.state == "starting" else 1)
                if r.consecutive_probe_failures >= patience:
                    # alive but failing probes = wedged. A wedged process
                    # cannot be trusted to drain — kill and replace.
                    log.warning(
                        "fleet: %s failed %d consecutive probes — "
                        "presumed wedged, replacing", r.name,
                        r.consecutive_probe_failures)
                    r.state = "unhealthy"
                    self._note_restart(r, "probe")
                    wedged.append((r.name, r.generation,
                                   r.consecutive_probe_failures))
                    try:
                        r.kill()
                    except Exception:         # noqa: BLE001
                        log.exception("fleet: killing wedged %s failed",
                                      r.name)
                    self._schedule_restart(r, now)
            grow, shrink = self._autoscale_tick(now)
            self._export_states()
        for name, gen, probe_failures in wedged:
            # OUTSIDE the tick lock (postmortems write a file): a wedge
            # detection is an SLO event — dump the flight ring naming
            # the replica incarnation that wedged
            flight.trip("replica_wedged", replica=name, generation=gen,
                        probe_failures=probe_failures)
        for r in due:
            r._launch_thread = self._spawn(
                lambda r=r: self._relaunch(r), f"relaunch-{r.name}")
        for r in grow:
            r._launch_thread = self._spawn(
                lambda r=r: self._relaunch(r), f"scale-up-{r.name}")
        for r in shrink:
            r._drain_thread = self._spawn(
                lambda r=r: self._drain_retired(r), f"drain-{r.name}")

    # ---------------------------------------------------------- autoscaling
    def _autoscale_tick(self, now: float):
        """One autoscale evaluation (called under the tick lock). Returns
        (replicas to launch, replicas to drain) for the caller to spawn
        OUTSIDE the lock — same discipline as relaunches."""
        cfg = self.autoscale
        if cfg is None:
            return [], []
        # retired replicas whose drain finished leave the roster entirely
        # (a scaled-down replica is gone, not a gap to alert on)
        self.replicas = [
            r for r in self.replicas
            if not (r.state == "stopped"
                    and getattr(r, "scaledown", None) is not None)]
        ready = [r for r in self.replicas if r.state == "ready"]
        # anything not permanently gone still counts against max_replicas:
        # a starting or backoff replica is capacity in flight
        active = [r for r in self.replicas
                  if r.state not in ("dead", "stopped", "draining")]
        capacity = len(ready) * cfg.capacity_per_replica
        demand = sum(r.inflight() for r in ready)
        # no ready capacity but demand pressure cannot be measured — treat
        # as saturated only if there's nothing coming up already
        util = (demand / capacity) if capacity else (
            1.0 if not active else 0.0)
        monitor.gauge("serving_autoscale_utilization",
                      "Router-tracked in-flight demand over healthy "
                      "capacity (the autoscaler's input signal)"
                      ).set(round(util, 4))
        self._ticks_above = self._ticks_above + 1 \
            if util >= cfg.high_watermark else 0
        self._ticks_below = self._ticks_below + 1 \
            if util <= cfg.low_watermark else 0
        if now < self._scale_ok_at:
            return [], []
        events = monitor.counter(
            "serving_autoscale_events_total",
            "Autoscaler scaling actions (direction: up = replica added, "
            "down = replica drained out)", labels=("direction",))
        if self._ticks_above >= cfg.up_after_ticks \
                and len(active) < cfg.max_replicas:
            name_index = self._next_index
            self._next_index += 1
            replica = self._factory(name_index)
            replica.state = "starting"
            self.replicas.append(replica)
            self._ticks_above = 0
            self._scale_ok_at = now + cfg.cooldown_s
            events.inc(direction="up")
            log.info("fleet: autoscale up -> launching %s "
                     "(utilization %.2f over %d ready)", replica.name,
                     util, len(ready))
            return [replica], []
        if self._ticks_below >= cfg.down_after_ticks \
                and len(active) > cfg.min_replicas:
            # victim: the youngest READY stable replica — canaries are
            # under rollout evaluation and must never be drained away
            victims = [r for r in ready if r.role != "canary"]
            if not victims:
                return [], []
            victim = victims[-1]
            victim.state = "draining"
            victim.scaledown = {"readyz_confirmed": False,
                                "forced_kill": False}
            self._ticks_below = 0
            self._scale_ok_at = now + cfg.cooldown_s
            events.inc(direction="down")
            log.info("fleet: autoscale down -> draining %s "
                     "(utilization %.2f over %d ready)", victim.name,
                     util, len(ready))
            return [], [victim]
        return [], []

    def _drain_retired(self, replica: Replica):
        """Scale-down teardown, OFF the tick lock: the replica already
        left the routing set (state 'draining'); signal the drain, wait
        for its own /readyz to confirm not-ready, wait out in-flight
        work, then stop gracefully. Killing is the loud last resort after
        drain_timeout_s, never the plan."""
        cfg = self.autoscale
        try:
            replica.begin_drain()
        except Exception:                     # noqa: BLE001
            log.exception("fleet: begin_drain on %s failed", replica.name)
        deadline = self._time() + cfg.drain_timeout_s
        # the replica itself must acknowledge the drain: its probe
        # (healthz+readyz) failing is the /readyz-flipped-503 signal
        while self._time() < deadline and not self._stop.is_set():
            if not self._probe(replica, self.probe_timeout):
                replica.scaledown["readyz_confirmed"] = True
                break
            self._sleep(min(0.2, self.probe_interval))
        while replica.inflight() > 0 and self._time() < deadline \
                and not self._stop.is_set():
            self._sleep(min(0.2, self.probe_interval))
        try:
            replica.stop()                   # graceful reap
        except Exception:                     # noqa: BLE001
            log.exception("fleet: draining stop of %s failed", replica.name)
        if replica.alive():
            replica.scaledown["forced_kill"] = True
            monitor.counter(
                "serving_autoscale_forced_kills_total",
                "Scale-down drains that exhausted drain_timeout_s and "
                "fell back to a kill (should be zero)",
                labels=("replica",)).inc(replica=replica.name)
            log.warning("fleet: %s did not drain within %.0fs — killing",
                        replica.name, cfg.drain_timeout_s)
            try:
                replica.kill()
            except Exception:                 # noqa: BLE001
                log.exception("fleet: kill of undrained %s failed",
                              replica.name)
        with self._lock:
            replica.state = "stopped"
            self._export_states()

    def _schedule_restart(self, replica: Replica, now: float):
        replica.restart_times = [t for t in replica.restart_times
                                 if now - t <= self.budget_window]
        if len(replica.restart_times) >= self.restart_budget:
            log.error(
                "fleet: %s exceeded its restart budget (%d restarts in "
                "%.0fs) — marking dead; a human should look at it",
                replica.name, len(replica.restart_times),
                self.budget_window)
            monitor.counter("serving_fleet_gave_up_total",
                            "Replicas abandoned after exhausting the "
                            "restart budget (crash loop)",
                            labels=("replica",)).inc(replica=replica.name)
            replica.state = "dead"
            try:
                replica.kill()
            # graftlint: disable=bare-except-swallow -- best-effort kill of an already-dead-to-us process; state=dead + serving_fleet_gave_up_total above are the observable record
            except Exception:                 # noqa: BLE001
                pass
            return
        replica.restart_times.append(now)
        # jittered exponential backoff: full value down to half of it, so
        # a correlated crash doesn't restart the whole fleet in lockstep
        delay = min(self.backoff_max,
                    self.backoff * (2 ** replica.restart_attempt))
        delay *= 0.5 + 0.5 * self._rng.random()
        replica.restart_attempt += 1
        replica.restart_at = now + delay
        replica.state = "backoff"
        log.warning("fleet: restarting %s in %.2fs (attempt %d)",
                    replica.name, delay, replica.restart_attempt)

    def _relaunch(self, replica: Replica):
        """Launch a fresh incarnation. Runs OUTSIDE the tick lock (on a
        spawn_fn thread in production): only the post-launch bookkeeping
        re-acquires it. tick() already moved the replica to 'starting'."""
        with monitor.span("serving/restart", replica=replica.name,
                          generation=replica.generation):
            try:
                replica.launch()
            except Exception as e:            # noqa: BLE001
                log.error("fleet: relaunching %s failed: %s: %s",
                          replica.name, type(e).__name__, e)
                with self._lock:
                    if self._stop.is_set():
                        return
                    self._note_restart(replica, "launch")
                    self._schedule_restart(replica, self._time())
                return
        with self._lock:
            if self._stop.is_set():
                # stop() raced the relaunch: don't leak a fresh process
                try:
                    replica.stop()
                # graftlint: disable=bare-except-swallow -- best-effort teardown of a stop-raced fresh process; state=stopped below is the record and stop() must not raise
                except Exception:             # noqa: BLE001
                    pass
                replica.state = "stopped"
                return
        log.info("fleet: relaunched %s (gen %d) at %s", replica.name,
                 replica.generation, replica.url)

    def _join_relaunches(self, timeout: float = 30.0):
        for r in self.replicas:
            for attr in ("_launch_thread", "_drain_thread"):
                t = getattr(r, attr, None)
                if t is not None:
                    t.join(timeout)
