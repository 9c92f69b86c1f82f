"""Continuous-rollout drill: train -> bless -> canary -> verdict ->
promote / auto-rollback, plus load-signal autoscaling — end to end.

    python -m deeplearning4j_tpu_torch.tools.rollout_drill --device cpu \\
        [--out ROLLOUT.json]

Counterpart of the JAX package's `tools/rollout_drill.py`, with the same
assertions and report keys, every network on ``--device``. Four phases,
all against REAL components (no fakes):

1. **Train & bless** — ResilientTrainer fits a classifier with an eval
   gate; the passing checkpoint lands in the manifest AND in
   ``blessed.json`` (CheckpointManager.bless), the contract the rollout
   watcher tails.
2. **Canary -> promote** — a 3-subprocess-replica fleet (each its own
   OS process and CUDA context, SLO engine + time-series ring) serves a
   v1 model behind the ResilientRouter while closed-loop traffic flows.
   The RolloutController spots the blessing, swaps ONE replica to the
   blessed version (its /readyz flips role=canary, /v1/fleet shows the
   rollout), holds the admin surface, judges the observation window on
   per-replica /v1/slo + /v1/timeseries + accuracy probes, and promotes
   fleet-wide with a staggered fan-out. Assert: **zero 5xx end to end**,
   every replica's active version is the blessed source, the shared
   ReplicaSpec was rewritten (restart durability).
3. **Poisoned blessing -> auto-rollback** — an UNTRAINED model is
   checkpointed and blessed with lying metrics (the broken-eval-gate
   scenario). The canary's accuracy probes catch it; the controller
   rolls the replica back and trips a ``rollout_rejected`` flight
   postmortem naming the regressing metric (``probe_accuracy``) and the
   rejected source. Assert: fleet still serves the good version, zero
   5xx while the poison was live, postmortem on disk.
4. **Autoscale** — a separate in-process mini-fleet (min 1 / max 3)
   under a stepped open-loop ramp (`loadgen.LoadGen.run_ramp` with
   /v1/fleet sampling). Slowed predicts push router in-flight past the
   high watermark: the supervisor scales up; when the ramp ends it
   scales down by DRAINING the victim (readyz flip confirmed, in-flight
   zero, graceful stop) — never a kill. Assert: peak > initial replicas,
   ``forced_kills == 0``, every retirement readyz-confirmed.

Prints the JSON report with a "sweep" row carrying ``rollout_promote_s``
(staggered fan-out duration) and ``rollout_rollback_detect_s`` (poisoned
blessing on disk -> rollback decision). Exit 0 iff every assertion held.
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

N_IN, N_OUT = 6, 3
FLEET_READY_BUDGET_S = 180.0    # each subprocess pays an import + CUDA start
PROMOTE_BUDGET_S = 120.0
ROLLBACK_BUDGET_S = 90.0
SCALE_DOWN_BUDGET_S = 90.0
PM_WRITE_BUDGET_S = 10.0        # verdict published -> postmortem on disk


def _blobs(n=480, seed=0):
    import numpy as np
    rs = np.random.RandomState(seed)
    centers = rs.randn(N_OUT, N_IN) * 3.0
    X = np.empty((n, N_IN), dtype=np.float32)
    Y = np.zeros((n, N_OUT), dtype=np.float32)
    for i in range(n):
        c = i % N_OUT
        X[i] = centers[c] + rs.randn(N_IN) * 0.7
        Y[i, c] = 1.0
    idx = rs.permutation(n)
    return X[idx], Y[idx]


def _net(seed, device):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(2e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _accuracy(net, X, Y) -> float:
    import numpy as np
    pred = np.argmax(net.output(X).float().cpu().numpy(), axis=1)
    return float((pred == np.argmax(Y, axis=1)).mean())


def _get_json(url, timeout=10.0) -> dict:
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


def _active_source(replica_url: str, model: str = "m"):
    """The source path of the ACTIVE version on one replica (GET
    /v1/models/{name} returns active_version + the version history)."""
    doc = _get_json(f"{replica_url}/v1/models/{model}")
    active = doc.get("active_version")
    for v in doc.get("versions", []):
        if v.get("version") == active:
            return v.get("source")
    return None


def _count_5xx(codes: dict) -> int:
    # 503 is explicit backpressure/no-backend in the fleet's contract —
    # everything else >= 500 is a failure. report() stringifies code
    # keys; "transport" stays non-numeric.
    n = 0
    for c, cnt in codes.items():
        try:
            code = int(c)
        except (TypeError, ValueError):
            continue
        if code >= 500 and code != 503:
            n += cnt
    return n


class _Pump:
    """Closed-loop traffic on a background thread until stopped;
    accumulates into ONE LoadGen so codes/latencies pool across runs."""

    def __init__(self, gen):
        self.gen = gen
        self.wall = 0.0
        self.ok = 0
        self.crashed = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rollout-drill-pump")

    def _loop(self):
        try:
            while not self._stop.is_set():
                w, o = self.gen.run_closed()
                self.wall += w
                self.ok += o
        except Exception:  # noqa: BLE001 — a dead pump must be loud
            self.crashed = traceback.format_exc()
            print(f"[drill] traffic pump crashed:\n{self.crashed}",
                  file=sys.stderr)

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=120.0)
        return self.gen.report(self.wall, self.ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer and every replica "
                         "(default cuda; 'cpu' must be asked for)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON report here; the subprocess "
                         "replicas' stderr goes beside it")
    cli = ap.parse_args(argv)

    import numpy as np

    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.monitor import flight
    from deeplearning4j_tpu_torch.serving import (
        AutoscaleConfig, InProcessReplica, ReplicaSpec, ReplicaSupervisor,
        ResilientRouter, RolloutController, RouterServer, SubprocessReplica,
    )
    from deeplearning4j_tpu_torch.serving.rollout import read_blessed
    from deeplearning4j_tpu_torch.tools.loadgen import LoadGen, calibrate
    from deeplearning4j_tpu_torch.tools.serve_chaos import (
        replica_env, replica_log, replica_log_dir,
    )
    from deeplearning4j_tpu_torch.train.resilience import ResilientTrainer
    from deeplearning4j_tpu_torch.util.serialization import save_model

    device = cli.device
    failures = []
    summary = {"device": device}
    calib_start = calibrate()
    log_dir = replica_log_dir(cli.out)

    # ---------------- phase 1: train & bless ----------------------------
    X, Y = _blobs(seed=0)
    Xh, Yh = X[-60:], Y[-60:]            # held-out: eval gate + probes
    Xt, Yt = X[:-60], Y[:-60]
    tmp = tempfile.mkdtemp(prefix="rollout_drill_")
    ckpt_dir = os.path.join(tmp, "ckpts")

    v1 = _net(seed=1, device=device)
    v1.fit(ArrayDataSetIterator(Xt, Yt, batch_size=32))     # one epoch
    v1_zip = os.path.join(tmp, "v1.zip")
    save_model(v1, v1_zip)
    v1_acc = _accuracy(v1, Xh, Yh)

    gate_calls = [0]

    def eval_gate(net):
        gate_calls[0] += 1
        acc = _accuracy(net, Xh, Yh)
        # bless only a model that beats chance decisively — the gate
        # between "trainer wrote a checkpoint" and "fleet may canary it"
        return {"accuracy": round(acc, 4)} if acc >= 0.6 else None

    t0 = time.perf_counter()
    trainer = ResilientTrainer(_net(seed=2, device=device), ckpt_dir,
                               save_every_n_iterations=10_000,
                               save_every_n_epochs=1, keep_last=3,
                               eval_gate=eval_gate)
    fit_report = trainer.fit(ArrayDataSetIterator(Xt, Yt, batch_size=32),
                             epochs=4)
    blessed = read_blessed(ckpt_dir)
    summary["train"] = {
        "fit_s": round(time.perf_counter() - t0, 1),
        "v1_accuracy": round(v1_acc, 4),
        "checkpoints_written": fit_report.checkpoints_written,
        "checkpoints_blessed": fit_report.checkpoints_blessed,
        "eval_gate_calls": gate_calls[0],
        "blessed": {k: blessed[k] for k in
                    ("file", "sha256", "metrics")} if blessed else None,
    }
    if fit_report.checkpoints_blessed < 1 or blessed is None:
        failures.append("trainer produced no blessed checkpoint "
                        f"({fit_report.checkpoints_blessed} blessed, "
                        f"read_blessed -> {blessed})")
        print(json.dumps({"ok": False, "failures": failures,
                          "summary": summary}, indent=1))
        return 1
    v2_path = blessed["path"]
    probes = [(Xh[i], int(np.argmax(Yh[i]))) for i in range(24)]

    # ---------------- phase 2: fleet + canary -> promote -----------------
    pm_dir = os.path.join(tmp, "postmortems")
    flight.enable_flight(capacity=512, dump_dir=pm_dir)
    env = replica_env()
    spec = ReplicaSpec([("m", v1_zip)], buckets=(1, 8), max_delay_ms=2.0,
                       queue_limit=64, default_deadline_s=30.0,
                       postmortem_dir=pm_dir,
                       # per-replica SLO engine + time-series ring: the
                       # rollout verdict reads each replica's OWN stats
                       slo_availability=0.995, slo_sample_interval_s=0.5,
                       device=device)
    supervisor = ReplicaSupervisor(
        lambda i: SubprocessReplica(
            f"replica-{i}", spec, env=env,
            stderr_path=replica_log(log_dir, f"rollout-replica-{i}")),
        n_replicas=3, probe_interval_s=0.5, probe_timeout_s=2.0,
        unhealthy_after=3, restart_backoff_s=0.5, restart_budget=6)
    t0 = time.perf_counter()
    supervisor.start()
    deadline = time.monotonic() + FLEET_READY_BUDGET_S
    while len(supervisor.healthy()) < 3 and time.monotonic() < deadline:
        time.sleep(0.5)
    summary["fleet_start_s"] = round(time.perf_counter() - t0, 1)
    if len(supervisor.healthy()) < 3:
        failures.append("fleet did not reach 3 ready replicas within "
                        f"{FLEET_READY_BUDGET_S:.0f}s")

    # hedging off: a hedged duplicate served by the canary would blur
    # which replica's stats a request belongs to
    router = ResilientRouter(supervisor.healthy, per_replica_inflight=8,
                             hedge=False, timeout_s=30.0,
                             canary_fraction=0.25)
    server = RouterServer(router, supervisor=supervisor, port=0)
    rollout = RolloutController(
        supervisor, router, ckpt_dir, "m", watch="blessed",
        poll_interval_s=0.5, observe_s=8.0, min_canary_requests=10,
        probe_set=probes, probe_min_accuracy=0.6,
        # noise guard: p99 on millisecond predicts is not a verdict
        p99_floor_ms=250.0, promote_stagger_s=0.2)
    server.rollout = rollout

    class Args:
        url = server.url
        model = "m"
        requests = 80
        concurrency = 8
        rate = None
        batch_sizes = [1, 2]
        priority_mix = None
        max_retries = 4
        retry_cap_s = 2.0
        deadline_ms = None
        timeout_s = 60.0
        seed = 0

    try:
        pump = _Pump(LoadGen(Args, (N_IN,))).start()
        time.sleep(1.0)                      # traffic flowing first
        rollout.start(interval_s=0.25)

        # while the canary is live: /v1/fleet must show the rollout and
        # the canary replica's own /readyz must agree
        canary_seen = None
        deadline = time.monotonic() + PROMOTE_BUDGET_S
        while time.monotonic() < deadline:
            doc = _get_json(server.url + "/v1/fleet")
            ro = doc.get("rollout") or {}
            if ro.get("state") == "canary" and canary_seen is None:
                name = (ro.get("canary") or {}).get("replica")
                rep = next((r for r in doc.get("replicas", [])
                            if r.get("name") == name), None)
                readyz = {}
                if rep and rep.get("url"):
                    try:
                        readyz = _get_json(rep["url"] + "/readyz")
                    except OSError:
                        pass
                canary_seen = {"replica": name,
                               "fleet_role": (rep or {}).get("role"),
                               "readyz_role": readyz.get("role"),
                               "readyz_generation":
                                   readyz.get("rollout_generation")}
            verdict = rollout.describe()["last_verdict"]
            if verdict is not None:
                break
            time.sleep(0.2)
        traffic = pump.stop()
        verdict = rollout.describe()["last_verdict"]

        n5xx = _count_5xx(traffic["codes"])
        summary["promote"] = {
            "verdict": verdict,
            "canary_observed": canary_seen,
            "requests": traffic["requests"],
            "codes": traffic["codes"],
            "server_5xx": n5xx,
            "p99_ms": traffic["latency_ms"]["p99"],
        }
        if verdict is None or verdict.get("decision") != "promoted":
            failures.append(f"blessed checkpoint was not promoted within "
                            f"{PROMOTE_BUDGET_S:.0f}s: {verdict}")
        if n5xx:
            failures.append(f"{n5xx} 5xx during canary/promote "
                            f"(codes {traffic['codes']})")
        if traffic["codes"].get("transport"):
            failures.append("transport failures reached the client "
                            "during promote")
        if canary_seen is None:
            failures.append("/v1/fleet never surfaced the canary rollout")
        elif not (canary_seen["fleet_role"] == "canary"
                  and canary_seen["readyz_role"] == "canary"):
            failures.append("fleet view and replica /readyz disagree on "
                            f"the canary role: {canary_seen}")
        # every replica now serves the blessed source, and the shared
        # spec was rewritten (a later relaunch comes up on v2)
        actives = {}
        for r in supervisor.replicas:
            try:
                actives[r.name] = _active_source(r.url)
            except (OSError, KeyError, ValueError) as e:
                actives[r.name] = f"error: {e}"
        summary["promote"]["active_sources"] = actives
        if not all(src == v2_path for src in actives.values()):
            failures.append(f"fleet not fully on the promoted source: "
                            f"{actives}")
        if spec.models != [("m", v2_path)]:
            failures.append(f"ReplicaSpec not rewritten on promote: "
                            f"{spec.models}")

        # ------------- phase 3: poisoned blessing -> auto-rollback -------
        poison = _net(seed=99, device=device)   # untrained: ~chance
        t_poison = time.monotonic()
        p_path = trainer.ckpt.save(poison, {})
        trainer.ckpt.bless(p_path, {"accuracy": 0.99})   # the eval lied
        pump = _Pump(LoadGen(type("B", (Args,), {"seed": 3}),
                             (N_IN,))).start()
        deadline = time.monotonic() + ROLLBACK_BUDGET_S
        verdict = None
        while time.monotonic() < deadline:
            verdict = rollout.describe()["last_verdict"]
            if verdict and verdict.get("source") == p_path:
                break
            verdict = None
            time.sleep(0.2)
        detect_wall_s = time.monotonic() - t_poison
        traffic = pump.stop()
        n5xx = _count_5xx(traffic["codes"])
        summary["rollback"] = {
            "verdict": verdict,
            "detect_wall_s": round(detect_wall_s, 2),
            "codes": traffic["codes"],
            "server_5xx": n5xx,
        }
        if verdict is None or verdict.get("decision") != "rejected":
            failures.append("poisoned blessing was not rejected within "
                            f"{ROLLBACK_BUDGET_S:.0f}s: {verdict}")
        else:
            if verdict.get("metric") != "probe_accuracy":
                failures.append("rejection did not name probe_accuracy: "
                                f"{verdict.get('metric')}")
            if not verdict.get("rolled_back"):
                failures.append("canary was not rolled back: "
                                f"{verdict}")
        if n5xx:
            failures.append(f"{n5xx} 5xx while the poisoned canary was "
                            f"live (codes {traffic['codes']})")
        actives = {}
        for r in supervisor.replicas:
            try:
                actives[r.name] = _active_source(r.url)
            except (OSError, KeyError, ValueError) as e:
                actives[r.name] = f"error: {e}"
        summary["rollback"]["active_sources"] = actives
        if not all(src == v2_path for src in actives.values()):
            failures.append("fleet left the promoted source after the "
                            f"poison rollback: {actives}")

        # the postmortem receipt: reason + regressing metric + source.
        # The controller publishes its verdict before it writes the
        # postmortem (the trip runs outside its lock), so the file may
        # land a moment after the verdict did
        pm = None
        deadline = time.monotonic() + PM_WRITE_BUDGET_S
        while pm is None and time.monotonic() < deadline:
            for fn in sorted(os.listdir(pm_dir)) \
                    if os.path.isdir(pm_dir) else []:
                if fn.startswith("postmortem-") and fn.endswith(".json"):
                    with open(os.path.join(pm_dir, fn)) as f:
                        doc = json.load(f)
                    if doc.get("reason") == "rollout_rejected":
                        pm = (fn, doc)
            if pm is None:
                time.sleep(0.1)
        if pm is None:
            failures.append(
                "no rollout_rejected flight postmortem was dumped (dir "
                f"{pm_dir}; in memory: "
                f"{[d['reason'] for d in flight.postmortems()]})")
            summary["rollback"]["postmortem_metric"] = None
        else:
            fn, doc = pm
            meta = doc.get("meta", {})
            summary["rollback"]["postmortem"] = {"file": fn, "meta": meta}
            summary["rollback"]["postmortem_metric"] = meta.get("metric")
            if meta.get("metric") != "probe_accuracy" \
                    or meta.get("source") != p_path:
                failures.append("postmortem does not name the regressing "
                                f"metric + rejected source: {meta}")

        # rollout metric families (controller runs in this process)
        metrics = urllib.request.urlopen(server.url + "/metrics",
                                         timeout=10).read().decode()
        for fam in ("serving_rollout_state",
                    "serving_rollout_canaries_total",
                    "serving_rollout_promotions_total",
                    "serving_rollout_rollbacks_total",
                    "serving_rollout_promote_seconds",
                    "serving_rollout_rollback_detect_seconds"):
            if fam not in metrics:
                failures.append(f"/metrics missing {fam}")
    finally:
        rollout.stop()
        server.stop()
        supervisor.stop()

    # ---------------- phase 4: load-signal autoscaling -------------------
    spec2 = ReplicaSpec([("m", v2_path)], buckets=(1, 8), max_delay_ms=1.0,
                        queue_limit=128, default_deadline_s=10.0,
                        enable_faults=True, device=device)
    auto_cfg = AutoscaleConfig(min_replicas=1, max_replicas=3,
                               capacity_per_replica=2,
                               high_watermark=0.8, low_watermark=0.25,
                               up_after_ticks=2, down_after_ticks=4,
                               cooldown_s=2.0, drain_timeout_s=20.0)
    seen = {}

    def factory(i):
        r = InProcessReplica(f"auto-{i}", spec2)
        seen[r.name] = r
        return r

    sup2 = ReplicaSupervisor(factory, n_replicas=1, probe_interval_s=0.25,
                             probe_timeout_s=2.0, unhealthy_after=3,
                             restart_backoff_s=0.5, restart_budget=6,
                             autoscale=auto_cfg)
    sup2.start()
    deadline = time.monotonic() + 60.0
    while len(sup2.healthy()) < 1 and time.monotonic() < deadline:
        time.sleep(0.2)
    router2 = ResilientRouter(sup2.healthy, per_replica_inflight=16,
                              hedge=False, timeout_s=15.0)
    server2 = RouterServer(router2, supervisor=sup2, port=0)

    # slow every replica's predicts (0.3s) so offered rps translates to
    # sustained router in-flight — the load signal the autoscaler reads.
    # The injector keeps running so scale-up NEWCOMERS get slowed too.
    stop_inject = threading.Event()

    def inject():
        done = set()
        while not stop_inject.wait(0.25):
            for r in list(sup2.replicas):
                key = (r.name, r.generation)
                if key in done or r.state != "ready" or not r.url:
                    continue
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        r.url + "/v1/faults",
                        data=json.dumps({"predict_delay_s": 0.3}).encode(),
                        headers={"Content-Type": "application/json"}),
                        timeout=5).read()
                    done.add(key)
                except OSError:
                    pass                     # retried next sweep

    injector = threading.Thread(target=inject, daemon=True,
                                name="rollout-drill-fault-injector")
    injector.start()

    class Args3:
        url = server2.url
        model = "m"
        requests = 0
        concurrency = 1
        rate = None
        batch_sizes = [1]
        priority_mix = None
        max_retries = 2
        retry_cap_s = 1.0
        deadline_ms = None
        timeout_s = 20.0
        seed = 7

    try:
        initial = len(sup2.replicas)
        gen3 = LoadGen(Args3, (N_IN,))
        # baseline -> surge past the high watermark -> near-idle
        wall, ok3 = gen3.run_ramp([(2, 6), (12, 12), (0.5, 10)],
                                  fleet_url=server2.url,
                                  sample_interval_s=0.5)
        ramp_rep = gen3.report(wall, ok3)
        peak = max((s["ready"] for s in ramp_rep["replicas_over_time"]),
                   default=initial)
        # after the ramp: wait for the fleet to drain back to the floor
        deadline = time.monotonic() + SCALE_DOWN_BUDGET_S
        while time.monotonic() < deadline:
            active = [r for r in sup2.replicas
                      if r.scaledown is None and r.state != "stopped"]
            if len(active) <= 1 and len(sup2.replicas) <= 1:
                break
            time.sleep(0.5)
        retired = [r for r in seen.values() if r.scaledown is not None]
        summary["autoscale"] = {
            "initial_replicas": initial,
            "peak_replicas": peak,
            "final_replicas": len(sup2.replicas),
            "ramp": ramp_rep["ramp"],
            "replicas_over_time": ramp_rep["replicas_over_time"],
            "codes": ramp_rep["codes"],
            "retired": [{"name": r.name,
                         "readyz_confirmed":
                             r.scaledown.get("readyz_confirmed"),
                         "forced_kill": r.scaledown.get("forced_kill")}
                        for r in retired],
            "forced_kills": sum(1 for r in retired
                                if r.scaledown.get("forced_kill")),
        }
        if peak <= initial:
            failures.append(f"ramp never scaled the fleet up "
                            f"(initial {initial}, peak {peak})")
        if len(sup2.replicas) > 1:
            failures.append("fleet did not scale back to the floor within "
                            f"{SCALE_DOWN_BUDGET_S:.0f}s "
                            f"({[r.describe() for r in sup2.replicas]})")
        if not retired:
            failures.append("no replica was drained on scale-down")
        for r in retired:
            if not r.scaledown.get("readyz_confirmed"):
                failures.append(f"{r.name}: retired without a confirmed "
                                "readyz flip (drain contract)")
            if r.scaledown.get("forced_kill"):
                failures.append(f"{r.name}: scale-down FORCED a kill "
                                "instead of draining")
    finally:
        stop_inject.set()
        injector.join(timeout=5)
        server2.stop()
        sup2.stop()
        flight.disable_flight()

    summary["calib_cpu_ms"] = round((calib_start + calibrate()) / 2, 3)
    summary["ok"] = not failures
    summary["failures"] = failures
    promote_v = (summary.get("promote") or {}).get("verdict") or {}
    summary["sweep"] = [{
        "mode": "rollout", "on_tpu": False, "batch": None,
        "rollout_promote_s": promote_v.get("promote_s"),
        "rollout_rollback_detect_s":
            (summary.get("rollback") or {}).get("detect_wall_s"),
        "rollout_observe_s": promote_v.get("observe_s"),
        "rollout_5xx": ((summary.get("promote") or {}).get("server_5xx", 0)
                        + (summary.get("rollback") or {}).get("server_5xx",
                                                              0)),
        "autoscale_peak_replicas":
            (summary.get("autoscale") or {}).get("peak_replicas"),
        "postmortem": ((summary.get("rollback") or {})
                       .get("postmortem") or {}).get("file"),
    }]
    out = json.dumps(summary, indent=1)
    print(out)
    if cli.out:
        with open(cli.out, "w") as f:
            f.write(out)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
