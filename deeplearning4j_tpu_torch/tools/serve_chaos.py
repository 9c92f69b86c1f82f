"""Chaos SLO gate: the serving fleet must hold its contract under faults.

    python -m deeplearning4j_tpu_torch.tools.serve_chaos --device cpu
    python -m deeplearning4j_tpu_torch.tools.serve_chaos --device cuda \\
        --model lm.zip --vocab 1024 --npy --buckets 1,4 --lm lm.zip \\
        --disagg-prompt-tokens 382 --disagg-max-tokens 32 \\
        --disagg-min-tokens 256

Counterpart of the JAX package's `tools/serve_chaos.py`, with the same
assertions and report keys. Stands up a REAL fleet (3 subprocess serving
replicas — each its own OS process and CUDA context — behind the
ReplicaSupervisor + ResilientRouter), drives closed-loop priority-tagged
traffic through the router, and mid-traffic:

1. **SIGKILLs one replica** (machine-loss analog: no drain, no goodbye);
2. **wedges another** via its fault endpoint (`POST /v1/faults` with
   ``probe_delay_s`` + ``predict_delay_s`` — alive process, dead service:
   probes and predicts hang past every deadline).

The SLO asserted from the traffic log and the router's /metrics:

- **zero 5xx**: every response is 200 or explicit backpressure (429
  shed / 503 no-backend) — faults never surface as server errors;
- the killed AND the wedged replica are **restarted and rejoin** (state
  ready, generation bumped) within ``RECOVERY_BUDGET_S``, proven by
  ``serving_fleet_restarts_total`` and live /readyz;
- the breaker state gauge and per-class shed counters are exposed, and
  shedding hit the LOW class (`serving_router_shed_total{cls="batch"}`);
- **post-fault p99 recovers** to within ``max(3 * base, base + 500 ms)``
  of the pre-fault baseline;
- the **SLO engine pages on the wedge**: a fast-burn availability alert
  (windows scaled to drill seconds) fires while the fleet is degraded —
  tripping a ``slo_availability_burn`` flight postmortem with request
  evidence — and resolves once traffic is clean again.

Then a **disaggregation drill**: a prefill/decode split LM fleet (``--lm``,
subprocess replicas with ``kv_role`` prefill and decode, the router
orchestrating KV-page transfers); the prefill replica is SIGKILLed while
transfers are the serving path. Streams before the kill ride completed
transfers (``serving_transfer_orchestrations_total``) with greedy output
equal across repeats; the kill trips the router's mid-transfer failover
(``serving_transfer_failovers_total``), the client sees 200s throughout
and a ``transfer_peer_lost`` postmortem names the dead peer. The report's
``disagg.streams`` lists each stream's prompt, tokens and whether its
transfer completed, so a caller can hold them to a single server.

The port's additions to the report: each replica's launch seconds
(process start to URL announcement) and the faulted replicas'
fault-to-ready seconds (``recovery``), and, on a CUDA fleet, the
router process's own device memory from ``nvidia-smi`` (the router
must hold none: it only proxies). The disaggregation drill's prompt
length, greedy tokens and transfer threshold default to the reference
drill's (12, 4, 8); a full-width LM takes prompts of hundreds of tokens,
so each transfer carries many KV pages. With ``--out``, each replica's
stderr goes to ``<out without its extension>_replicas/<replica>.log``.

Prints the JSON report (``--out`` also writes it). Exit 0 iff every SLO
held.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from urllib.error import HTTPError

N_IN, N_OUT = 6, 3
RECOVERY_BUDGET_S = 150.0       # a relaunch pays an import and a CUDA start
TINY_LM = ("zoo:TransformerLM?vocab_size=48&n_layers=1&n_embd=32"
           "&n_heads=4&seq_length=32")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _metric_total(metrics: str, prefix: str, contains: str = "") -> float:
    total = 0.0
    for line in metrics.splitlines():
        if line.startswith(prefix) and not line.startswith("# ") \
                and contains in line:
            try:
                total += float(line.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return total


def replica_env() -> dict:
    """Subprocess replicas' environment: this one, with the repo on the
    path so ``python -m deeplearning4j_tpu_torch.serving`` resolves from
    any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return env


def card_memory_of(pid: int):
    """MiB of device memory `pid` holds per ``nvidia-smi
    --query-compute-apps`` (0 when it holds none), or None where
    nvidia-smi cannot answer (no card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    total = 0
    for line in out.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0] == str(pid):
            try:
                total += int(parts[1])
            except ValueError:
                pass
    return total


def _sse_gen(url: str, model: str, prompt, max_new_tokens: int = 4,
             timeout: float = 60.0):
    """One greedy generate through the router's SSE surface; returns
    (status code | "transport", [tokens])."""
    body = json.dumps({"prompt": list(prompt),
                       "max_tokens": max_new_tokens,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(
        f"{url}/v1/models/{model}/generate", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            toks = []
            for raw in r:
                line = raw.decode("utf-8", "replace").strip()
                if line.startswith("data: "):
                    ev = json.loads(line[6:])
                    if "token" in ev:
                        toks.append(ev["token"])
            return r.status, toks
    except HTTPError as e:
        e.read()
        return e.code, []
    except Exception:               # noqa: BLE001 — recorded, asserted on
        return "transport", []


def replica_log_dir(out):
    """Where a drill's replicas write their stderr: beside its ``--out``
    report (``<out without its extension>_replicas``), or nowhere."""
    if not out:
        return None
    d = os.path.splitext(out)[0] + "_replicas"
    os.makedirs(d, exist_ok=True)
    return d


def replica_log(log_dir, name):
    return None if log_dir is None else os.path.join(log_dir, f"{name}.log")


def disagg_prompt(i: int, n_tokens: int, vocab: int) -> list:
    """The disaggregation drill's `i`-th prompt: the reference drill's
    ramp of token ids, `n_tokens` long."""
    return [(7 * i + j) % vocab for j in range(n_tokens)]


def _disagg_drill(env, pm_dir, lm_source, vocab, device, log_dir=None,
                  prompt_tokens=12, max_tokens=4, min_tokens=8):
    """Prefill/decode disaggregation under machine loss: a split LM
    fleet whose router ships KV pages from the prefill replica to the
    decode replica, then the prefill replica is SIGKILLed while those
    transfers are the serving path. Prompts are `prompt_tokens` long and
    each stream asks `max_tokens` greedy tokens; prompts of at least
    `min_tokens` are disaggregated. Returns (summary, failures)."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import (
        ReplicaSpec, ReplicaSupervisor, ResilientRouter, RouterServer,
        SubprocessReplica,
    )
    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig

    failures, out = [], {}
    roles = ("prefill", "decode")

    def factory(i):
        name = f"kv-{i}"
        return SubprocessReplica(
            name,
            ReplicaSpec([], lms=[("lm", lm_source)],
                        decode=DecodeConfig(slots=4, page_size=4),
                        postmortem_dir=pm_dir,
                        kv_role=roles[i % len(roles)], device=device),
            env=env, stderr_path=replica_log(log_dir, name))

    # the probe interval is deliberately SLOW: the drill tests the
    # ROUTER's mid-transfer failover, so the supervisor must not sweep
    # the corpse out of the routing set before the router trips over it
    sup = ReplicaSupervisor(factory, 2, probe_interval_s=30.0,
                            probe_timeout_s=2.0, unhealthy_after=3)
    t0 = time.perf_counter()
    sup.start()
    out["fleet_start_s"] = round(time.perf_counter() - t0, 1)
    out["launch_s"] = {r.name: r.launch_seconds for r in sup.replicas}
    router = ResilientRouter(sup.healthy, hedge=False,
                             disagg_min_tokens=min_tokens, timeout_s=30.0)
    server = RouterServer(router, supervisor=sup)
    codes = {}
    streams = []

    def transfer_total(family):
        return _metric_total(monitor.prometheus_text(), family)

    def gen(i, phase):
        prompt = disagg_prompt(i, prompt_tokens, vocab)
        before = transfer_total("serving_transfer_orchestrations_total")
        code, toks = _sse_gen(server.url, "lm", prompt, max_tokens)
        codes[code] = codes.get(code, 0) + 1
        streams.append({"prompt": prompt, "tokens": toks, "code": code,
                        "phase": phase,
                        "transferred": transfer_total(
                            "serving_transfer_orchestrations_total")
                        > before})
        return toks

    try:
        # same prompt twice: the orchestrated path must stay greedy-exact
        a, b = gen(0, "before_kill"), gen(0, "before_kill")
        if not a or a != b:
            failures.append(f"disaggregated greedy parity broke: "
                            f"{a} vs {b}")
        for i in range(1, 7):
            gen(i, "before_kill")
        orch = transfer_total("serving_transfer_orchestrations_total")
        out["orchestrations_before_kill"] = orch
        if orch <= 0:
            failures.append(
                "no disaggregated transfer completed before the kill — "
                "the drill never exercised the prefill/decode split")
        victim = sup.replicas[0]
        out["killed"] = victim.name
        victim.proc.kill()          # machine loss: no drain, no goodbye
        # the router must hit the dead transfer peer before the (slow)
        # supervisor does: keep offering streams until a failover meters
        deadline = time.monotonic() + 15.0
        i = 100
        while transfer_total("serving_transfer_failovers_total") <= 0 \
                and time.monotonic() < deadline:
            gen(i, "at_kill")
            i += 1
        out["failovers"] = transfer_total(
            "serving_transfer_failovers_total")
        if out["failovers"] <= 0:
            failures.append(
                "killing the prefill replica never tripped a transfer "
                "failover (the supervisor swept the corpse first?)")
        # streams keep flowing on local decode-side prefill afterwards
        for i in range(200, 204):
            if not gen(i, "after_kill"):
                failures.append(
                    f"stream {i} produced no tokens after the prefill "
                    "peer loss")
                break
    finally:
        sup.stop()
        server.stop()
    out["codes"] = {str(k): v for k, v in codes.items()}
    out["streams"] = streams
    bad = {c: n for c, n in codes.items()
           if isinstance(c, int) and c >= 500 and c != 503}
    if bad:
        failures.append(f"5xx during the disaggregation drill: {bad} "
                        "(contract: peer loss degrades to local "
                        "prefill, never a server error)")
    if codes.get("transport"):
        failures.append(
            f"{codes['transport']} transport-level failures reached the "
            "client during the disaggregation drill")
    # the failover must have postmortemed the DEAD PEER by name while
    # the request evidence was still in the flight ring
    pm = None
    for fn in sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) else []:
        if fn.startswith("postmortem-") and fn.endswith(".json"):
            with open(os.path.join(pm_dir, fn)) as f:
                doc = json.load(f)
            if doc["reason"] == "transfer_peer_lost" \
                    and doc["meta"].get("peer") == out.get("killed"):
                pm = (fn, doc)
    if pm is None:
        failures.append(
            "no transfer_peer_lost postmortem names the dead prefill "
            f"peer {out.get('killed')!r}")
    else:
        out["postmortem"] = {"file": pm[0], "meta": pm[1]["meta"],
                             "n_records": pm[1]["n_records"]}
    return out, failures


def _tiny_classifier_zip(path: str):
    """The reference drill's model: a 6-16-3 MLP, built and saved on the
    CPU (this process only routes; it never touches the card)."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.util.serialization import save_model
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    save_model(MultiLayerNetwork(conf, device="cpu").init(), path)


def _watch_recovery(supervisor, names, t0, stop):
    """Fault-to-ready seconds of each named replica: the first moment it
    is ready again with its generation bumped past the faulted one."""
    gens = {r.name: r.generation for r in supervisor.replicas
            if r.name in names}
    ready_s = {}
    while not stop.is_set() and len(ready_s) < len(gens):
        for r in supervisor.replicas:
            if r.name in gens and r.name not in ready_s \
                    and r.generation > gens[r.name] and r.state == "ready":
                ready_s[r.name] = round(time.monotonic() - t0, 3)
        time.sleep(0.05)
    return ready_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device every replica runs on (default "
                         "cuda; 'cpu' must be asked for)")
    ap.add_argument("--model", default=None, metavar="PATH",
                    help="model zip the predict fleet serves (default: "
                         "the reference drill's 6-16-3 MLP)")
    ap.add_argument("--vocab", type=int, default=None,
                    help="the model's inputs are token ids in [0, vocab) "
                         "(an LM), not uniform floats")
    ap.add_argument("--npy", action="store_true",
                    help="send and accept .npy bodies instead of JSON")
    ap.add_argument("--buckets", default="1,8",
                    help="replicas' batch-size bucket ladder")
    ap.add_argument("--lm", default=TINY_LM, metavar="SOURCE",
                    help="LM source of the disaggregation drill")
    ap.add_argument("--disagg-prompt-tokens", type=int, default=12,
                    help="prompt length of the disaggregation drill")
    ap.add_argument("--disagg-max-tokens", type=int, default=4,
                    help="greedy tokens each disaggregated stream asks")
    ap.add_argument("--disagg-min-tokens", type=int, default=8,
                    help="the router disaggregates prompts at least this "
                         "long")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON report here; the replicas' "
                         "stderr goes beside it")
    cli = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.monitor import flight
    from deeplearning4j_tpu_torch.monitor import slo as slo_mod
    from deeplearning4j_tpu_torch.monitor import timeseries
    from deeplearning4j_tpu_torch.serving import (
        ReplicaSpec, ReplicaSupervisor, ResilientRouter, RouterServer,
        SubprocessReplica,
    )
    from deeplearning4j_tpu_torch.tools.loadgen import LoadGen, calibrate

    failures = []
    summary = {"device": cli.device}
    calib_start = calibrate()
    tmp = tempfile.mkdtemp(prefix="serve_chaos_")
    model_zip = cli.model
    if model_zip is None:
        model_zip = os.path.join(tmp, "model.zip")
        _tiny_classifier_zip(model_zip)
    buckets = tuple(int(b) for b in cli.buckets.split(",") if b)
    log_dir = replica_log_dir(cli.out)

    # the always-on flight recorder: postmortems auto-dump into pm_dir
    # when the faults below trip an SLO (breaker open, wedge detection)
    pm_dir = os.path.join(tmp, "postmortems")
    flight.enable_flight(capacity=512, dump_dir=pm_dir)

    env = replica_env()
    spec = ReplicaSpec([("m", model_zip)], buckets=buckets,
                       max_delay_ms=2.0, queue_limit=64,
                       default_deadline_s=30.0, enable_faults=True,
                       postmortem_dir=pm_dir,
                       # replica-side SLO engines too, so the router's
                       # /v1/slo fleet verdict aggregates 4 reporters
                       slo_availability=0.995, slo_sample_interval_s=0.5,
                       device=cli.device)
    supervisor = ReplicaSupervisor(
        lambda i: SubprocessReplica(f"replica-{i}", spec, env=env,
                                    stderr_path=replica_log(
                                        log_dir, f"replica-{i}")),
        n_replicas=3, probe_interval_s=0.5, probe_timeout_s=2.0,
        unhealthy_after=3, restart_backoff_s=0.5, restart_budget=6)
    t0 = time.perf_counter()
    supervisor.start()
    summary["fleet_start_s"] = round(time.perf_counter() - t0, 1)
    summary["launch_s"] = {r.name: r.launch_seconds
                           for r in supervisor.replicas}
    meta = json.loads(urllib.request.urlopen(
        f"{supervisor.replicas[0].url}/v1/models/m", timeout=10).read())
    input_shape = tuple(meta["input_shape"])

    router = ResilientRouter(
        supervisor.healthy, classes=("interactive", "batch"),
        default_class="interactive", shed_floor=0.5,
        per_replica_inflight=4, hedge=True, hedge_min_s=0.2,
        timeout_s=30.0, breaker_open_for_s=3.0)
    server = RouterServer(router, supervisor=supervisor, port=0)

    # the SLO engine over the in-process time-series ring: availability
    # burn-rate alerting with windows scaled down to drill timescales so
    # the wedge fires a fast-burn page while the drill runs and resolves
    # once the fleet is clean again. "bad" = any non-2xx: faults surface
    # as 429/503 backpressure, never 5xx, and the availability objective
    # treats that backpressure as burned budget.
    ring = timeseries.enable_timeseries(interval_s=0.25, capacity=4096)
    slo_engine = slo_mod.enable_slo(
        [slo_mod.Objective(
            "router_availability", "availability",
            "serving_router_requests_total", target=0.98,
            bad_code=lambda code: not code.startswith("2"),
            reason="slo_availability_burn")],
        rules=(slo_mod.BurnRule("page", 10.0, 2.5, 2.0,
                                keep_firing_s=2.0),),
        ring=ring)

    class Args:                      # LoadGen's knob surface, programmatic
        url = server.url
        model = "m"
        requests = 120
        concurrency = 6
        rate = None
        batch_sizes = [1, 2, 4]
        priority_mix = {"interactive": 1, "batch": 1}
        max_retries = 4
        retry_cap_s = 2.0
        deadline_ms = None
        timeout_s = 60.0
        seed = 0
        vocab = cli.vocab
        npy = cli.npy

    try:
        # ---------------- phase A: pre-fault baseline -------------------
        base = LoadGen(Args, input_shape)
        wall, ok = base.run_closed()
        base_rep = base.report(wall, ok)
        summary["baseline"] = {"ok": ok, "codes": base_rep["codes"],
                               "p99_ms": base_rep["latency_ms"]["p99"]}
        if ok != Args.requests:
            failures.append(f"baseline phase not clean: {base_rep['codes']}")

        # ---------------- phase B: faults under traffic -----------------
        chaos_args = type("C", (Args,), {"requests": 240,
                                         "concurrency": 12,
                                         "seed": 1})
        chaos = LoadGen(chaos_args, input_shape)
        watch_stop = threading.Event()
        recovery_s = {}

        def inject():
            time.sleep(0.5)          # traffic flowing first
            victim = supervisor.replicas[0]
            wedged = supervisor.replicas[1]
            t_fault = time.monotonic()
            watcher = threading.Thread(
                target=lambda: recovery_s.update(_watch_recovery(
                    supervisor, {victim.name, wedged.name}, t_fault,
                    watch_stop)),
                daemon=True, name="chaos-recovery-watch")
            watcher.start()
            victim_gen = victim.generation
            victim.proc.kill()       # machine loss: SIGKILL, no drain
            wedged_gen = wedged.generation
            try:
                urllib.request.urlopen(urllib.request.Request(
                    wedged.url + "/v1/faults",
                    data=json.dumps({"probe_delay_s": 5.0,
                                     "predict_delay_s": 5.0}).encode(),
                    headers={"Content-Type": "application/json"}),
                    timeout=10).read()
            except Exception as e:   # noqa: BLE001
                failures.append(f"could not wedge replica-1: {e}")
            summary["faults"] = {"killed": victim.name,
                                 "killed_gen": victim_gen,
                                 "wedged": wedged.name,
                                 "wedged_gen": wedged_gen}
            summary["_watcher"] = watcher

        injector = threading.Thread(target=inject, daemon=True,
                                    name="chaos-injector")
        injector.start()
        fault_wall, fault_ok = chaos.run_closed()
        injector.join(timeout=30)
        # keep offering traffic until both faulted replicas rejoined (the
        # rejoin-within-budget half of the SLO) — stats accumulate
        deadline = time.monotonic() + RECOVERY_BUDGET_S
        extra_walls = 0.0

        def recovered() -> bool:
            a, b = supervisor.replicas[0], supervisor.replicas[1]
            return a.generation >= 1 and a.state == "ready" \
                and b.generation >= 1 and b.state == "ready"

        while not recovered() and time.monotonic() < deadline:
            w, o = chaos.run_closed()
            extra_walls += w
            fault_ok += o
        watcher = summary.pop("_watcher", None)
        if watcher is not None:
            watcher.join(timeout=5.0)
        watch_stop.set()
        chaos_rep = chaos.report(fault_wall + extra_walls, fault_ok)
        summary["under_fault"] = {
            "requests_total": sum(
                v for v in chaos.codes.values()),
            "codes": chaos_rep["codes"],
            "error_classes": chaos_rep["error_classes"],
            "retries": chaos_rep["retries"],
            "p99_ms": chaos_rep["latency_ms"]["p99"],
            "goodput_rps": chaos_rep["goodput_rps"],
            "per_class": chaos_rep.get("per_class"),
            "slowest": chaos_rep.get("slowest"),
        }
        bad = {c: n for c, n in chaos.codes.items()
               if isinstance(c, int) and c >= 500 and c not in (503,)}
        if bad:
            failures.append(f"5xx under fault: {bad} (contract: only "
                            "200/429/503)")
        if chaos.codes.get("transport"):
            failures.append(
                f"{chaos.codes['transport']} transport-level failures "
                "reached the client through the router")
        if not recovered():
            failures.append(
                "faulted replicas did not rejoin within "
                f"{RECOVERY_BUDGET_S:.0f}s: "
                f"{[r.describe() for r in supervisor.replicas]}")
        summary["recovery"] = {
            "replicas": [r.describe() for r in supervisor.replicas],
            "fault_to_ready_s": dict(recovery_s),
            "relaunch_s": {r.name: r.launch_seconds
                           for r in supervisor.replicas[:2]}}

        # ---------------- phase C: post-fault recovery ------------------
        rec_args = type("R", (Args,), {"seed": 2})
        rec = LoadGen(rec_args, input_shape)
        wall, ok = rec.run_closed()
        rec_rep = rec.report(wall, ok)
        summary["recovered"] = {"ok": ok, "codes": rec_rep["codes"],
                                "p99_ms": rec_rep["latency_ms"]["p99"]}
        if ok != Args.requests:
            failures.append(
                f"post-fault phase not clean: {rec_rep['codes']}")
        base_p99 = base_rep["latency_ms"]["p99"] or 0.0
        rec_p99 = rec_rep["latency_ms"]["p99"] or float("inf")
        p99_budget = max(3.0 * base_p99, base_p99 + 500.0)
        summary["recovered"]["p99_budget_ms"] = p99_budget
        if rec_p99 > p99_budget:
            failures.append(
                f"post-fault p99 {rec_p99:.1f}ms did not recover "
                f"(baseline {base_p99:.1f}ms, budget {p99_budget:.1f}ms)")

        # the router only proxies: on a card its process must hold none
        # of the card's memory (no CUDA context in the router)
        if cli.device.startswith("cuda"):
            mib = card_memory_of(os.getpid())
            summary["router_card_memory_mib"] = mib
            if mib is None:
                failures.append("nvidia-smi could not list the card's "
                                "compute processes")
            elif mib > 0:
                failures.append(f"the router process holds {mib} MiB of "
                                "card memory")

        # ---------------- SLO burn-rate alert timeline -------------------
        # the wedge must have fired the fast-burn availability page while
        # the fleet was degraded, and with traffic now stopped the burn
        # evidence ages out of both windows, so the alert must resolve
        resolve_deadline = time.monotonic() + 30.0
        while slo_engine.alert_state("router_availability", "page") \
                != "inactive" and time.monotonic() < resolve_deadline:
            time.sleep(0.25)
        alerts = slo_engine.history()
        summary["slo_alerts"] = alerts
        slo_fired = [h for h in alerts if h["event"] == "fired"]
        slo_resolved = [h for h in alerts if h["event"] == "resolved"]
        if not slo_fired:
            failures.append(
                "the wedge drill never fired the fast-burn availability "
                f"alert (history: {alerts})")
        if not slo_resolved:
            failures.append(
                "the availability alert did not resolve after recovery "
                "(state "
                f"{slo_engine.alert_state('router_availability', 'page')})")
        if slo_fired and slo_resolved \
                and slo_resolved[-1]["unix"] < slo_fired[0]["unix"]:
            failures.append("alert resolution precedes the first fire")

        # the firing alert must have tripped a flight postmortem that
        # carries actual request timelines as evidence
        slo_pm = None
        for fn in sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) \
                else []:
            if fn.startswith("postmortem-") and fn.endswith(".json"):
                with open(os.path.join(pm_dir, fn)) as f:
                    doc = json.load(f)
                if doc["reason"] == "slo_availability_burn":
                    slo_pm = (fn, doc)
        if slo_pm is None:
            failures.append(
                "the firing availability alert did not dump a "
                "slo_availability_burn flight postmortem")
        else:
            fn, doc = slo_pm
            summary["slo_postmortem"] = {"file": fn, "meta": doc["meta"],
                                         "n_records": doc["n_records"]}
            if doc["n_records"] <= 0:
                failures.append("slo_availability_burn postmortem "
                                "carries no flight records")

        # fleet verdict after recovery: the router engine plus all three
        # replica engines report, and nothing is firing any more
        fleet_slo = json.loads(urllib.request.urlopen(
            server.url + "/v1/slo", timeout=10).read())
        summary["fleet_slo"] = fleet_slo["fleet"]
        if not fleet_slo["router"].get("enabled"):
            failures.append("/v1/slo: router engine not enabled")
        if fleet_slo["fleet"]["state"] != "ok":
            failures.append(
                f"fleet SLO state after recovery: {fleet_slo['fleet']}")
        if fleet_slo["fleet"]["reporting"] < 4:
            failures.append(
                "expected router + 3 replica SLO engines reporting, got "
                f"{fleet_slo['fleet']['reporting']} "
                f"(unreachable: {fleet_slo['fleet']['unreachable']})")

        # ---------------- metrics assertions ----------------------------
        metrics = urllib.request.urlopen(server.url + "/metrics",
                                         timeout=10).read().decode()
        restarts = _metric_total(metrics, "serving_fleet_restarts_total")
        summary["fleet_restarts_total"] = restarts
        if restarts < 2:
            failures.append(f"expected >= 2 supervised restarts (kill + "
                            f"wedge), /metrics shows {restarts}")
        if "serving_router_breaker_state" not in metrics:
            failures.append("/metrics missing serving_router_breaker_state")
        shed_batch = _metric_total(metrics, "serving_router_shed_total",
                                   contains='cls="batch"')
        shed_inter = _metric_total(metrics, "serving_router_shed_total",
                                   contains='cls="interactive"')
        summary["shed"] = {"batch": shed_batch, "interactive": shed_inter}
        summary["hedges"] = _metric_total(metrics,
                                          "serving_router_hedges_total")
        if shed_batch == 0:
            failures.append("fleet saturation never shed the batch class "
                            "(serving_router_shed_total{cls=batch} == 0)")
        for fam in ("serving_fleet_replicas", "serving_fleet_probe_seconds",
                    "serving_router_requests_total"):
            if fam not in metrics:
                failures.append(f"/metrics missing {fam}")
        for fam in ("serving_flight_records_total",
                    "serving_flight_postmortems_total",
                    "timeseries_samples_total", "slo_burn_rate",
                    "slo_alert_state", "slo_alerts_total"):
            if fam not in metrics:
                failures.append(f"/metrics missing {fam}")

        # ---------------- flight-recorder postmortems --------------------
        # the fault window must have auto-dumped at least one postmortem
        # that (a) names the faulted replica's generation and (b) holds
        # the full timeline of at least one shed and one hedged request
        pms = []
        for fn in sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) \
                else []:
            if fn.startswith("postmortem-") and fn.endswith(".json"):
                with open(os.path.join(pm_dir, fn)) as f:
                    pms.append((fn, json.load(f)))
        summary["postmortems_dumped"] = [
            {"file": fn, "reason": doc["reason"], "meta": doc["meta"]}
            for fn, doc in pms]
        if not pms:
            failures.append("no flight postmortem auto-dumped during the "
                            f"fault window (dir {pm_dir})")
        faulted = summary.get("faults", {})
        named_gen = [
            (fn, doc) for fn, doc in pms
            if (doc["reason"] == "replica_wedged"
                and doc["meta"].get("replica") == faulted.get("wedged")
                and doc["meta"].get("generation")
                == faulted.get("wedged_gen"))
            or (doc["reason"] == "breaker_open"
                and doc["meta"].get("replica") in (faulted.get("killed"),
                                                   faulted.get("wedged")))]
        if pms and not named_gen:
            failures.append(
                "no postmortem names the killed/wedged replica "
                f"generation: {[d['meta'] for _, d in pms]}")

        def pm_evidence(doc):
            recs = doc.get("records", []) + doc.get("live", [])
            shed = [r for r in recs if r.get("outcome") == "shed_429"
                    or any(e.get("event") == "shed"
                           for e in r.get("events", []))]
            hedged = [r for r in recs
                      if any(e.get("event") == "hedge"
                             for e in r.get("events", []))]
            return shed, hedged

        banked_pm = None
        for fn, doc in reversed(named_gen or pms):
            shed, hedged = pm_evidence(doc)
            if shed and hedged:
                banked_pm = (fn, doc, shed, hedged)
                break
        if pms and banked_pm is None:
            # fall back to ANY dump carrying both timelines
            for fn, doc in reversed(pms):
                shed, hedged = pm_evidence(doc)
                if shed and hedged:
                    banked_pm = (fn, doc, shed, hedged)
                    break
        if pms and banked_pm is None:
            failures.append(
                "no postmortem holds both a shed and a hedged request "
                "timeline")
        if banked_pm is not None:
            fn, doc, shed, hedged = banked_pm
            summary["postmortem"] = {
                "file": fn, "reason": doc["reason"], "meta": doc["meta"],
                "n_records": doc["n_records"],
                "shed_records": len(shed), "hedged_records": len(hedged),
                "example_shed_trace": shed[-1].get("trace_id"),
                "example_hedged_trace": hedged[-1].get("trace_id"),
            }
    finally:
        slo_mod.disable_slo()        # engine first: it listens on the ring
        timeseries.disable_timeseries()
        supervisor.stop()
        server.stop()

    # ------------- disaggregation drill: prefill death mid-transfer -----
    # its own fleet (prefill/decode split LM replicas), run after the
    # predict fleet wound down so the two drills never contend
    disagg, disagg_failures = _disagg_drill(
        env, pm_dir, cli.lm, cli.vocab or 48, cli.device, log_dir=log_dir,
        prompt_tokens=cli.disagg_prompt_tokens,
        max_tokens=cli.disagg_max_tokens, min_tokens=cli.disagg_min_tokens)
    summary["disagg"] = disagg
    failures.extend(disagg_failures)

    summary["ok"] = not failures
    summary["failures"] = failures
    # host-speed reference sampled at both ends of the run and averaged
    summary["calib_cpu_ms"] = round((calib_start + calibrate()) / 2, 3)
    summary["sweep"] = [{
        "mode": "serve_chaos", "on_tpu": False, "batch": None,
        "chaos_p99_under_fault_ms": summary.get(
            "under_fault", {}).get("p99_ms"),
        "chaos_goodput_under_fault_rps": summary.get(
            "under_fault", {}).get("goodput_rps"),
        "chaos_recovered_p99_ms": summary.get(
            "recovered", {}).get("p99_ms"),
        "slow_trace_ids": summary.get("under_fault", {}).get("slowest"),
        "postmortem": summary.get("postmortem", {}).get("file"),
        "chaos_slo_fired_unix": next(
            (h["unix"] for h in summary.get("slo_alerts", [])
             if h["event"] == "fired"), None),
        "chaos_slo_resolved_unix": next(
            (h["unix"] for h in reversed(summary.get("slo_alerts", []))
             if h["event"] == "resolved"), None),
        "chaos_slo_burn_long_at_fire": next(
            (h["burn_long"] for h in summary.get("slo_alerts", [])
             if h["event"] == "fired"), None),
    }, {
        "mode": "serve_chaos_disagg", "on_tpu": False, "batch": None,
        "chaos_disagg_orchestrations": disagg.get(
            "orchestrations_before_kill"),
        "chaos_disagg_failovers": disagg.get("failovers"),
        "chaos_disagg_codes": disagg.get("codes"),
        "disagg_postmortem": (disagg.get("postmortem") or {}).get("file"),
    }]
    print(json.dumps(summary, indent=1))
    if cli.out:
        with open(cli.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
