#!/usr/bin/env python
"""Telemetry smoke: a short instrumented fit must leave a scrapeable
/metrics payload and a valid Perfetto-loadable trace.

    python -m deeplearning4j_tpu_torch.tools.telemetry_smoke \
        [--device cpu] [--trace-out T.json]

The port's counterpart of the JAX package's `tools/telemetry_smoke.py`,
with the same checks and summary keys; every network runs on
``--device`` (CUDA by default; it raises without CUDA unless ``cpu`` is
asked). On the CPU, where no peak rate is tabulated,
``DL4J_CUDA_PEAK_FLOPS`` defaults to a nominal 1e12 so the MFU gauge is
live (its value then means nothing; the smoke asserts liveness). The
port runs no sharded program — every rank of a plan runs its own whole
program on its pieces — so where the JAX smoke looks for a ``'data'``
PartitionSpec in a plan fit's ledger record, this one asserts that a
plan fit (a one-rank group formed here) books its program. Exercises
every instrumented subsystem in one process:

- ResilientTrainer fit over an AsyncDataSetIterator (train + ETL +
  resilience series; one injected NaN step ticks
  resilience_steps_skipped_total) with the compiled-program ledger
  enabled (xla_* series — the port's ledger of captured steps keeps
  the reference's family names — + a live train_mfu_pct) AND the
  goodput ledger
  enabled — the fit's attributed category seconds must sum to its
  externally measured wall-clock within tolerance (the exclusivity
  contract) and the train_goodput_pct / train_time_seconds_total
  families must be live,
- ParallelInference BATCHED serving (inference + serving-side ledger),
- a two-rank SocketTransport exchange (transport series),

then asserts:

- GET /metrics on a live UIServer returns valid Prometheus text with
  >= 20 distinct metric families spanning train/ETL/transport/
  resilience/inference/xla, including xla_compile_seconds,
  xla_program_flops, xla_hbm_peak_bytes, and a train_mfu_pct gauge that
  carries a live nonzero value from the real fit,
- the perf-ledger JSON (monitor.xla.save_ledger) is schema-valid and
  holds >= 1 captured program with a fingerprint and flops,
- the Chrome trace JSON loads, spans nest (train/step inside
  resilience/fit), xla/compile spans (a counted step's first run)
  appear, and at least two distinct thread tracks appear,
- traceparent propagation holds end-to-end through a live in-process
  fleet (router + 2 replicas over real HTTP): the router-minted
  trace_id comes back as X-Trace-Id AND appears in both a router span
  and a replica-side serving span; a client-supplied traceparent is
  adopted; the flight recorder exposes the request on
  GET /v1/debug/flight (router-aggregated) and the
  serving_flight_* / trace_* metric families are live,
- the SLO engine answers live over the same fleet: GET /v1/slo reports
  the router's engine enabled with a fleet verdict, /v1/timeseries
  serves windowed counter increases from real traffic, the
  ``?format=openmetrics`` exposition renders histogram trace exemplars
  and terminates with ``# EOF`` while the default v0.0.4 exposition
  stays exemplar-free, and the ``timeseries_*`` / ``slo_*`` metric
  families are live,
- `tools/trace_report.py` merges per-process segments into one valid
  Perfetto document with distinct process tracks (pid collisions
  remapped).

Exit code 0 on success, 1 on failure; prints a JSON summary either way.
"""
import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

GROUPS = {
    "train": ("train_",),
    "etl": ("etl_", "train_etl_"),
    "transport": ("transport_",),
    "resilience": ("resilience_",),
    "inference": ("inference_",),
    "xla": ("xla_",),
}

#: acceptance families the compiled-step observatory must expose
XLA_REQUIRED = ("xla_compile_seconds", "xla_program_flops",
                "xla_hbm_peak_bytes", "train_mfu_pct")

#: request-tracing + flight-recorder families
TRACE_REQUIRED = ("trace_contexts_minted_total",
                  "serving_flight_records_total")

#: time-series ring + SLO engine families; slo_alerts_total is
#: deliberately absent —
#: a clean smoke run never transitions an alert
SLO_REQUIRED = ("timeseries_samples_total", "timeseries_sample_seconds",
                "timeseries_series", "slo_objective_ratio",
                "slo_burn_rate", "slo_alert_state")

#: goodput-ledger families; train_step_anomalies_total is deliberately absent — a clean smoke
#: fit never trips the anomaly detector
GOODPUT_REQUIRED = ("train_goodput_pct", "train_time_seconds_total")

#: exclusivity tolerance: attributed category seconds vs the externally
#: measured fit wall-clock (acceptance: within 5%, plus a small absolute
#: slack for the clock reads outside the session)
GOODPUT_SUM_TOL_FRAC = 0.05
GOODPUT_SUM_TOL_ABS_S = 0.25

#: top-level + per-program keys of the persisted perf-ledger schema
LEDGER_KEYS = ("version", "created_unix", "device_kind", "backend",
               "peak_flops", "hbm_bytes_per_sec", "programs")
PROGRAM_KEYS = ("fingerprint", "name", "domain", "arg_shapes", "hlo_hash",
                "compile_seconds", "compiles", "flops", "bytes_accessed",
                "arithmetic_intensity", "hbm", "hbm_peak_bytes",
                "examples_per_call", "steps_per_call",
                "total_flops_per_call", "arg_shardings", "sharded",
                "first_captured_unix")


def _net(device, seed=0):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _transport_exchange(failures):
    """One round-trip over the host-side DCN path (two in-process ranks)."""
    from deeplearning4j_tpu_torch.parallel.transport import SocketTransport
    base = 30200 + (os.getpid() % 5000)
    msg = (np.arange(4, dtype=np.int32), np.ones(4, np.float32), 0.5)
    try:
        with SocketTransport(0, 2, base_port=base) as t0, \
                SocketTransport(1, 2, base_port=base) as t1:
            t0.broadcast(0, msg)
            t1.broadcast(1, msg)
            t0.recv(1, timeout=20)
            t1.recv(1, timeout=20)
    except Exception as e:  # noqa: BLE001
        failures.append(f"transport exchange failed: {type(e).__name__}: {e}")


def _span_index(events):
    return [e for e in events if e.get("ph") == "X"]


def _nested(parent, child):
    eps = 1.0  # µs
    return (parent["tid"] == child["tid"]
            and parent["ts"] - eps <= child["ts"]
            and child["ts"] + child.get("dur", 0)
            <= parent["ts"] + parent.get("dur", 0) + eps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trace-out", default=None,
                   help="default: a fresh temp file")
    p.add_argument("--perf-ledger", default=None,
                   help="perf-ledger JSON path (default: alongside the "
                        "trace)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device of every network (default cuda; "
                        "raises without it)")
    args = p.parse_args(argv)
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(args.device)
    set_f32_matmul_exact()
    if device.type == "cpu":
        os.environ.setdefault("DL4J_CUDA_PEAK_FLOPS", "1e12")
    trace_path = args.trace_out or os.path.join(
        tempfile.mkdtemp(prefix="telemetry_smoke_"), "trace.json")
    ledger_path = args.perf_ledger or os.path.join(
        os.path.dirname(trace_path), "perf_ledger.json")

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.data.async_iterator import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel.inference import (
        InferenceMode, ParallelInference,
    )
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener
    from deeplearning4j_tpu_torch.train.resilience import ResilientTrainer
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.util.faults import FaultInjector

    monitor.enable_tracing()
    monitor.xla.enable_ledger(ledger_path)
    monitor.goodput.enable_goodput()
    failures = []
    summary = {"device": str(device), "trace_out": trace_path,
               "perf_ledger": ledger_path}

    # ---- train + ETL + resilience -------------------------------------
    rs = np.random.RandomState(0)
    X = rs.randn(96, 6).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 96)]
    net = _net(device)
    net.set_listeners(PerformanceListener(frequency=1, report=False))
    ckdir = tempfile.mkdtemp(prefix="telemetry_ck_")
    source = AsyncDataSetIterator(
        ArrayDataSetIterator(X, Y, batch_size=args.batch_size))
    trainer = ResilientTrainer(
        net, ckdir, save_every_n_iterations=4,
        injector=FaultInjector(nan_at=[3]))
    fit_t0 = time.perf_counter()
    report = trainer.fit(source, epochs=args.epochs,
                         batch_size=args.batch_size)
    fit_wall = time.perf_counter() - fit_t0
    summary["fit"] = {"applied": report.applied_steps,
                      "skipped": report.skipped_steps,
                      "checkpoints": report.checkpoints_written}
    if report.skipped_steps < 1:
        failures.append("injected NaN step was not skipped")

    # ---- goodput exclusivity: attributed seconds == measured wall ------
    if report.goodput_pct is None or not report.time_by_category:
        failures.append("FitReport carries no goodput session summary")
    else:
        attributed = sum(report.time_by_category.values())
        tol = max(GOODPUT_SUM_TOL_FRAC * fit_wall, GOODPUT_SUM_TOL_ABS_S)
        summary["goodput"] = {
            "goodput_pct": report.goodput_pct,
            "categories_s": {k: round(v, 4)
                             for k, v in report.time_by_category.items()},
            "attributed_s": round(attributed, 4),
            "measured_wall_s": round(fit_wall, 4)}
        if abs(attributed - fit_wall) > tol:
            failures.append(
                f"goodput exclusivity broke: categories sum to "
                f"{attributed:.3f}s but the fit measured {fit_wall:.3f}s "
                f"(tolerance {tol:.3f}s)")
        if any(v < 0 for v in report.time_by_category.values()):
            failures.append("goodput category went negative: "
                            f"{report.time_by_category}")

    # ---- plan fit: the ledger books the plan's program ---------------
    from deeplearning4j_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.parallel.plan import ShardingPlan
    import torch.distributed as dist
    formed = not dist.is_initialized()
    initialize_distributed(device_type=device.type, single=True)
    try:
        before = {r.fingerprint for r in monitor.xla.records()}
        pnet = _net(device, seed=3)
        Xp = rs.randn(128, 6).astype("float32")
        Yp = np.eye(3, dtype="float32")[rs.randint(0, 3, 128)]
        pnet.fit(ArrayDataSetIterator(Xp, Yp, batch_size=32), epochs=1,
                 plan=ShardingPlan(data=-1))
        booked = [r for r in monitor.xla.records()
                  if r.fingerprint not in before and r.domain == "train"]
        if not booked:
            failures.append("plan fit booked no program in the ledger")
        summary["plan_programs"] = len(booked)
    finally:
        if formed:
            shutdown_distributed()

    # ---- inference -----------------------------------------------------
    with ParallelInference(net, mode=InferenceMode.BATCHED,
                           max_batch_size=32) as pi:
        out = pi.output(X[:8])
    if out.shape != (8, 3):
        failures.append(f"inference output shape {out.shape} != (8, 3)")

    # ---- transport -----------------------------------------------------
    _transport_exchange(failures)

    # ---- serving fleet: traceparent propagation + flight recorder ------
    from deeplearning4j_tpu_torch.monitor import flight
    from deeplearning4j_tpu_torch.serving.fleet import (
        InProcessReplica, ReplicaSpec, ReplicaSupervisor,
    )
    from deeplearning4j_tpu_torch.serving.router import (
        ResilientRouter, RouterServer,
    )
    flight.enable_flight(capacity=64, dump_dir=os.path.join(
        os.path.dirname(trace_path), "postmortems"))
    # SLO engine over the in-process time-series ring, watching the
    # router's own metric families (short windows: the smoke only needs
    # the machinery live, not SRE-workbook timescales)
    from deeplearning4j_tpu_torch.monitor import slo as slo_mod
    from deeplearning4j_tpu_torch.monitor import timeseries
    ring = timeseries.enable_timeseries(interval_s=0.2, capacity=512)
    slo_mod.enable_slo(
        slo_mod.router_objectives(slo_p99_ms=5000.0,
                                  availability_target=0.99),
        rules=(slo_mod.BurnRule("page", 5.0, 1.0, 14.4),), ring=ring)
    serve_net = _net(device, seed=7)
    spec = ReplicaSpec([("m", serve_net)], buckets=(1, 8),
                       max_delay_ms=1.0, device=str(device))
    supervisor = ReplicaSupervisor(
        lambda i: InProcessReplica(f"replica-{i}", spec), n_replicas=2,
        probe_interval_s=0.5)
    supervisor.start()
    router = ResilientRouter(supervisor.healthy, hedge=False)
    rserver = RouterServer(router, supervisor=supervisor, port=0)
    try:
        body = json.dumps(
            {"inputs": rs.rand(2, 6).astype("float32").tolist()}).encode()
        # 1) no client header: the ROUTER mints the context
        r = urllib.request.urlopen(urllib.request.Request(
            rserver.url + "/v1/models/m/predict", data=body,
            headers={"Content-Type": "application/json",
                     "X-Priority": "interactive"}), timeout=30)
        r.read()
        minted = r.headers.get("X-Trace-Id")
        summary["router_minted_trace_id"] = minted
        if r.status != 200:
            failures.append(f"fleet predict answered {r.status}")
        if not minted:
            failures.append("router response carries no X-Trace-Id")
        # 2) client-supplied traceparent is ADOPTED, not replaced
        client_tid = "ab" * 16
        r = urllib.request.urlopen(urllib.request.Request(
            rserver.url + "/v1/models/m/predict", data=body,
            headers={"Content-Type": "application/json",
                     "traceparent": f"00-{client_tid}-{'cd' * 8}-01"}),
            timeout=30)
        r.read()
        if r.headers.get("X-Trace-Id") != client_tid:
            failures.append(
                "client traceparent not adopted: X-Trace-Id "
                f"{r.headers.get('X-Trace-Id')} != {client_tid}")
        # 3) ONE trace_id spans router AND replica-side serving spans
        events = [e for e in monitor.trace_events()
                  if e.get("ph") == "X" and minted
                  and (e.get("args") or {}).get("trace_id") == minted]
        names = {e["name"] for e in events}
        summary["propagated_span_names"] = sorted(names)
        if "serving/route" not in names:
            failures.append("router-minted id missing from the "
                            "serving/route span")
        if not names & {"serving/request", "serving/batch",
                        "serving/queue_wait"}:
            failures.append(
                "router-minted id never reached a replica-side span "
                f"(got {sorted(names)}) — traceparent propagation broke")
        # 4) the router-aggregated flight endpoint shows the request
        fdoc = json.loads(urllib.request.urlopen(
            rserver.url + "/v1/debug/flight", timeout=10).read())
        router_recs = fdoc.get("router", {}).get("records", [])
        if minted and not any(rec.get("trace_id") == minted
                              for rec in router_recs):
            failures.append("router flight ring has no record for the "
                            "minted trace_id")
        if len(fdoc.get("replicas", {})) != 2:
            failures.append("router /v1/debug/flight did not aggregate "
                            "both replicas")
        elif minted and not any(
                rec.get("trace_id") == minted
                for rep in fdoc["replicas"].values()
                for rec in rep.get("records", [])):
            failures.append("no replica flight record carries the "
                            "minted trace_id")
        summary["flight_router_records"] = len(router_recs)
        # 5) SLO + time-series endpoints answer live over real traffic.
        # Bracket a known burst of predicts with explicit samples so the
        # windowed increase is deterministic (the background sampler
        # also runs; extra samples are harmless).
        ring.sample()
        for _ in range(3):
            urllib.request.urlopen(urllib.request.Request(
                rserver.url + "/v1/models/m/predict", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=30).read()
        ring.sample()
        slo_doc = json.loads(urllib.request.urlopen(
            rserver.url + "/v1/slo", timeout=10).read())
        summary["fleet_slo"] = slo_doc.get("fleet")
        if not slo_doc.get("router", {}).get("enabled"):
            failures.append("/v1/slo: router SLO engine not enabled")
        if len(slo_doc.get("replicas", {})) != 2:
            failures.append("/v1/slo did not poll both replicas")
        if slo_doc.get("fleet", {}).get("state") != "ok":
            failures.append("clean smoke traffic should leave the fleet "
                            f"SLO ok, got {slo_doc.get('fleet')}")
        ts_doc = json.loads(urllib.request.urlopen(
            rserver.url + "/v1/timeseries?series="
            "serving_router_requests_total&window=60", timeout=10).read())
        summary["timeseries_query"] = ts_doc
        if ts_doc.get("kind") != "counter" \
                or (ts_doc.get("increase") or 0) < 3:
            failures.append(
                "windowed /v1/timeseries increase did not cover the "
                f"predict burst: {ts_doc}")
        # 6) OpenMetrics opt-in renders exemplars + # EOF; the default
        # v0.0.4 exposition stays byte-compatible (no exemplars, no EOF)
        om = urllib.request.urlopen(
            rserver.url + "/metrics?format=openmetrics",
            timeout=10).read().decode()
        v004 = urllib.request.urlopen(
            rserver.url + "/metrics", timeout=10).read().decode()
        if not om.endswith("# EOF\n"):
            failures.append("openmetrics exposition missing # EOF "
                            "terminator")
        if ' # {trace_id="' not in om:
            failures.append("openmetrics exposition carries no histogram "
                            "trace exemplars")
        if "# EOF" in v004 or ' # {' in v004:
            failures.append("default /metrics exposition leaked "
                            "OpenMetrics syntax (v0.0.4 compat broke)")
    finally:
        slo_mod.disable_slo()       # engine first: it listens on the ring
        timeseries.disable_timeseries()
        supervisor.stop()
        rserver.stop()

    # ---- /metrics scrape ----------------------------------------------
    server = UIServer(port=0)
    try:
        body = urllib.request.urlopen(server.url + "metrics",
                                      timeout=10).read().decode()
    finally:
        server.stop()
    families = [ln.split()[2] for ln in body.splitlines()
                if ln.startswith("# TYPE ")]
    summary["metric_families"] = len(families)
    if len(families) < 20:
        failures.append(f"only {len(families)} metric families exposed "
                        f"(need >= 20): {families}")
    for group, prefixes in GROUPS.items():
        if not any(f.startswith(pre) for f in families for pre in prefixes):
            failures.append(f"no {group} metrics in /metrics exposition")
    for fam in XLA_REQUIRED:
        if fam not in families:
            failures.append(f"{fam} missing from /metrics exposition")
    for fam in TRACE_REQUIRED:
        if fam not in families:
            failures.append(f"{fam} missing from /metrics exposition")
    for fam in SLO_REQUIRED:
        if fam not in families:
            failures.append(f"{fam} missing from /metrics exposition")
    for fam in GOODPUT_REQUIRED:
        if fam not in families:
            failures.append(f"{fam} missing from /metrics exposition")

    # ---- static<->live family cross-check ------------------------------
    # graftlint rule (8) extracts the emitted families from the AST and
    # gates them against the metric catalog; the smoke consumes the
    # SAME extraction so the catalog check and the live scrape can't
    # drift apart: every family this live run exposed must be one the
    # static analysis knows about.
    from deeplearning4j_tpu_torch.analysis import extract_metric_families
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    static_families = set(extract_metric_families([pkg]))
    summary["static_metric_families"] = len(static_families)
    unknown = sorted(f for f in families if f not in static_families)
    if unknown:
        failures.append(
            "live /metrics exposes families the static extraction (and "
            f"therefore the catalog gate) cannot see: {unknown} — "
            "dynamic family names bypass metric-family-registration")
    skip_ctr = monitor.REGISTRY.collect("resilience_steps_skipped_total")
    if skip_ctr is None or skip_ctr.value() < 1:
        failures.append("resilience_steps_skipped_total did not increment")

    # ---- compiled-program ledger ---------------------------------------
    mfu = monitor.REGISTRY.collect("train_mfu_pct")
    summary["train_mfu_pct"] = None if mfu is None else mfu.value()
    if mfu is None or mfu.value() <= 0:
        failures.append("train_mfu_pct gauge not live after the fit")
    compiles = monitor.REGISTRY.collect("xla_compiles_total")
    if compiles is None or not compiles._children:
        failures.append("xla_compiles_total never incremented")
    try:
        n_progs = monitor.xla.save_ledger(ledger_path)
        summary["ledger_programs"] = n_progs
        with open(ledger_path) as f:
            ledger = json.load(f)
        missing = [k for k in LEDGER_KEYS if k not in ledger]
        if missing:
            failures.append(f"perf ledger missing keys: {missing}")
        if not ledger.get("programs"):
            failures.append("perf ledger captured no programs")
        else:
            prog = ledger["programs"][0]
            missing = [k for k in PROGRAM_KEYS if k not in prog]
            if missing:
                failures.append(f"ledger program missing keys: {missing}")
            if not prog.get("fingerprint"):
                failures.append("ledger program has no fingerprint")
            if not any(p.get("flops") for p in ledger["programs"]):
                failures.append("no ledger program carries flops")
    except (OSError, ValueError) as e:
        failures.append(f"perf ledger invalid: {type(e).__name__}: {e}")

    # ---- trace validity ------------------------------------------------
    n_events = monitor.save_trace(trace_path)
    summary["trace_events"] = n_events
    try:
        with open(trace_path) as f:
            doc = json.load(f)
        spans = _span_index(doc["traceEvents"])
        fits = [e for e in spans if e["name"] == "resilience/fit"]
        steps = [e for e in spans if e["name"] == "train/step"]
        if not fits or not steps:
            failures.append("missing resilience/fit or train/step spans")
        elif not any(_nested(f, s) for f in fits for s in steps):
            failures.append("train/step spans do not nest inside "
                            "resilience/fit")
        compiles = [e for e in spans if e["name"] == "xla/compile"]
        summary["xla_compile_spans"] = len(compiles)
        if not compiles:
            failures.append("no xla/compile spans in the trace")
        tids = {e["tid"] for e in spans}
        summary["trace_threads"] = len(tids)
        if len(tids) < 2:
            failures.append("expected spans from >= 2 threads "
                            "(train + prefetch/inference workers)")
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"trace file invalid: {type(e).__name__}: {e}")

    # ---- merged-trace validity (tools/trace_report.py) -----------------
    # simulate the fleet layout: this process's saved trace plus a
    # second "replica" segment whose pid COLLIDES — the merge must
    # remap pids, name both process tracks, and stay JSON-valid
    from deeplearning4j_tpu_torch.tools import trace_report
    seg2_path = os.path.join(os.path.dirname(trace_path), "segment2.json")
    with open(seg2_path, "w") as f:
        json.dump({"traceEvents": [
            {"name": "serving/request", "ph": "X", "ts": 1.0, "dur": 5.0,
             "pid": os.getpid(), "tid": 1,
             "args": {"trace_id": "ff" * 16}}]}, f)
    try:
        merged = trace_report.merge_trace_files(
            [("router", trace_path), ("replica", seg2_path)])
        json.loads(json.dumps(merged))        # round-trip validity
        procs = {e.get("pid") for e in merged["traceEvents"]}
        pnames = [e for e in merged["traceEvents"]
                  if e.get("ph") == "M" and e.get("name") == "process_name"]
        summary["merged_process_tracks"] = len(pnames)
        if len(procs) < 2 or len(pnames) < 2:
            failures.append(
                f"merged trace did not keep 2 process tracks apart "
                f"(pids {sorted(procs)}, {len(pnames)} names) — pid "
                "collision remap broke")
        if not trace_report.events_for_trace(merged, "ff" * 16):
            failures.append("merged trace lost the replica segment's "
                            "trace_id-carrying span")
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"trace_report merge failed: "
                        f"{type(e).__name__}: {e}")

    summary["failures"] = failures
    summary["ok"] = not failures
    print(json.dumps(summary, indent=1))
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
