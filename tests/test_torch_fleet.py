"""The port's replica supervisor and resilient router (`serving/fleet.py`,
`serving/router.py`) held to the JAX package's.

- Every non-slow case of the reference's tests/test_fleet.py, and its
  router cases in tests/test_kvfabric.py (prefix affinity, the
  disaggregated prefill's failover), tests/test_slo.py (the fleet SLO
  fold) and tests/test_trace.py (traceparent pass-through, the replica
  argv's flight knobs, the wedge postmortem), run against the port
  (`_torch_reference_cases.port_cases`).
- Decision-trace parity: both packages' `ReplicaSupervisor` and
  `ResilientRouter` are driven with the same fake clock, the same seeded
  `random.Random` and the same scripted probe and transport outcomes;
  every replica pick, breaker state, shed code, Retry-After, hedge,
  restart time, replacement and autoscale event must be identical
  (exact: the policies are pure Python on floats).
- `SubprocessReplica._argv()` is the reference's with the module name
  replaced and ``--device`` appended.
"""
import json
import random
import sys
import threading
import types

import numpy as np
import pytest

import _torch_reference_cases as refcases
from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu.serving.decode import DecodeConfig as JDecodeConfig
from deeplearning4j_tpu.util.faults import serving_faults as jserving_faults
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import fleet, router
from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
from deeplearning4j_tpu_torch.util.faults import serving_faults

PORT = types.SimpleNamespace(fleet=fleet, router=router, monitor=monitor)
REF = types.SimpleNamespace(fleet=jfleet, router=jrouter, monitor=jmonitor)


def _reset_all():
    for mon, faults in ((monitor, serving_faults), (jmonitor,
                                                     jserving_faults)):
        mon.REGISTRY.reset()
        mon.disable_tracing()
        mon.clear_trace()
        mon.flight.disable_flight()
        mon.flight.clear()
        mon.slo.disable_slo()
        mon.timeseries.disable_timeseries()
        faults().clear()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


# ------------------------------------------------ the reference's cases
FLEET_CASES = refcases.port_cases("tests/test_fleet.py",
                                  module_name="torch_port_of_test_fleet")
ROUTER_CASES = {
    "kvfabric": refcases.port_cases(
        "tests/test_kvfabric.py",
        names={"_counter", "_fake_replicas", "_fake_router",
               "test_affinity_pick_owner_fallback_and_none",
               "test_disagg_prefill_failover_meters_the_dead_peer"}),
    "slo": refcases.port_cases(
        "tests/test_slo.py",
        names={"_get_json", "test_router_slo_fleet_aggregation_worst_state_wins",
               "test_router_slo_marks_unreachable_replicas"}),
    "trace": refcases.port_cases(
        "tests/test_trace.py",
        names={"test_router_passes_traceparent_through_when_recorder_off",
               "test_subprocess_replica_argv_threads_flight_knobs",
               "test_supervisor_wedge_trips_postmortem"}),
}


def test_the_reference_fleet_cases_are_all_here():
    """26 non-slow cases in tests/test_fleet.py; 7 router cases across
    the kvfabric, slo and trace files."""
    assert len(refcases.case_names(FLEET_CASES)) == 26
    assert sum(len(refcases.case_names(m))
               for m in ROUTER_CASES.values()) == 7


@pytest.mark.parametrize("name", refcases.case_names(FLEET_CASES))
def test_reference_fleet_case(name, request):
    refcases.run_case(FLEET_CASES, name, request)


@pytest.mark.parametrize("source,name", [
    (src, n) for src, mod in sorted(ROUTER_CASES.items())
    for n in refcases.case_names(mod)])
def test_reference_router_case(source, name, request):
    refcases.run_case(ROUTER_CASES[source], name, request)


# ------------------------------------------------- decision-trace parity
class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _supervisor_script(ticks=80, names=8, seed=3):
    """Per tick: {name: (probe_ok, crash)} and the fleet's in-flight
    level (drives the autoscaler up, then down)."""
    rs = np.random.RandomState(seed)
    steps = []
    for t in range(ticks):
        per = {f"f{i}": (bool(rs.rand() > 0.15), bool(rs.rand() < 0.04))
               for i in range(names)}
        load = 2 if 10 <= t < 30 else (0 if t >= 45 else 1)
        steps.append((per, load, float(rs.choice([0.5, 1.0, 2.5]))))
    return steps


def _supervisor_trace(P, script):
    clock = FakeClock()

    class FakeReplica(P.fleet.Replica):
        def __init__(self, name, spec=None):
            super().__init__(name, spec)
            self.alive_flag = False
            self.probe_ok = True
            self.launches = self.kills = self.stops = 0

        def launch(self):
            self.launches += 1
            self.alive_flag = True
            self.probe_ok = True
            self.url = f"http://fake/{self.name}/{self.launches}"

        def alive(self):
            return self.alive_flag

        def kill(self):
            self.kills += 1
            self.alive_flag = False

        def stop(self):
            self.stops += 1
            self.alive_flag = False

        def begin_drain(self):
            self.probe_ok = False

    cfg = P.fleet.AutoscaleConfig(min_replicas=2, max_replicas=4,
                                  capacity_per_replica=2, up_after_ticks=2,
                                  down_after_ticks=3, cooldown_s=3.0,
                                  drain_timeout_s=5.0)
    sup = P.fleet.ReplicaSupervisor(
        lambda i: FakeReplica(f"f{i}"), 3, probe_interval_s=1.0,
        unhealthy_after=2, restart_backoff_s=1.0, restart_budget=3,
        restart_budget_window_s=40.0, time_fn=clock,
        sleep_fn=lambda s: None, rng=random.Random(11),
        probe_fn=lambda r, timeout: r.probe_ok and r.alive(),
        spawn_fn=lambda fn, name: (fn(), None)[1], autoscale=cfg)
    for r in sup.replicas:
        r.launch()
    trace = []
    for per, load, dt in script:
        for r in sup.replicas:
            probe_ok, crash = per[r.name]
            if r.state not in ("dead", "stopped", "draining"):
                r.probe_ok = r.probe_ok and probe_ok or (
                    probe_ok and r.state == "backoff")
                if crash:
                    r.alive_flag = False
            r._inflight = load if r.state == "ready" else 0
        sup.tick()
        trace.append([(r.name, r.state, r.generation, r.restart_attempt,
                       r.restart_at, r.consecutive_probe_failures,
                       r.launches, r.kills, r.stops,
                       None if r.scaledown is None else dict(r.scaledown))
                      for r in sup.replicas])
        clock.advance(dt)
        # a replica heals its probe once it is past a restart
        for r in sup.replicas:
            if r.state == "starting":
                r.probe_ok = True
    counters = {}
    for fam in ("serving_fleet_restarts_total",
                "serving_autoscale_events_total",
                "serving_fleet_gave_up_total",
                "serving_autoscale_forced_kills_total"):
        fam_obj = P.monitor.REGISTRY.collect(fam)
        counters[fam] = None if fam_obj is None else sorted(
            (tuple(sorted(s["labels"].items())), s["value"])
            for s in P.monitor.dump()[fam]["series"])
    return trace, counters


def test_supervisor_decisions_equal_the_references():
    script = _supervisor_script()
    mine = _supervisor_trace(PORT, script)
    ref = _supervisor_trace(REF, script)
    states = {s for tick in mine[0] for (_, s, *_rest) in tick}
    # the script reaches every decision path: crash restarts, probe
    # replacements, backoff, scale up and a drained scale-down
    assert {"ready", "backoff", "starting"} <= states
    assert mine[1]["serving_autoscale_events_total"]
    assert mine[1]["serving_fleet_restarts_total"]
    assert mine == ref


def _router_script(n=160, seed=5):
    rs = np.random.RandomState(seed)
    outcomes = ["ok"] * 6 + ["http500", "transport", "429", "503", "504"]
    return {
        "outcome": [outcomes[rs.randint(len(outcomes))]
                    for _ in range(4 * n)],
        "inflight": [[int(v) for v in rs.randint(0, 4, 5)]
                     for _ in range(n)],
        "cls": [[None, "interactive", "standard", "batch", "BATCH",
                 "nope"][rs.randint(6)] for _ in range(n)],
        "dt": [float(rs.choice([0.0, 0.5, 3.0])) for _ in range(n)],
    }


def _router_trace(P, script):
    clock = FakeClock()
    calls = []
    reps = []
    for i in range(5):
        r = P.fleet.Replica(f"r{i}")
        r.state = "ready"
        r.url = f"http://fake-{i}"
        reps.append(r)
    reps[4].role = "canary"

    def transport(replica, path, body, headers, timeout):
        kind = script["outcome"][len(calls) % len(script["outcome"])]
        calls.append((replica.name, path, kind))
        if kind == "transport":
            raise P.router.ReplicaTransportError(f"{replica.name}: refused")
        code = {"ok": 200, "http500": 500, "429": 429, "503": 503,
                "504": 504}[kind]
        hdrs = {"Content-Type": "application/json"}
        if code in (429, 503):
            hdrs["Retry-After"] = "2"
        return code, hdrs, json.dumps({"who": replica.name}).encode()

    rt = P.router.ResilientRouter(
        lambda: [r for r in reps if r.state == "ready"], transport=transport,
        hedge=False, rng=random.Random(9), time_fn=clock,
        per_replica_inflight=3, shed_floor=0.6, max_attempts=3,
        breaker_window=6, breaker_min_samples=3, breaker_open_for_s=4.0,
        canary_fraction=0.3)
    out = []
    for i in range(len(script["inflight"])):
        for r, v in zip(reps, script["inflight"][i]):
            r._inflight = v
        if i == 60:
            reps[1].generation += 1          # supervisor replaced r1
        if i == 90:
            reps[2].state = "backoff"        # r2 leaves the routing set
        if i == 120:
            reps[2].state = "ready"
        cls = script["cls"][i]
        headers = {} if cls is None else {"X-Priority": cls}
        code, hdrs, body = rt.route_predict("m", b"{}", headers)
        h = dict(hdrs)
        out.append((code, h.get("X-Served-By"), h.get("Retry-After"),
                    json.loads(body).get("error"),
                    tuple(rt.breaker(r, "m").state for r in reps)))
        clock.advance(script["dt"][i])
    mon = P.monitor.dump()
    counters = {
        fam: sorted((tuple(sorted(s["labels"].items())), s["value"])
                    for s in mon[fam]["series"])
        for fam in ("serving_router_shed_total",
                    "serving_router_retries_total",
                    "serving_router_no_backend_total",
                    "serving_router_requests_total",
                    "serving_router_breaker_transitions_total",
                    "serving_router_canary_requests_total",
                    "serving_router_replica_errors_total") if fam in mon}
    return out, calls, counters


def test_router_decisions_equal_the_references():
    script = _router_script()
    mine = _router_trace(PORT, script)
    ref = _router_trace(REF, script)
    codes = {c for c, *_ in mine[0]}
    assert {200, 429, 503, 504} <= codes
    assert any(2 in b for *_, b in mine[0])        # a breaker half-opened
    assert "serving_router_canary_requests_total" in mine[2]
    assert mine == ref


def _hedge_affinity_trace(P):
    """The hedge (a straggling primary released after the hedge won),
    a hedge past a denied spare, prefix affinity and the disaggregated
    prefill, each under one seed."""
    out = []
    reps = []
    for i in range(3):
        r = P.fleet.Replica(f"r{i}")
        r.state, r.url = "ready", f"http://fake-{i}"
        reps.append(r)
    reps[1].inflight_add(1)
    reps[2].inflight_add(2)
    clock = FakeClock()
    release = threading.Event()
    calls = []

    def transport(replica, path, body, headers, timeout):
        calls.append((replica.name, path))
        if replica.name == "r0" and path.endswith("/predict"):
            release.wait(10)
        if path.endswith("/kv/export"):
            return 200, {}, b"BLOB"
        return 200, {"Content-Type": "application/json"}, \
            json.dumps({"who": replica.name}).encode()

    rt = P.router.ResilientRouter(
        lambda: reps, transport=transport, hedge=True, hedge_min_s=0.02,
        hedge_min_samples=1, time_fn=clock, breaker_open_for_s=5.0,
        rng=random.Random(1))
    rt._note_latency("m", 0.01)
    br1 = rt.breaker(reps[1], "m")
    for _ in range(5):
        br1.record_failure()
    clock.advance(6.0)
    assert br1.allow()                       # r1's half-open slot taken
    try:
        code, hdrs, _ = rt.route_predict("m", b"{}", {})
        out.append((code, dict(hdrs)["X-Served-By"], list(calls)))
    finally:
        release.set()
    prompt = list(range(8))
    d16 = P.router.kvfabric.leading_digest(prompt, 4).hex()[:16]
    reps[2].kv_ownership = {"m": {"block": 4, "digests": [d16]}}
    for _ in range(6):
        got = rt._affinity_pick("m", prompt, reps)
        out.append(None if got is None else got.name)
        reps[2].inflight_add(1)
    reps[0].kv_role = "prefill"
    out.append(rt._disagg_prefill("m", prompt, [reps[0]], reps[1]))
    mon = P.monitor.dump()
    out.append(sorted((tuple(sorted(s["labels"].items())), s["value"])
                      for fam in ("serving_router_hedges_total",
                                  "serving_router_affinity_requests_total",
                                  "serving_transfer_orchestrations_total")
                      for s in mon[fam]["series"]))
    out.append(calls)
    return out


def test_hedge_affinity_and_disagg_decisions_equal_the_references():
    mine = _hedge_affinity_trace(PORT)
    ref = _hedge_affinity_trace(REF)
    assert mine[0][:2] == (200, "r2")        # hedged past the denied r1
    assert mine == ref


# ------------------------------------------------------ replica argv
def _argv_pairs():
    yield {}, {}
    yield {"lms": [("g", "zoo:TransformerLM?n_layers=1")],
           "decode": dict(slots=2, page_size=8, max_context=64,
                          pool_pages=20, prefill_buckets=(8, 32),
                          prefill_chunk_tokens=16, prefix_cache=False,
                          spill_pages=12, spec_draft="int8", spec_k=3,
                          spec_accept_floor=0.5, spec_window=4,
                          spec_draft_pool_pages=10),
           "kv_role": "prefill", "enable_faults": True,
           "trace_out": "/t/fleet.json", "postmortem_dir": "/t/pm",
           "flight": False, "slo_availability": 0.99, "slo_p99_ms": 250.0,
           "slo_sample_interval_s": 0.5, "slo_windows": "4,1,8,2"}, {}
    yield {"flight_records": 64, "slo_p99_ms": 100.0,
           "buckets": (1, 4), "max_delay_ms": 2.0, "queue_limit": 32,
           "default_deadline_s": 9.0, "host": "0.0.0.0"}, {"device": "cpu"}
    yield {"lms": [("g", "/m/lm.zip")], "decode": dict(slots=4)}, \
        {"device": "cuda:1"}


@pytest.mark.parametrize("case", range(4))
def test_subprocess_argv_is_the_references_plus_device(case):
    kw, port_only = list(_argv_pairs())[case]

    def spec(pkg_fleet, decode_cls, extra):
        k = dict(kw)
        if "decode" in k:
            k["decode"] = decode_cls(**k["decode"])
        return pkg_fleet.ReplicaSpec([("m", "/ckpt/m.zip")], **k, **extra)

    ref = jfleet.SubprocessReplica(
        "replica-3", spec(jfleet, JDecodeConfig, {}))._argv()
    mine = fleet.SubprocessReplica(
        "replica-3", spec(fleet, DecodeConfig, port_only))._argv()
    want = list(ref)
    want[want.index("deeplearning4j_tpu.serving")] = \
        "deeplearning4j_tpu_torch.serving"
    want += ["--device", port_only.get("device", "cuda")]
    assert mine == want
    assert mine[0] == sys.executable


def test_replica_spec_device_reaches_the_in_process_registry():
    spec = fleet.ReplicaSpec([("m", "zoo:TransformerLM?n_layers=1"
                                    "&n_embd=32&n_heads=4&seq_length=16"
                                    "&vocab_size=32")],
                             buckets=(1,), device="cpu")
    rep = fleet.InProcessReplica("replica-0", spec)
    rep.launch()
    try:
        served = rep._registry.get("m")
        assert str(served.model.device) == "cpu"
        # each in-process replica owns its fault toggles: wedging one
        # must not wedge a sibling through the process singleton
        assert rep._server.faults is not serving_faults()
    finally:
        rep.kill()
    assert fleet.ReplicaSpec([("m", "x")]).device == "cuda"
