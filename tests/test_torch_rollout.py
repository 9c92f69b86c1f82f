"""The port's rollout controller (`serving/rollout.py`), the autoscaler
and the servers' rollout surface held to the JAX package's.

- Every non-slow case of the reference's tests/test_rollout.py runs
  against the port (`_torch_reference_cases.port_cases`); its two cases
  that build a network or a registry ask for the CPU, as every port
  entry point must be asked.
- Decision-trace parity: both packages' `RolloutController` run one
  script of blessings (promote; error-ratio, latency, probe-accuracy,
  crashed-canary, failed-promote and too-little-traffic rejections)
  under the same fake clock and scripted wire; states, canaries,
  verdicts, history, role pushes and swaps must be identical.
- The reference's `RolloutController` drives port replicas over HTTP:
  canary then promote, each port server's /readyz carrying the role and
  rollout generation the reference pushed through /v1/rollout/role.
"""
import hashlib
import json
import random
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import _torch_reference_cases as refcases
from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving import rollout as jrollout
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import fleet, rollout, router

PORT = types.SimpleNamespace(fleet=fleet, router=router, rollout=rollout)
REF = types.SimpleNamespace(fleet=jfleet, router=jrouter, rollout=jrollout)


def _reset_all():
    for mon in (monitor, jmonitor):
        mon.REGISTRY.reset()
        mon.disable_tracing()
        mon.clear_trace()
        mon.flight.disable_flight()
        mon.flight.clear()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


# ------------------------------------------------ the reference's cases
refcases.port_cases("tests/test_fleet.py",
                    module_name="torch_port_of_test_fleet")
ROLLOUT_CASES = refcases.port_cases(
    "tests/test_rollout.py",
    extra_subs=(("from tests.test_fleet import",
                 "from torch_port_of_test_fleet import"),
                ("ModelRegistry()", 'ModelRegistry(device="cpu")'),
                ("MultiLayerNetwork(conf).init()",
                 'MultiLayerNetwork(conf, device="cpu").init()')))


def test_the_reference_rollout_cases_are_all_here():
    assert len(refcases.case_names(ROLLOUT_CASES)) == 18


@pytest.mark.parametrize("name", refcases.case_names(ROLLOUT_CASES))
def test_reference_rollout_case(name, request):
    refcases.run_case(ROLLOUT_CASES, name, request)


# ------------------------------------------------- decision-trace parity
class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


#: (tick at which the blessing lands, content tag, wire behaviour)
BLESSINGS = ((0, "v2", "healthy"), (30, "v3", "error_ratio"),
             (60, "v4", "poison"), (90, "v5", "crash"),
             (120, "v6", "promote_fail"), (150, "v7", "latency"),
             (180, "v8", "quiet"), (260, "v9", "healthy"))


def _rollout_trace(P, tmp_path):
    clock = FakeClock()
    spec = P.fleet.ReplicaSpec([("m", "/old/src")])
    reps = []

    class FakeReplica(P.fleet.Replica):
        def __init__(self, name):
            super().__init__(name, spec)
            self.kills = 0
            self.url = f"http://fake/{name}"

        def kill(self):
            self.kills += 1

    for i in range(4):
        r = FakeReplica(f"r{i}")
        r.state = "ready"
        reps.append(r)

    class Sup:
        replicas = reps

        def healthy(self):
            return [r for r in self.replicas if r.state == "ready"]

    log = []
    active = {r.name: "/old/src" for r in reps}
    prev = {r.name: [] for r in reps}
    mode = {"now": "healthy"}

    def wire(replica, path, body, headers, timeout):
        def _json(doc, code=200):
            return code, {"Content-Type": "application/json"}, \
                json.dumps(doc).encode()
        log.append((replica.name, path.split("?")[0]))
        canary = replica.role == "canary"
        if path.endswith("/swap"):
            src = json.loads(body)["source"]
            if mode["now"] == "promote_fail" and not canary \
                    and replica.name == "r3":
                return _json({"error": "load failed"}, code=500)
            prev[replica.name].append(active[replica.name])
            active[replica.name] = src
            return _json({"active": {"source": src}})
        if path.endswith("/rollback"):
            active[replica.name] = prev[replica.name].pop()
            return _json({"active": {"source": active[replica.name]}})
        if path.endswith("/predict"):
            x = np.asarray(json.loads(body)["inputs"][0])
            want = int(x.sum() > 0)
            if "v4" in active[replica.name]:
                want = 1 - want                  # the poisoned model
            row = [0.0, 0.0]
            row[want] = 1.0
            return _json({"outputs": [row]})
        if path == "/v1/slo":
            bad = canary and mode["now"] == "error_ratio"
            return _json({"enabled": True, "state": "ok", "objectives": [
                {"kind": "availability", "ratio": 0.7 if bad else 1.0}]})
        if path.startswith("/v1/timeseries"):
            n = 0 if canary and mode["now"] == "quiet" else 50
            p99 = 0.3 if canary and mode["now"] == "latency" else 0.02
            return _json({"enabled": True, "count": n, "p99": p99})
        if path == "/v1/debug/flight":
            return _json({"records": [
                {"trace_id": "t-slow", "duration_ms": 99.0},
                {"trace_id": "t-fast", "duration_ms": 2.0}]})
        return _json({"error": "not found"}, code=404)

    probes = [(np.full(3, s, "float32"), int(s > 0))
              for s in (-1.0, 1.0, 2.0, -2.0)]
    rc = P.rollout.RolloutController(
        Sup(), None, str(tmp_path), "m", transport=wire, time_fn=clock,
        wall_fn=clock, sleep_fn=lambda s: None, poll_interval_s=1.0,
        observe_s=5.0, observe_extend=2.0, min_canary_requests=10,
        probe_set=probes, probe_min_accuracy=0.75, promote_stagger_s=0.5,
        max_p99_ratio=1.5, p99_floor_ms=10.0)
    trace = []
    for tick in range(300):
        for at, tag, behaviour in BLESSINGS:
            if tick == at:
                content = f"weights-{tag}".encode()
                path = tmp_path / f"ckpt_{tag}.zip"
                path.write_bytes(content)
                (tmp_path / "blessed.json").write_text(json.dumps({
                    "file": path.name, "path": str(path),
                    "sha256": hashlib.sha256(content).hexdigest(),
                    "metrics": {"accuracy": 0.9}, "iteration": at}))
                mode["now"] = behaviour
        if mode["now"] == "crash" and rc.canary is not None:
            name = rc.canary["replica"]
            next(r for r in reps if r.name == name).generation += 1
        rc.tick()
        trace.append((rc.state, rc.rollout_generation,
                      None if rc.canary is None else dict(rc.canary),
                      rc.last_verdict, rc.current_source,
                      [(r.name, r.role, r.rollout_generation, r.kills)
                       for r in reps], list(spec.models)))
        clock.advance(0.5)
    doc = json.dumps({"trace": trace, "log": log,
                      "history": rc.history})
    return json.loads(doc.replace(str(tmp_path), "<dir>"))


def test_rollout_decisions_equal_the_references(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    mine = _rollout_trace(PORT, tmp_path / "port")
    ref = _rollout_trace(REF, tmp_path / "ref")
    outcomes = [(d["decision"], d.get("metric")) for d in mine["history"]]
    assert outcomes == [
        ("promoted", None), ("rejected", "error_ratio"),
        ("rejected", "probe_accuracy"), ("rejected", "canary_crashed"),
        ("rejected", "promote_swap_failed"), ("rejected", "latency_p99"),
        ("rejected", "insufficient_traffic"), ("promoted", None)]
    assert mine == ref


# ------------------------------ the reference's controller, port replicas
def test_canary_window_opens_when_its_swap_returns(tmp_path):
    """The port's one departure from the reference's controller: the
    canary's observation window opens when its swap returns (the replica
    has loaded and warmed the candidate), not when the controller called
    it. A swap that holds the clock 3 s moves the window by 3 s: no
    verdict 5 s after the call, the verdict once 5 s have passed since
    the swap returned, over a window of that length."""
    clock = FakeClock()
    spec = fleet.ReplicaSpec([("m", "/old/src")])
    reps = []
    for i in range(3):
        r = fleet.Replica(f"r{i}", spec)
        r.url, r.state = f"http://fake/r{i}", "ready"
        reps.append(r)

    class Sup:
        replicas = reps

        def healthy(self):
            return list(self.replicas)

    windows = []

    def wire(replica, path, body, headers, timeout):
        def _json(doc):
            return 200, {"Content-Type": "application/json"}, \
                json.dumps(doc).encode()
        if path.endswith("/swap"):
            clock.advance(3.0)
            return _json({"active": {"source": json.loads(body)["source"]}})
        if path == "/v1/slo":
            return _json({"enabled": True, "state": "ok", "objectives": [
                {"kind": "availability", "ratio": 1.0}]})
        if path.startswith("/v1/timeseries"):
            if replica.role == "canary":
                windows.append(float(path.split("window=")[1]
                                     .split("&")[0]))
            return _json({"enabled": True, "count": 50, "p99": 0.02})
        return _json({})

    rc = rollout.RolloutController(
        Sup(), None, str(tmp_path), "m", transport=wire, time_fn=clock,
        wall_fn=clock, sleep_fn=lambda s: None, poll_interval_s=1.0,
        observe_s=5.0, min_canary_requests=10, promote_stagger_s=0.0)
    path = tmp_path / "ckpt_v2.zip"
    path.write_bytes(b"weights-v2")
    (tmp_path / "blessed.json").write_text(json.dumps({
        "file": path.name, "path": str(path),
        "sha256": hashlib.sha256(b"weights-v2").hexdigest(),
        "metrics": {"accuracy": 0.9}, "iteration": 1}))
    called = clock()
    rc.tick()
    assert rc.state == "canary"
    assert rc.canary["started"] == called + 3.0
    assert rc.canary["observe_until"] == called + 8.0
    clock.t = called + 5.5          # the reference's window would be over
    rc.tick()
    assert rc.state == "canary" and windows == []
    clock.t = called + 8.0
    rc.tick()
    assert windows == [5.0]
    assert rc.last_verdict["decision"] == "promoted"
    assert rc.last_verdict["observe_s"] == 5.0


def _mlp_zip(path, seed):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.util.serialization import save_model
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list().layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    save_model(MultiLayerNetwork(conf, device="cpu").init(), str(path))
    return str(path)


def _readyz(url):
    return json.loads(urllib.request.urlopen(url + "/readyz",
                                             timeout=10).read())


def test_reference_controller_rolls_out_over_port_replicas(tmp_path):
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    v1 = _mlp_zip(tmp_path / "v1.zip", seed=1)
    ckpt = tmp_path / "ckpts"
    spec = fleet.ReplicaSpec([("m", v1)], buckets=(1, 4), device="cpu")
    port_reps = [fleet.InProcessReplica(f"replica-{i}", spec)
                 for i in range(2)]
    for r in port_reps:
        r.launch()
    try:
        # the reference's handles on the port's servers: set_role pushes
        # over HTTP (POST /v1/rollout/role), as to a subprocess replica
        jspec = jfleet.ReplicaSpec([("m", v1)])
        handles = []
        for r in port_reps:
            h = jfleet.SubprocessReplica(r.name, jspec)
            h.url, h.state = r.url, "ready"
            handles.append(h)

        class Sup:
            replicas = handles

            def healthy(self):
                return [h for h in self.replicas if h.state == "ready"]

        clock = FakeClock()
        jr = jrouter.ResilientRouter(Sup().healthy, hedge=False,
                                     rng=random.Random(0))
        rc = jrollout.RolloutController(
            Sup(), jr, str(ckpt), "m", time_fn=clock, wall_fn=clock,
            sleep_fn=lambda s: None, poll_interval_s=1.0, observe_s=5.0,
            min_canary_requests=0, promote_stagger_s=0.0)
        assert [_readyz(r.url)["role"] for r in port_reps] \
            == ["stable", "stable"]
        mgr = CheckpointManager(str(ckpt))
        from deeplearning4j_tpu_torch.util.serialization import load_model
        v2_path = mgr.save(load_model(_mlp_zip(tmp_path / "v2.zip", 2),
                                      device="cpu"), {})
        mgr.bless(v2_path, {"accuracy": 0.9})
        rc.tick()
        assert rc.state == "canary"
        name = rc.canary["replica"]
        canary = next(r for r in port_reps if r.name == name)
        other = next(r for r in port_reps if r.name != name)
        doc = _readyz(canary.url)
        assert (doc["role"], doc["rollout_generation"]) == ("canary", 1)
        assert list(doc)[:4] == ["status", "models", "role",
                                 "rollout_generation"]
        assert _readyz(other.url)["role"] == "stable"
        clock.advance(5.1)
        rc.tick()
        assert rc.last_verdict["decision"] == "promoted", rc.last_verdict
        for r in port_reps:
            doc = _readyz(r.url)
            assert (doc["role"], doc["rollout_generation"]) \
                == ("stable", 1)
            served = json.loads(urllib.request.urlopen(
                r.url + "/v1/models/m", timeout=10).read())
            active = [v for v in served["versions"]
                      if v["version"] == served["active_version"]]
            assert active[0]["source"] == v2_path
        bad = urllib.request.Request(
            port_reps[0].url + "/v1/rollout/role",
            data=json.dumps({"role": "purple"}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(bad, timeout=10)
        assert exc.value.code == 400
    finally:
        for r in port_reps:
            r.kill()
