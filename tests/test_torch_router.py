"""Mixed fleets over HTTP: each package's router in front of the other's
replicas.

- The port's `RouterServer` routes over one port `InProcessReplica` and
  one reference `InProcessReplica` serving the same zip (written by the
  JAX package): a 6-16-3 MLP, and a one-layer flash `TransformerLM` (the
  port's plain attention route on the CPU). Every answer through the
  router is bitwise the answer of the replica that served it (named by
  ``X-Served-By``), asked directly, and within 1e-5 of the other
  package's replica.
- The reference's `RouterServer` over two port replicas completes a
  fleet swap and a fleet rollback (each port server's active version
  follows; the shared spec is rewritten) and pushes rollout roles
  through the port's ``POST /v1/rollout/role``.
- The `serving_router_*`, `serving_fleet_*` and `serving_autoscale_*`
  families (type, help, label names) equal the reference's after the
  same decision scripts.
"""
import io
import json
import random
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import fleet, router

ATOL = 1e-5             # the reference's XLA against torch, f32 on the CPU


def _reset_all():
    for mon in (monitor, jmonitor):
        mon.REGISTRY.reset()
        mon.flight.disable_flight()
        mon.flight.clear()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def _ref_mlp(seed):
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list().layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf).init()


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    from deeplearning4j_tpu.models.zoo import model_by_name
    from deeplearning4j_tpu.util.serialization import save_model
    d = tmp_path_factory.mktemp("mixed")
    out = {"mlp": str(d / "mlp.zip"), "mlp2": str(d / "mlp2.zip"),
           "lm": str(d / "lm.zip")}
    save_model(_ref_mlp(0), out["mlp"])
    save_model(_ref_mlp(7), out["mlp2"])
    save_model(model_by_name("TransformerLM", vocab_size=32, seq_length=16,
                             n_layers=1, n_embd=32, n_heads=4,
                             attention_impl="flash").init(), out["lm"])
    return out


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    b = 1 + seed % 2
    if kind == "lm":
        return rs.randint(0, 32, (b, 16, 1)).astype("float32")
    return rs.randn(b, 6).astype("float32")


def _predict(url, x, headers=None):
    buf = io.BytesIO()
    np.save(buf, x)
    r = urllib.request.urlopen(urllib.request.Request(
        url + "/v1/models/m/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream", **(headers or {})}),
        timeout=60)
    return r.headers.get("X-Served-By"), np.load(io.BytesIO(r.read()))


@pytest.mark.parametrize("kind", ["mlp", "lm"])
def test_port_router_over_a_mixed_fleet(zips, kind):
    mine = fleet.InProcessReplica("port-0", fleet.ReplicaSpec(
        [("m", zips[kind])], buckets=(1, 2), device="cpu"))
    ref = jfleet.InProcessReplica("ref-0", jfleet.ReplicaSpec(
        [("m", zips[kind])], buckets=(1, 2)))
    for r in (mine, ref):
        r.launch()
        r.state = "ready"
    reps = {r.name: r for r in (mine, ref)}
    rt = router.ResilientRouter(lambda: [mine, ref], hedge=False,
                                rng=random.Random(3))
    server = router.RouterServer(rt)
    served = set()
    try:
        for seed in range(10):
            x = _inputs(kind, seed)
            who, y = _predict(server.url, x)
            served.add(who)
            _, direct = _predict(reps[who].url, x)
            assert np.array_equal(y, direct)            # bitwise
            other = ref if who == mine.name else mine
            _, y_other = _predict(other.url, x)
            np.testing.assert_allclose(y, y_other, atol=ATOL, rtol=0)
        assert served == {"port-0", "ref-0"}
        doc = json.loads(urllib.request.urlopen(server.url + "/readyz",
                                                timeout=10).read())
        assert doc == {"status": "ready", "replicas": ["port-0", "ref-0"]}
    finally:
        server.stop()
        for r in (mine, ref):
            r.kill()


def test_reference_router_swaps_and_rolls_back_port_replicas(zips):
    spec = fleet.ReplicaSpec([("m", zips["mlp"])], buckets=(1, 2),
                             device="cpu")
    port_reps = [fleet.InProcessReplica(f"replica-{i}", spec)
                 for i in range(2)]
    for r in port_reps:
        r.launch()
    # the reference's handles on the port servers (the supervisor's view)
    jspec = jfleet.ReplicaSpec([("m", zips["mlp"])])
    handles = []
    for r in port_reps:
        h = jfleet.SubprocessReplica(r.name, jspec)
        h.url, h.state = r.url, "ready"
        handles.append(h)

    class Sup:
        replicas = handles

        def healthy(self):
            return [h for h in self.replicas if h.state == "ready"]

    jr = jrouter.ResilientRouter(Sup().healthy, hedge=False,
                                 rng=random.Random(0))
    server = jrouter.RouterServer(jr, supervisor=Sup())
    x = _inputs("mlp", 1)

    def admin(verb, body):
        r = urllib.request.urlopen(urllib.request.Request(
            f"{server.url}/v1/models/m/{verb}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=60)
        return r.status, json.loads(r.read())

    def actives():
        out = []
        for r in port_reps:
            doc = json.loads(urllib.request.urlopen(
                r.url + "/v1/models/m", timeout=10).read())
            out.append([v["source"] for v in doc["versions"]
                        if v["version"] == doc["active_version"]][0])
        return out

    try:
        _, before = _predict(server.url, x)
        code, doc = admin("swap", {"source": zips["mlp2"]})
        assert code == 200 and doc["ok"] and doc["skipped_unhealthy"] == []
        assert sorted(doc["replicas"]) == ["replica-0", "replica-1"]
        assert actives() == [zips["mlp2"]] * 2
        assert jspec.models == [("m", zips["mlp2"])]
        _, after = _predict(server.url, x)
        _, direct = _predict(port_reps[0].url, x)
        assert np.array_equal(after, direct)
        assert not np.allclose(after, before)
        code, doc = admin("rollback", {})
        assert code == 200 and doc["ok"]
        assert actives() == [zips["mlp"]] * 2
        # the fleet rollback rewrote the spec from the port's answers
        assert jspec.models == [("m", zips["mlp"])]
        _, again = _predict(server.url, x)
        assert np.array_equal(again, before)
        # the reference's rollout role push lands on the port's surface
        handles[1].set_role("canary", 4)
        doc = json.loads(urllib.request.urlopen(
            port_reps[1].url + "/readyz", timeout=10).read())
        assert (doc["role"], doc["rollout_generation"]) == ("canary", 4)
        doc = json.loads(urllib.request.urlopen(
            port_reps[0].url + "/readyz", timeout=10).read())
        assert (doc["role"], doc["rollout_generation"]) == ("stable", 0)
        # and the reference's probe reads the port's /readyz heartbeat
        assert jfleet.http_probe(handles[1], 5.0)
        assert handles[1].kv_role == "mixed"
    finally:
        server.stop()
        for r in port_reps:
            r.kill()


def _families(mon, prefixes=("serving_router_", "serving_fleet_",
                             "serving_autoscale_", "serving_transfer_")):
    out = {}
    for name, fam in mon.dump().items():
        if name.startswith(prefixes):
            out[name] = (fam["type"], fam["help"],
                         tuple(sorted({tuple(sorted(s["labels"]))
                                       for s in fam["series"]})))
    return out


def test_router_and_fleet_metric_families_equal_the_references():
    import test_torch_fleet as tf
    script_s, script_r = tf._supervisor_script(), tf._router_script()
    for P in (tf.PORT, tf.REF):
        tf._supervisor_trace(P, script_s)
        tf._router_trace(P, script_r)
        tf._hedge_affinity_trace(P)
    mine, ref = _families(monitor), _families(jmonitor)
    assert {"serving_router_requests_total", "serving_router_shed_total",
            "serving_router_hedges_total", "serving_fleet_replicas",
            "serving_fleet_probe_seconds", "serving_fleet_restarts_total",
            "serving_autoscale_events_total"} <= set(mine)
    assert sorted(mine) == sorted(ref)
    assert mine == ref
