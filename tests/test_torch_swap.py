"""The port's version lifecycle: predict and LM swap and rollback, the
checkpoint-manifest sources and ParallelInference.

These are the JAX package's assertions (tests/test_serving.py's registry
swap and rollback, the swap-under-traffic round trip and the drain races;
tests/test_decode.py's rolling LM swap, the shorter-context swap and the
vocabulary rejection; tests/test_parallel.py's ParallelInference) held
against the port. Manifest directories move both ways: one written by the
JAX package's CheckpointManager is served by the port, one written by the
port's is served by the reference, and in both a corrupted newest entry
falls back to the one before. Predict outputs compare at atol 1e-6 (f32,
the same weights on the same CPU, 1e-5 for the reference's XLA
against torch).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import InferenceMode, ParallelInference
from deeplearning4j_tpu_torch.serving.batcher import ServerDrainingError
from deeplearning4j_tpu_torch.serving.decode import DecodeConfig, ServedLM
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ModelRegistry, load_servable,
)
from deeplearning4j_tpu_torch.serving.server import ModelServer
from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
from deeplearning4j_tpu_torch.util.serialization import save_model

N_IN, N_OUT = 6, 3
ZOO_SRC = ("zoo:TransformerLM?vocab_size=48&n_layers=1&n_embd=32"
           "&n_heads=4&seq_length=32")


def _net(seed=0, n_in=N_IN):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _out(net, x):
    return net.output(x).float().numpy()


def _post(url, body: bytes, timeout=30, ctype="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    r = urllib.request.urlopen(req, timeout=timeout)
    return r.status, json.loads(r.read())


@pytest.fixture
def registry():
    reg = ModelRegistry(device="cpu")
    yield reg
    reg.shutdown(drain=False)


def _deploy(registry, name="m", seed=0, **kw):
    kw.setdefault("buckets", (1, 4, 16))
    kw.setdefault("max_delay_ms", 2.0)
    return registry.deploy(name, _net(seed), **kw)


# ------------------------------------------------------- predict swaps
def test_registry_swap_and_rollback(registry):
    served = _deploy(registry, seed=0)
    x = np.random.RandomState(0).randn(3, N_IN).astype("float32")
    y1 = served.predict(x)
    info = served.swap(_net(1))
    assert info["version"] == 2
    y2 = served.predict(x)
    assert not np.allclose(y1, y2, atol=1e-6)
    np.testing.assert_allclose(y2, _out(served.model, x), atol=1e-6)
    info = served.rollback()
    assert info["version"] == 1
    np.testing.assert_allclose(served.predict(x), y1, atol=1e-6)
    with pytest.raises(ModelLoadError):
        served.rollback()


def test_swap_rejects_incompatible_input_shape(registry):
    served = _deploy(registry)
    with pytest.raises(ModelLoadError, match="swap rejected"):
        served.swap(_net(0, n_in=N_IN + 1))
    assert served.versions[served.active].version == 1
    served.predict(np.zeros((2, N_IN), "float32"))


def test_redeploy_of_a_name_is_a_version_swap(registry):
    served = _deploy(registry, seed=0)
    assert registry.deploy("m", _net(2), buckets=(1, 4, 16)) is served
    assert served.describe()["active_version"] == 2
    lm = registry.deploy_lm("g", ZOO_SRC, decode=DecodeConfig(
        slots=1, page_size=8, prefill_buckets=(8, 32)))
    with pytest.raises(ModelLoadError, match="DECODE"):
        registry.deploy("g", _net(0))
    assert registry.deploy_lm("g", ZOO_SRC + "&seed=5") is lm
    assert lm.describe()["active_version"] == 2


def test_drain_racing_swap_raises_draining_not_500(registry):
    served = _deploy(registry, name="ds")
    served.shutdown(drain=False)
    with pytest.raises(ServerDrainingError):
        served.swap(_net(3))
    with pytest.raises(ServerDrainingError):
        served.rollback()


def test_health_ready_swap_under_traffic_round_trip(registry, tmp_path):
    """healthz -> readyz -> predict under concurrent load -> hot-swap over
    HTTP -> rollback mid-traffic, zero failures, both versions seen."""
    _deploy(registry, name="rt", seed=0)
    srv = ModelServer(registry, port=0)
    try:
        url = srv.url
        assert urllib.request.urlopen(f"{url}/healthz",
                                      timeout=10).status == 200
        ready = json.loads(urllib.request.urlopen(f"{url}/readyz",
                                                  timeout=10).read())
        assert ready["kv_role"] == "mixed"
        predict = f"{url}/v1/models/rt/predict"
        rs = np.random.RandomState(0)
        bodies = [json.dumps({"inputs": rs.rand(b, N_IN).tolist()}).encode()
                  for b in (1, 2, 4)]
        results = {"ok": 0, "fail": []}
        lock = threading.Lock()
        versions = set()
        swap_live = threading.Event()
        seen_v2 = threading.Event()

        def worker(k):
            for i in range(20):
                if i == 10:
                    swap_live.wait(timeout=60)
                try:
                    _, out = _post(predict, bodies[(k + i) % 3])
                    with lock:
                        results["ok"] += 1
                        versions.add(out["version"])
                    if out["version"] == 2:
                        seen_v2.set()
                except Exception as e:  # noqa: BLE001
                    with lock:
                        results["fail"].append(repr(e))

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        path = str(tmp_path / "v2.zip")
        save_model(_net(7), path)
        code, info = _post(f"{url}/v1/models/rt/swap",
                           json.dumps({"source": path}).encode())
        assert code == 200 and info["active"]["version"] == 2
        swap_live.set()
        assert seen_v2.wait(timeout=60)
        code, info = _post(f"{url}/v1/models/rt/rollback", b"")
        assert code == 200 and info["active"]["version"] == 1
        for t in threads:
            t.join(timeout=60)
        assert not results["fail"], results["fail"][:3]
        assert results["ok"] == 80 and versions == {1, 2}
        for body, want in ((b"{}", 400),
                           (json.dumps({"source": str(tmp_path / "no.zip")})
                            .encode(), 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{url}/v1/models/rt/swap", body)
            assert e.value.code == want
            e.value.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/v1/models/nope/swap", b'{"source": "x"}')
        assert e.value.code == 404
        e.value.read()
    finally:
        srv.stop()


def test_drain_race_inflight_predict_and_swap_never_5xx_or_hang(registry):
    """Concurrent drain + in-flight predicts + a hot swap give only
    {200, 429, 503, 504}; every socket completes; the swap that loses the
    race answers 503 (or landed first: 200)."""
    _deploy(registry, name="race", seed=0)
    srv = ModelServer(registry, port=0, default_deadline_s=5.0)
    url = f"{srv.url}/v1/models/race/predict"
    rs = np.random.RandomState(0)
    bodies = [json.dumps({"inputs": rs.rand(b, N_IN).tolist()}).encode()
              for b in (1, 2, 4)]
    outcomes, violations = [], []
    lock = threading.Lock()
    start = threading.Barrier(8 + 2, timeout=10)
    drain_started = [None]

    def predictor(k):
        start.wait()
        for i in range(15):
            try:
                code, _ = _post(url, bodies[(k + i) % 3], timeout=15)
                kind = code
            except urllib.error.HTTPError as e:
                e.read()
                kind = e.code
            except Exception as e:  # noqa: BLE001
                ds = drain_started[0]
                if ds is not None and time.monotonic() >= ds:
                    kind = f"conn_after_drain:{type(e).__name__}"
                else:
                    kind = f"violation:{type(e).__name__}"
            with lock:
                outcomes.append(kind)
                if isinstance(kind, str) and kind.startswith("violation"):
                    violations.append(kind)

    served = registry.get("race")
    swap_result = []

    def swapper():
        start.wait()
        time.sleep(0.02)
        try:
            served.swap(_net(5))
            swap_result.append("ok")
        except ServerDrainingError:
            swap_result.append("draining")
        except Exception as e:  # noqa: BLE001
            swap_result.append(f"violation:{type(e).__name__}")

    def drainer():
        start.wait()
        time.sleep(0.05)
        drain_started[0] = time.monotonic()
        srv.drain(timeout=10)

    threads = [threading.Thread(target=predictor, args=(k,))
               for k in range(8)]
    threads += [threading.Thread(target=swapper),
                threading.Thread(target=drainer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not [t for t in threads if t.is_alive()]
    assert not violations, violations
    codes = {o for o in outcomes if isinstance(o, int)}
    assert codes <= {200, 429, 503, 504}, codes
    assert 200 in codes
    assert swap_result and swap_result[0] in ("ok", "draining")


def test_http_swap_racing_a_drain_answers_503(registry):
    _deploy(registry, name="d503")
    srv = ModelServer(registry, port=0)
    try:
        registry.get("d503").status = "stopping"
        for verb, body in (("swap", b'{"source": "zoo:LeNet"}'),
                           ("rollback", b"")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{srv.url}/v1/models/d503/{verb}", body)
            assert e.value.code == 503
            assert 1 <= int(e.value.headers["Retry-After"]) <= 5
            e.value.read()
    finally:
        srv.stop()


# -------------------------------------------------- manifest directories
def _jax_net(seed):
    from deeplearning4j_tpu.nn.conf.base import InputType as JIT
    from deeplearning4j_tpu.nn.conf.network import (
        NeuralNetConfiguration as JNNC,
    )
    from deeplearning4j_tpu.nn.layers import (
        DenseLayer as JDense, OutputLayer as JOut,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updaters import Adam as JAdam
    conf = (JNNC.Builder().seed(seed).updater(JAdam(1e-2)).list()
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JOut(n_out=N_OUT, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(N_IN)).build())
    return JMLN(conf).init()


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(20)
        f.write(b"\xde\xad\xbe\xef")


def test_manifest_written_by_the_reference_is_served_by_the_port(tmp_path):
    from deeplearning4j_tpu.train.resilience import (
        CheckpointManager as JaxCheckpointManager,
    )
    ckdir = str(tmp_path / "jax-ckpts")
    mgr = JaxCheckpointManager(ckdir, keep_last=3)
    net_a, net_b = _jax_net(1), _jax_net(2)
    mgr.save(net_a, {"step_in_epoch": 0})
    path_b = mgr.save(net_b, {"step_in_epoch": 3})
    x = np.random.RandomState(0).randn(2, N_IN).astype("float32")
    loaded = load_servable(ckdir, device="cpu")
    np.testing.assert_allclose(_out(loaded, x), np.asarray(net_b.output(x)),
                               atol=1e-5)
    assert CheckpointManager(ckdir).latest_valid()["file"] \
        == "ckpt_000001.zip"
    _corrupt(path_b)
    loaded = load_servable(ckdir, device="cpu")
    np.testing.assert_allclose(_out(loaded, x), np.asarray(net_a.output(x)),
                               atol=1e-5)
    # the registry serves the directory, and swaps to it
    reg = ModelRegistry(device="cpu")
    try:
        served = reg.deploy("ck", ckdir, buckets=(1, 2))
        np.testing.assert_allclose(served.predict(x),
                                   np.asarray(net_a.output(x)), atol=1e-5)
    finally:
        reg.shutdown(drain=False)
    with pytest.raises(ModelLoadError):
        load_servable(str(tmp_path / "empty"), device="cpu")


def test_manifest_written_by_the_port_is_served_by_the_reference(tmp_path):
    from deeplearning4j_tpu.serving.registry import (
        load_servable as jax_load,
    )
    from deeplearning4j_tpu.train.resilience import (
        CheckpointManager as JaxCheckpointManager,
    )
    ckdir = str(tmp_path / "port-ckpts")
    mgr = CheckpointManager(ckdir, keep_last=2)
    nets = [_net(s) for s in (1, 2, 3)]
    paths = [mgr.save(n, {"step_in_epoch": i}) for i, n in enumerate(nets)]
    # keep_last=2 pruned the first file; the manifest tracks two
    assert [e["file"] for e in mgr._read_manifest()["checkpoints"]] == \
        ["ckpt_000001.zip", "ckpt_000002.zip"]
    x = np.random.RandomState(1).randn(2, N_IN).astype("float32")
    np.testing.assert_allclose(np.asarray(jax_load(ckdir).output(x)),
                               _out(nets[2], x), atol=1e-5)
    _corrupt(paths[2])
    np.testing.assert_allclose(np.asarray(jax_load(ckdir).output(x)),
                               _out(nets[1], x), atol=1e-5)
    assert JaxCheckpointManager(ckdir).latest_valid()["file"] \
        == "ckpt_000001.zip"
    # bless + restore_into round trip in the port
    mgr.bless(paths[1], {"acc": 0.5})
    fresh = _net(9)
    extra = mgr.restore_into(fresh, paths[1])
    assert extra == {"step_in_epoch": 1}
    np.testing.assert_allclose(_out(fresh, x), _out(nets[1], x), atol=0)


# ------------------------------------------------------------- LM swaps
def _drain(req, timeout=60.0):
    out = []
    deadline = time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(0.1, deadline - time.monotonic()))
        out.append(ev)
        if ev[0] in ("done", "error"):
            return out


def test_lm_swap_to_shorter_context_stays_safe():
    lm = ServedLM("shrink-lm", load_servable(ZOO_SRC, device="cpu"),
                  ZOO_SRC, decode=DecodeConfig(slots=2, page_size=8))
    try:
        assert lm.max_context == 32
        lm.swap(ZOO_SRC.replace("seq_length=32", "seq_length=16"))
        assert lm.max_context == 16
        with pytest.raises(ValueError):
            lm.generate(list(range(20)), max_new_tokens=2)
        evs = _drain(lm.generate([1, 2, 3], max_new_tokens=3))
        assert evs[-1][0] == "done" and evs[-1][1]["version"] == 2
        # rollback re-admits on the resident v1 engine: no new warm
        eng1 = lm._engines[1]
        lm.rollback()
        assert lm.scheduler.admitting_engine() is eng1
        assert lm.max_context == 32
        evs = _drain(lm.generate(list(range(20)), max_new_tokens=2))
        assert evs[-1][1]["version"] == 1
    finally:
        lm.shutdown(drain=False, timeout=5)


@pytest.fixture(scope="module")
def lm_server():
    registry = ModelRegistry(device="cpu")
    registry.deploy_lm("lm", ZOO_SRC, decode=DecodeConfig(
        slots=2, page_size=8, prefill_buckets=(8, 32)))
    server = ModelServer(registry, port=0)
    yield server, registry
    server.drain(timeout=10)


def _gen(url, payload, name="lm"):
    return urllib.request.urlopen(urllib.request.Request(
        f"{url}/v1/models/{name}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}), timeout=60)


def test_http_rolling_swap_mid_stream(lm_server):
    """A stream started on v1 finishes on v1 while the swap warms and
    flips admissions to v2; its tokens are v1's greedy tokens; the next
    stream answers v2 with v2's tokens; a rollback answers v1's again."""
    server, registry = lm_server
    lm = registry.get("lm")
    prompt = [2, 4]
    want_v1 = [e[1] for e in _drain(lm.generate(prompt, max_new_tokens=20))
               if e[0] == "token"]
    r1 = _gen(server.url, {"prompt": prompt, "max_tokens": 20})
    assert r1.headers.get("X-Model-Version") == "1"
    assert r1.readline().startswith(b"data: ")
    swap = _post(server.url + "/v1/models/lm/swap",
                 json.dumps({"source": ZOO_SRC + "&seed=99"}).encode(),
                 timeout=300)
    assert swap[0] == 200 and swap[1]["active"]["version"] == 2
    tail = [json.loads(line[6:]) for line in r1
            if line.startswith(b"data: ")]
    assert tail[-1].get("done") and tail[-1]["version"] == 1
    assert [e["token"] for e in tail if "token" in e] == want_v1[1:]
    doc = json.loads(_gen(server.url, {"prompt": prompt, "max_tokens": 20,
                                       "stream": False}).read())
    assert doc["version"] == 2 and doc["tokens"] != want_v1
    code, info = _post(server.url + "/v1/models/lm/rollback", b"")
    assert code == 200 and info["active"]["version"] == 1
    doc = json.loads(_gen(server.url, {"prompt": prompt, "max_tokens": 20,
                                       "stream": False}).read())
    assert doc["version"] == 1 and doc["tokens"] == want_v1
    assert all(e.request_path_first_runs == 0
               for e in lm._engines.values())


def test_vocab_mismatch_swap_rejected(lm_server):
    server, registry = lm_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url + "/v1/models/lm/swap",
              json.dumps({"source": ZOO_SRC.replace(
                  "vocab_size=48", "vocab_size=64")}).encode(), timeout=300)
    assert e.value.code == 400
    assert "vocab" in json.loads(e.value.read())["error"]
    doc = json.loads(_gen(server.url, {"prompt": [1], "max_tokens": 2,
                                       "stream": False}).read())
    assert len(doc["tokens"]) == 2


def test_kv_endpoints_export_import_and_reject_corruption(lm_server):
    server, registry = lm_server
    importer = ModelRegistry(device="cpu")
    importer.deploy_lm("lm", ZOO_SRC, decode=DecodeConfig(
        slots=2, page_size=8, prefill_buckets=(8, 32)))
    srv2 = ModelServer(importer, port=0, kv_role="decode")
    try:
        prompt = list(range(1, 18))
        blob = urllib.request.urlopen(urllib.request.Request(
            f"{server.url}/v1/models/lm/kv/export",
            data=json.dumps({"prompt": prompt}).encode(),
            headers={"Content-Type": "application/json"}),
            timeout=60).read()
        code, info = _post(f"{srv2.url}/v1/models/lm/kv/import", blob,
                           ctype="application/octet-stream")
        assert code == 200 and info["adopted"] == 2 and info["tokens"] == 16
        a = json.loads(_gen(server.url, {"prompt": prompt, "max_tokens": 5,
                                         "stream": False}).read())
        b = json.loads(_gen(srv2.url, {"prompt": prompt, "max_tokens": 5,
                                       "stream": False}).read())
        assert b["cached_tokens"] == 16 and a["tokens"] == b["tokens"]
        bad = bytearray(blob)
        bad[-40] ^= 0xFF
        for body in (bytes(bad), blob[:30], b"junk"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{srv2.url}/v1/models/lm/kv/import", body,
                      ctype="application/octet-stream")
            assert e.value.code == 400
            e.value.read()
        ready = json.loads(urllib.request.urlopen(f"{srv2.url}/readyz",
                                                  timeout=10).read())
        assert ready["kv_role"] == "decode"
        assert ready["kv_ownership"]["lm"]["block"] == 8
        doc = json.loads(_gen(srv2.url, {"prompt": [3], "max_tokens": 2,
                                         "stream": False}).read())
        assert len(doc["tokens"]) == 2
        with pytest.raises(ValueError, match="kv_role"):
            ModelServer(importer, port=0, kv_role="both")
    finally:
        srv2.drain(timeout=10)


# ------------------------------------------------------ ParallelInference
def _blob(n=64, seed=0):
    return np.random.RandomState(seed).randn(n, N_IN).astype("float32")


def test_parallel_inference_sequential_and_batched():
    X = _blob()
    net = _net(4)
    expected = _out(net, X[:10])
    pi = ParallelInference(net, mode=InferenceMode.SEQUENTIAL)
    np.testing.assert_allclose(pi.output(X[:10]), expected, atol=1e-6)
    with ParallelInference(net, mode=InferenceMode.BATCHED,
                           max_batch_size=32) as pib:
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(pib.output, X[i:i + 5])
                    for i in range(0, 40, 5)]
            outs = [f.result(timeout=60) for f in futs]
    np.testing.assert_allclose(np.concatenate(outs), _out(net, X[:40]),
                               atol=1e-6)


def test_parallel_inference_odd_batch():
    X = _blob()
    net = _net(4)
    out = ParallelInference(net, mode=InferenceMode.SEQUENTIAL).output(
        X[:13])
    assert out.shape == (13, N_OUT)
    np.testing.assert_allclose(out, _out(net, X[:13]), atol=1e-6)


def test_parallel_inference_update_model_swaps_the_network():
    X = _blob(16)
    net_a, net_b = _net(1), _net(2)
    with ParallelInference(net_a, mode=InferenceMode.BATCHED) as pi:
        np.testing.assert_allclose(pi.output(X[:8]), _out(net_a, X[:8]),
                                   atol=1e-6)
        warmed = []
        pi.update_model(net_b, warmup=lambda run: warmed.append(
            run(X[:2]).shape))
        assert warmed == [(2, N_OUT)]
        np.testing.assert_allclose(pi.output(X[:8]), _out(net_b, X[:8]),
                                   atol=1e-6)


def test_parallel_inference_rejects_after_shutdown_and_meshes():
    X = _blob(16)
    net = _net(1)
    pi = ParallelInference(net, mode=InferenceMode.BATCHED)
    pi.output(X[:8])
    pi.shutdown()
    with pytest.raises(RuntimeError):
        pi.output(X[:8])
    # two replicas answer what one device answers, in both modes
    for mode in ("sequential", "batched"):
        with ParallelInference(net, mesh=["cpu", "cpu"], mode=mode) as two:
            assert two.n_devices == 2
            for n in (8, 5):
                np.testing.assert_array_equal(two.output(X[:n]),
                                              _out(net, X[:n]))
    # a plan is accepted (a one-rank plan answers what one device does);
    # an object that is not a plan is refused
    from deeplearning4j_tpu_torch.parallel import ShardingPlan
    with ParallelInference(net.copy(), plan=ShardingPlan(),
                           mode="sequential") as planned:
        assert planned.model._plan_rt is not None
        np.testing.assert_array_equal(planned.output(X[:5]),
                                      _out(net, X[:5]))
    with pytest.raises(TypeError, match="ShardingPlan"):
        ParallelInference(net, plan=object())
    assert ParallelInference(net, mesh=["cpu"],
                             mode="sequential").device.type == "cpu"
