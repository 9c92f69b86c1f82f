"""The port's metrics registry (`deeplearning4j_tpu_torch/monitor/`) held
to the JAX package's, and the port's hooks held to the reference's
metric families on the same paths.

- One fixed sequence of counter, gauge and histogram operations renders
  byte-identical Prometheus and OpenMetrics text in both packages, and
  the same dump / summary / raw sample.
- After the slice's path — a 3-step MultiLayerNetwork fit per call and
  with scan_steps=3, a ComputationGraph fit, one predict and one 8-token
  generate over HTTP — the port's registry holds exactly the reference's
  metric families, with the same types, label names and help strings.
- The fit hooks' contracts: `train_*` counters count steps and examples,
  `train_score` is the last fetched loss, and everything off leaves no
  `xla_*` family and an empty ledger cache.

The two registries are separate objects; each test resets both.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor.metrics import MetricsRegistry


def _reset_all():
    for mod in (monitor, jmonitor):
        mod.REGISTRY.reset()
        mod.disable_tracing()
        mod.clear_trace()
        mod.goodput.disable_goodput()
        mod.flight.disable_flight()
        mod.flight.clear()
        mod.xla.disable_ledger()
        mod.xla.clear_ledger()
        mod.slo.disable_slo()
        mod.timeseries.disable_timeseries()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset_all()
    yield
    _reset_all()


# ------------------------------------------------------------- registry
def _drive(reg):
    """One fixed sequence of operations (labels, escaping, exemplars,
    inclusive bucket edges, float and integer values)."""
    c = reg.counter("req_total", "Requests", labels=("code", "model"))
    c.inc(code="200", model="a")
    c.inc(2.5, code="500", model='b"q\\z\nw')
    reg.counter("plain_total", "No labels").inc(7)
    g = reg.gauge("depth", "Queue depth", labels=("model",))
    g.set(3, model="a")
    g.inc(0.25, model="a")
    g.dec(1, model="b")
    h = reg.histogram("lat_seconds", "Latency", labels=("model",),
                      buckets=(0.01, 0.1, 1.0))
    for v, ex in ((0.005, None), (0.01, "t1"), (0.05, None), (0.5, "t2"),
                  (3.0, "t3"), (1e-9, None)):
        h.observe(v, exemplar=ex, model="a")
    reg.histogram("empty_seconds", "Never observed")
    reg.gauge("big", "Large").set(1e20)
    reg.gauge("neg", "Negative").set(-2.0)


def test_prometheus_and_openmetrics_text_byte_identical():
    mine, ref = MetricsRegistry(), JRegistry()
    _drive(mine)
    _drive(ref)
    assert mine.prometheus_text() == ref.prometheus_text()
    assert mine.openmetrics_text() == ref.openmetrics_text()
    assert mine.dump() == ref.dump()
    assert mine.summary() == ref.summary()
    assert mine.raw_sample() == ref.raw_sample()
    h, jh = mine.collect("lat_seconds"), ref.collect("lat_seconds")
    assert h.snapshot(model="a") == jh.snapshot(model="a")
    assert h.exemplars(model="a") == jh.exemplars(model="a")


@pytest.mark.parametrize("case", ["kind", "labels", "buckets", "decrease",
                                  "label_names", "empty_buckets"])
def test_registry_rejects_what_the_reference_rejects(case):
    def run(reg):
        if case == "kind":
            reg.counter("x_total")
            reg.gauge("x_total")
        elif case == "labels":
            reg.counter("x_total", labels=("a",))
            reg.counter("x_total", labels=("b",))
        elif case == "buckets":
            reg.histogram("h", buckets=(1, 2))
            reg.histogram("h", buckets=(1, 3))
        elif case == "decrease":
            reg.counter("x_total").inc(-1)
        elif case == "label_names":
            reg.counter("x_total", labels=("a",)).inc(b="1")
        else:
            reg.histogram("h", buckets=(float("inf"),))
    for reg in (MetricsRegistry(), JRegistry()):
        with pytest.raises(ValueError):
            run(reg)


def test_module_level_helpers_record_into_the_default_registry():
    monitor.counter("a_total", "A").inc(3)
    monitor.gauge("b", "B").set(2)
    monitor.histogram("c_seconds", "C").observe(0.2)
    assert monitor.summary() == {"a_total": 3.0, "b": 2.0,
                                 "c_seconds": {"count": 1, "sum": 0.2,
                                               "mean": 0.2}}
    assert monitor.prometheus_text() == monitor.REGISTRY.prometheus_text()
    assert monitor.openmetrics_text().endswith("# EOF\n")


# ------------------------------------------------- families on the path
VOCAB, SEQ = 32, 16
LM_SRC = (f"zoo:TransformerLM?vocab_size={VOCAB}&seq_length={SEQ}"
          "&n_layers=1&n_embd=16&n_heads=2&attention_impl=flash")
GEN_SRC = (f"zoo:TransformerLM?vocab_size={VOCAB}&seq_length=64"
           "&n_layers=1&n_embd=16&n_heads=2")


def _blobs(n=48, d=5, k=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d).astype("float32"),
            np.eye(k, dtype="float32")[rs.randint(0, k, n)])


def _mln(pkg, **kw):
    conf_mod = __import__(f"{pkg}.nn.conf.network", fromlist=["x"])
    base = __import__(f"{pkg}.nn.conf.base", fromlist=["x"])
    layers = __import__(f"{pkg}.nn.layers", fromlist=["x"])
    upd = __import__(f"{pkg}.nn.updaters", fromlist=["x"])
    ml = __import__(f"{pkg}.nn.multilayer", fromlist=["x"])
    conf = (conf_mod.NeuralNetConfiguration.Builder().seed(7)
            .updater(upd.Sgd(0.1)).list()
            .layer(layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(base.InputType.feed_forward(5)).build())
    return ml.MultiLayerNetwork(conf, **kw).init()


def _graph(pkg, **kw):
    conf_mod = __import__(f"{pkg}.nn.conf.network", fromlist=["x"])
    base = __import__(f"{pkg}.nn.conf.base", fromlist=["x"])
    layers = __import__(f"{pkg}.nn.layers", fromlist=["x"])
    upd = __import__(f"{pkg}.nn.updaters", fromlist=["x"])
    graph = __import__(f"{pkg}.nn.graph", fromlist=["x"])
    g = (conf_mod.GraphBuilder(conf_mod.NeuralNetConfiguration.Builder()
                               .seed(3).updater(upd.Sgd(0.1)))
         .add_inputs("in").set_input_types(base.InputType.feed_forward(5)))
    g.add_layer("d", layers.DenseLayer(n_out=8, activation="tanh"), "in")
    g.add_layer("out", layers.OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "d")
    g.set_outputs("out")
    return graph.ComputationGraph(g.build(), **kw).init()


def _post(url, path, body, ctype="application/json"):
    req = urllib.request.Request(url + path, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _slice_path(pkg):
    """The slice's path on one package's own stack: fits, a predict and
    an 8-token generate through the HTTP server."""
    kw = {"device": "cpu"} if pkg == "deeplearning4j_tpu_torch" else {}
    X, Y = _blobs()
    _mln(pkg, **kw).fit((X[:48], Y[:48]), batch_size=16, scan_steps=1)
    _mln(pkg, **kw).fit((X[:48], Y[:48]), batch_size=16, scan_steps=3)
    _graph(pkg, **kw).fit((X[:16], Y[:16]), scan_steps=1)
    registry_mod = __import__(f"{pkg}.serving.registry", fromlist=["x"])
    server_mod = __import__(f"{pkg}.serving.server", fromlist=["x"])
    decode_mod = __import__(f"{pkg}.serving.decode", fromlist=["x"])
    registry = registry_mod.ModelRegistry(**kw)
    registry.deploy("m", LM_SRC, buckets=(1,))
    dcfg = dict(slots=1, page_size=8, queue_limit=4)
    if pkg == "deeplearning4j_tpu":
        dcfg["prefill_buckets"] = (8, 32)      # the reference compiles each
    registry.deploy_lm("g", GEN_SRC, decode=decode_mod.DecodeConfig(**dcfg))
    server = server_mod.ModelServer(registry, port=0)
    try:
        ids = np.zeros((1, SEQ, 1), "float32").tolist()
        code, _ = _post(server.url, "/v1/models/m/predict",
                        json.dumps({"inputs": ids}).encode())
        assert code == 200
        code, body = _post(server.url, "/v1/models/g/generate",
                           json.dumps({"prompt": [1, 2, 3], "max_tokens": 8,
                                       "stream": False}).encode())
        assert code == 200 and len(json.loads(body)["tokens"]) == 8
    finally:
        server.drain(timeout=10)


def _families(reg):
    out = {}
    for name, fam in reg.dump().items():
        labels = set()
        for s in fam["series"]:
            labels.add(tuple(sorted(s["labels"])))
        out[name] = (fam["type"], fam["help"], tuple(sorted(labels)))
    return out


def test_metric_families_on_the_slice_path_equal_the_references():
    _slice_path("deeplearning4j_tpu")
    _slice_path("deeplearning4j_tpu_torch")
    mine, ref = _families(monitor.REGISTRY), _families(jmonitor.REGISTRY)
    assert {"train_iterations_total", "train_chunks_dispatched_total",
            "etl_queue_depth", "inference_requests_total",
            "serving_requests_total", "serving_bucket_compiles_total",
            "serving_decode_tokens_total", "serving_decode_ttft_seconds",
            "serving_decode_page_pool_used"} <= set(ref)
    assert sorted(mine) == sorted(ref)
    assert mine == ref


# ------------------------------------------------------------ fit hooks
def test_fit_hooks_count_steps_examples_and_score():
    X, Y = _blobs()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), batch_size=16, scan_steps=1)
    net.fit((X, Y), batch_size=16, scan_steps=3)
    s = monitor.summary()
    assert s["train_iterations_total"] == 6
    assert s["train_examples_total"] == 96
    assert s["train_score"] == pytest.approx(net.score())
    assert s["train_step_seconds"]["count"] == 3       # per-call steps
    assert s["train_host_sync_seconds"]["count"] == 3
    assert s["train_chunks_dispatched_total"] == 1


def test_fit_with_telemetry_off_leaves_no_ledger_trace():
    X, Y = _blobs()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), batch_size=16, scan_steps=3)
    assert net._ledger_cache == {}
    assert monitor.xla.records() == []
    assert not any(n.startswith("xla_") for n in monitor.dump())
    assert monitor.trace_events() == []
    assert monitor.goodput.last_session() is None


def test_fit_spans_nest_as_the_references(tmp_path):
    """The fit's span names and their nesting under `train/epoch` on both
    packages' per-call and scan paths."""
    def names(pkg, mod):
        kw = {"device": "cpu"} if pkg == "deeplearning4j_tpu_torch" else {}
        mod.enable_tracing()
        X, Y = _blobs()
        _mln(pkg, **kw).fit((X, Y), batch_size=16, scan_steps=1)
        _mln(pkg, **kw).fit((X, Y), batch_size=16, scan_steps=3)
        evs = [e for e in mod.trace_events() if e["ph"] == "X"]
        mod.disable_tracing()
        epochs = [e for e in evs if e["name"] == "train/epoch"]
        inside = set()
        for e in evs:
            if any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= p["ts"] + p["dur"] + 1 for p in epochs) \
                    and e["name"] != "train/epoch":
                inside.add(e["name"])
        return sorted({e["name"] for e in evs}), sorted(inside)

    assert names("deeplearning4j_tpu_torch", monitor) \
        == names("deeplearning4j_tpu", jmonitor)


def test_etl_families_from_the_prefetch_thread():
    from deeplearning4j_tpu_torch.data.async_iterator import (
        prefetch_iterable,
    )
    monitor.enable_tracing()
    out = list(prefetch_iterable(range(5), transform=lambda i: i * 2,
                                 queue_size=2))
    assert out == [0, 2, 4, 6, 8]
    s = monitor.summary()
    assert s["etl_batches_prefetched_total"] == 5
    assert s["etl_stage_seconds"]["count"] == 5
    assert s["etl_fetch_wait_seconds"]["count"] == 6   # + the sentinel
    stage = [e for e in monitor.trace_events() if e["name"] == "etl/stage"]
    assert len(stage) == 5
    assert {e["tid"] for e in stage} != {threading.get_ident()}
