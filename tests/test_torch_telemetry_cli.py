"""The telemetry surface of the port's CLIs and server, over a CPU drive.

- The train CLI's `--metrics`, `--trace-out` and `--perf-ledger` (the
  reference's flags, refused by the port until now): the summary line on
  stderr, the Chrome trace with the fit's spans, the ledger JSON with the
  step program (beside `--trace-out` by default, or
  `DL4J_CUDA_PERF_LEDGER`), the goodput partition, and a `finally` that
  writes them without masking the fit's own exception.
- The serve CLI's nine flags (`--enable-fault-injection`, `--trace-out`,
  `--postmortem-dir`, `--flight-records`, `--no-flight`, `--slo-p99-ms`,
  `--slo-availability`, `--slo-sample-interval-s`, `--slo-windows`) and
  the routes they open: `GET /metrics` (and OpenMetrics), `/v1/slo`,
  `/v1/timeseries`, `/v1/debug/flight`, `GET`/`POST /v1/faults`; a
  `traceparent` reaching the flight recorder and `X-Trace-Id`; an
  injected fault counted as a 5xx, burning the availability SLO and
  leaving postmortems; `main()` writing the trace on SIGTERM.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.serving import cli as serve_cli
from deeplearning4j_tpu_torch.train import cli as train_cli
from deeplearning4j_tpu_torch.util.serialization import save_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ = 16, 8
LM_SRC = (f"zoo:TransformerLM?vocab_size={VOCAB}&seq_length={SEQ}"
          "&n_layers=1&n_embd=16&n_heads=2&attention_impl=flash")
GEN_SRC = (f"zoo:TransformerLM?vocab_size={VOCAB}&seq_length=64"
           "&n_layers=1&n_embd=16&n_heads=2")
TRACEPARENT = "00-0123456789abcdef0123456789abcdef-fedcba9876543210-01"


def _reset():
    monitor.REGISTRY.reset()
    monitor.disable_tracing()
    monitor.clear_trace()
    monitor.goodput.disable_goodput()
    monitor.xla.disable_ledger()
    monitor.xla.clear_ledger()
    monitor.flight.disable_flight()
    monitor.flight.clear()
    monitor.slo.disable_slo()
    monitor.timeseries.disable_timeseries()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


@pytest.fixture
def lm_data(tmp_path):
    lm = model_by_name("TransformerLM", vocab_size=VOCAB, seq_length=SEQ,
                       n_layers=1, n_embd=16, n_heads=2,
                       attention_impl="flash").init(device="cpu")
    model = save_model(lm, str(tmp_path / "lm.zip"))
    rs = np.random.RandomState(0)
    data = str(tmp_path / "tokens.npz")
    np.savez(data, features=rs.randint(0, VOCAB, (16, SEQ, 1)).astype(
        "float32"), labels=np.eye(VOCAB, dtype="uint8")[
        rs.randint(0, VOCAB, (16, SEQ))])
    return model, data


def _train_argv(model, data, tmp_path, *extra):
    return ["--model", model, "--dataset", data, "--output",
            str(tmp_path / "out.zip"), "--mode", "single", "--device", "cpu",
            "--batch-size", "4", *extra]


# -------------------------------------------------------------- train CLI
def test_train_cli_metrics_trace_and_ledger(lm_data, tmp_path, capsys):
    model, data = lm_data
    trace = tmp_path / "t" / "trace.json"
    trace.parent.mkdir()
    assert train_cli.main(_train_argv(model, data, tmp_path, "--metrics",
                                      "--trace-out", str(trace))) == 0
    err = capsys.readouterr().err
    (line,) = [ln for ln in err.splitlines() if ln.startswith('{"metrics"')]
    summary = json.loads(line)["metrics"]
    assert summary["train_iterations_total"] == 4
    assert summary["train_examples_total"] == 16
    assert "train_goodput_pct" in summary
    assert sum(v for k, v in summary.items()
               if k.startswith("train_time_seconds_total")) > 0
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"train/epoch", "train/step", "train/etl", "train/host_sync",
            "train/device_wait", "xla/compile"} <= names
    # the ledger defaults to perf_ledger.json beside --trace-out
    ledger = json.loads((trace.parent / "perf_ledger.json").read_text())
    (prog,) = ledger["programs"]
    assert prog["name"] == "mln/train_step" and prog["flops"] > 0
    assert "perf ledger:" in err and "trace:" in err


def test_train_cli_perf_ledger_flag_and_env_default(lm_data, tmp_path,
                                                    monkeypatch, capsys):
    model, data = lm_data
    path = tmp_path / "explicit.json"
    assert train_cli.main(_train_argv(model, data, tmp_path,
                                      "--perf-ledger", str(path))) == 0
    assert json.loads(path.read_text())["programs"][0]["name"] \
        == "mln/train_step"
    _reset()
    env_path = tmp_path / "from_env.json"
    monkeypatch.setenv("DL4J_CUDA_PERF_LEDGER", str(env_path))
    monkeypatch.setenv("DL4J_CUDA_SCAN_STEPS", "2")
    assert train_cli.main(_train_argv(model, data, tmp_path)) == 0
    assert json.loads(env_path.read_text())["programs"][0]["name"] \
        == "mln/scan_step"
    capsys.readouterr()


def test_train_cli_telemetry_never_masks_the_fits_error(lm_data, tmp_path,
                                                        capsys):
    model, _ = lm_data
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, features=np.zeros((4, SEQ, 1), "float32"),
             labels=np.zeros((4, SEQ, VOCAB + 3), "float32"))
    trace = tmp_path / "trace.json"
    with pytest.raises(Exception) as e:
        train_cli.main(_train_argv(model, bad, tmp_path, "--metrics",
                                   "--trace-out", str(trace)))
    assert not isinstance(e.value, OSError)
    assert trace.exists()                   # written in the finally
    assert '{"metrics"' in capsys.readouterr().err
    # an unwritable trace path fails neither the run nor the ledger
    _reset()
    model2, data = lm_data
    assert train_cli.main(_train_argv(
        model2, data, tmp_path, "--trace-out",
        str(tmp_path / "missing" / "dir" / "t.json"), "--perf-ledger",
        str(tmp_path / "l.json"))) == 0
    err = capsys.readouterr().err
    assert "trace not written" in err
    assert (tmp_path / "l.json").exists()


# -------------------------------------------------------------- serve CLI
NINE = ["--enable-fault-injection", "--trace-out", "--postmortem-dir",
        "--flight-records", "--no-flight", "--slo-p99-ms",
        "--slo-availability", "--slo-sample-interval-s", "--slo-windows"]


def test_serve_cli_parses_the_nine_flags_as_the_reference():
    from deeplearning4j_tpu.serving import cli as jcli
    argv = ["--model", "m=zoo:LeNet", "--enable-fault-injection",
            "--trace-out", "t.json", "--postmortem-dir", "pm",
            "--flight-records", "64", "--no-flight", "--slo-p99-ms", "250",
            "--slo-availability", "0.999", "--slo-sample-interval-s", "0.5",
            "--slo-windows", "20,5,120,30"]
    mine = vars(serve_cli.build_parser().parse_args(argv))
    ref = vars(jcli.build_parser().parse_args(argv))
    for flag in NINE:
        key = flag[2:].replace("-", "_")
        assert mine[key] == ref[key], flag
    defaults = vars(serve_cli.build_parser().parse_args(["--model", "m=x"]))
    jdefaults = vars(jcli.build_parser().parse_args(["--model", "m=x"]))
    for flag in NINE:
        key = flag[2:].replace("-", "_")
        assert defaults[key] == jdefaults[key], flag


def _req(url, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _count(url, model, code):
    _, body, _ = _req(url, "/metrics")
    for ln in body.decode().splitlines():
        if ln.startswith("serving_requests_total{") \
                and f'model="{model}"' in ln and f'code="{code}"' in ln:
            return float(ln.split()[-1])
    return 0.0


def test_serve_routes_trace_ids_faults_and_slo(tmp_path):
    pm = tmp_path / "pm"
    args = serve_cli.build_parser().parse_args([
        "--model", f"m={LM_SRC}", "--lm", f"g={GEN_SRC}",
        "--decode-slots", "2", "--decode-page-size", "8", "--buckets",
        "1,4", "--device", "cpu", "--port", "0",
        "--enable-fault-injection", "--trace-out", str(tmp_path / "t.json"),
        "--postmortem-dir", str(pm), "--flight-records", "64",
        "--slo-availability", "0.99", "--slo-p99-ms", "5000",
        "--slo-sample-interval-s", "0.1", "--slo-windows", "2,0.5,4,1"])
    _, server = serve_cli.build(args)
    url = server.url
    try:
        x = np.zeros((2, SEQ, 1)).tolist()
        code, _, hdr = _req(url, "/v1/models/m/predict", {"inputs": x},
                            {"traceparent": TRACEPARENT})
        assert code == 200
        assert hdr["X-Trace-Id"] == "0123456789abcdef0123456789abcdef"
        code, body, hdr = _req(url, "/v1/models/g/generate",
                               {"prompt": [1, 2, 3], "max_tokens": 8,
                                "stream": False})
        assert code == 200 and len(json.loads(body)["tokens"]) == 8
        assert "X-Trace-Id" in hdr
        flight = json.loads(_req(url, "/v1/debug/flight")[1])
        traced = [r for r in flight["records"]
                  if r["trace_id"] == "0123456789abcdef0123456789abcdef"]
        assert traced and traced[0]["outcome"] == "ok"
        before_ok = _count(url, "m", "200")
        before_5xx = _count(url, "m", "500")
        code, body, _ = _req(url, "/v1/faults", {"predict_error": True})
        assert code == 200 and json.loads(body)["predict_error"] is True
        assert json.loads(_req(url, "/v1/faults")[1])["predict_error"]
        for _ in range(12):
            assert _req(url, "/v1/models/m/predict",
                        {"inputs": x})[0] == 500
            time.sleep(0.05)
        assert _count(url, "m", "500") == before_5xx + 12
        assert _count(url, "m", "200") == before_ok
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            verdict = json.loads(_req(url, "/v1/slo")[1])
            if verdict["state"] == "firing":
                break
            time.sleep(0.1)
        assert verdict["enabled"] and verdict["state"] == "firing"
        names = os.listdir(pm)
        assert any("http_5xx" in n for n in names)
        assert any("slo_availability_burn" in n for n in names)
        ts = json.loads(_req(url, "/v1/timeseries?series="
                                  "serving_requests_total&window=60")[1])
        assert ts["enabled"]
        om = _req(url, "/metrics?format=openmetrics")[1].decode()
        assert om.endswith("# EOF\n")
        _req(url, "/v1/faults", {"predict_error": False})
        assert _req(url, "/v1/faults", ["not", "a", "dict"])[0] == 400
    finally:
        server.drain(timeout=10)


def test_serve_without_the_flags_keeps_the_routes_quiet(tmp_path):
    args = serve_cli.build_parser().parse_args([
        "--model", f"m={LM_SRC}", "--buckets", "1", "--device", "cpu",
        "--port", "0", "--no-flight"])
    _, server = serve_cli.build(args)
    try:
        assert _req(server.url, "/v1/faults")[0] == 404
        assert _req(server.url, "/v1/faults", {"probe_error": 1})[0] == 404
        assert json.loads(_req(server.url, "/v1/slo")[1]) \
            == {"enabled": False}
        assert json.loads(_req(server.url, "/v1/timeseries")[1]) \
            == {"enabled": False}
        assert not monitor.flight.enabled()
        code, body, _ = _req(server.url, "/metrics")
        assert code == 200 and b"serving_model_ready" in body
    finally:
        server.drain(timeout=10)


def test_serve_main_writes_the_trace_on_sigterm(tmp_path):
    trace = tmp_path / "serve_trace.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serving",
         "--model", f"m={LM_SRC}", "--buckets", "1", "--device", "cpu",
         "--port", "0", "--trace-out", str(trace)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        first = json.loads(proc.stdout.readline())
        assert "/metrics" in first["endpoints"]
        code, _, hdr = _req(first["serving"], "/v1/models/m/predict",
                            {"inputs": np.zeros((1, SEQ, 1)).tolist()},
                            {"traceparent": TRACEPARENT})
        assert code == 200 and hdr["X-Trace-Id"].startswith("0123")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serving/request", "serving/batch",
            "serving/queue_wait"} <= names
    assert any(e.get("args", {}).get("trace_id")
               == "0123456789abcdef0123456789abcdef" for e in events)
