"""The serve CLI's fleet mode (`serving/cli.py`: ``--replicas N``) and the
port's fleet drills.

- ``--replicas 2 --replica-mode inprocess --device cpu`` stands a router
  up over two replicas (`cli.build_fleet`); a predict through it is
  bitwise a replica's direct answer, and `cli.drain_fleet` drains it.
- ``python -m deeplearning4j_tpu_torch.serving --replicas 2 --device
  cpu`` as a real process: subprocess replicas (each started with
  ``--device cpu``), a predict through the router, SIGTERM -> exit 0 with
  the replicas reaped.
- The fleet flags' validations (``--priority-classes``, ``--kv-roles``,
  ``--autoscale-*``, the replica sources) exit with the reference CLI's
  messages, word for word.
- The drills (`tools/serve_chaos`, `tools/rollout_drill`) on the CPU,
  slow-marked as the reference's are.
"""
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import cli

REPO = pathlib.Path(__file__).resolve().parent.parent
LM = dict(vocab_size=32, seq_length=16, n_layers=1, n_embd=32, n_heads=4,
          attention_impl="flash")


def _reset_all():
    for mon in (monitor, jmonitor):
        mon.REGISTRY.reset()
        mon.flight.disable_flight()
        mon.flight.clear()
        mon.slo.disable_slo()
        mon.timeseries.disable_timeseries()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def lm_zip(tmp_path_factory):
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.util.serialization import save_model
    path = tmp_path_factory.mktemp("fleet_cli") / "lm.zip"
    save_model(model_by_name("TransformerLM", **LM).init(device="cpu"),
               str(path))
    return str(path)


def _predict(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    r = urllib.request.urlopen(urllib.request.Request(
        url + "/v1/models/lm/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream"}), timeout=60)
    return r.headers.get("X-Served-By"), np.load(io.BytesIO(r.read()))


def test_inprocess_fleet_serves_a_predict_through_the_router(lm_zip,
                                                             capsys):
    args = cli.build_parser().parse_args([
        "--model", f"lm={lm_zip}", "--replicas", "2", "--replica-mode",
        "inprocess", "--buckets", "1,4", "--device", "cpu", "--port", "0"])
    fleet = cli.build_fleet(args)
    try:
        first = json.loads(capsys.readouterr().out.splitlines()[0])
        assert first["serving"] == fleet.url and first["role"] == "router"
        assert [r["name"] for r in first["replicas"]] \
            == ["replica-0", "replica-1"]
        assert first["priority_classes"] == ["interactive", "standard",
                                             "batch"]
        assert first["rollout"] is None and first["autoscale"] is None
        reps = {r.name: r for r in fleet.supervisor.replicas}
        assert all(str(r._registry.get("lm").model.device) == "cpu"
                   for r in reps.values())
        x = np.random.RandomState(0).randint(0, 32, (3, 16, 1)) \
            .astype("float32")
        served = set()
        for _ in range(6):
            who, y = _predict(fleet.url, x)
            served.add(who)
            assert np.array_equal(y, _predict(reps[who].url, x)[1])
        assert y.shape == (3, 16, 32)
        assert served == set(reps)
    finally:
        cli.drain_fleet(fleet, drain_timeout_s=0.5)
    assert all(r.state == "stopped" for r in fleet.supervisor.replicas)
    assert fleet.server.draining


def test_fleet_cli_process_drains_on_sigterm(lm_zip):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serving",
         "--model", f"lm={lm_zip}", "--replicas", "2", "--buckets", "1",
         "--device", "cpu", "--port", "0", "--drain-timeout-s", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))
    try:
        doc = json.loads(proc.stdout.readline())
        assert doc["role"] == "router"
        x = np.random.RandomState(1).randint(0, 32, (1, 16, 1)) \
            .astype("float32")
        who, y = _predict(doc["serving"], x)
        assert who in ("replica-0", "replica-1") and y.shape == (1, 16, 32)
        fleet_doc = json.loads(urllib.request.urlopen(
            doc["serving"] + "/v1/fleet", timeout=10).read())
        assert [r["state"] for r in fleet_doc["replicas"]] \
            == ["ready", "ready"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert '"action": "fleet drain"' in proc.stderr.read()
        for r in fleet_doc["replicas"]:
            with pytest.raises(OSError):
                urllib.request.urlopen(r["url"] + "/healthz", timeout=2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("argv", [
    ["--model", "m=zoo:LeNet", "--replicas", "2", "--priority-classes",
     " , "],
    ["--lm", "g=zoo:TransformerLM", "--replicas", "2", "--kv-roles",
     "prefill,bogus"],
    ["--lm", "g=zoo:TransformerLM", "--replicas", "2", "--kv-roles",
     "prefill,prefill,decode"],
    ["--model", "m=zoo:LeNet", "--replicas", "2", "--kv-roles", "decode"],
    ["--model", "m=zoo:LeNet", "--replicas", "2", "--replica-mode",
     "inprocess", "--autoscale-max", "1"],
    ["--model", "m=zoo:LeNet", "--replicas", "2", "--replica-mode",
     "inprocess", "--autoscale-max", "3", "--autoscale-high", "0.2"],
    ["--model", "m=/no/such/model.zip", "--replicas", "3"],
], ids=["priority-classes", "kv-roles-unknown", "kv-roles-all-prefill",
        "kv-roles-no-lm", "autoscale-range", "autoscale-watermarks",
        "replica-source"])
def test_fleet_validations_exit_as_the_references(argv):
    from deeplearning4j_tpu.serving import cli as jcli
    with pytest.raises(SystemExit) as ref:
        jcli.main(list(argv))
    with pytest.raises(SystemExit) as mine:
        cli.main(list(argv))
    assert str(mine.value) == str(ref.value)
    assert isinstance(mine.value.code, str) and mine.value.code


# ------------------------------------------------------------ the drills
def _drill(module, tmp_path, timeout=580):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.tools.{module}",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=timeout)
    assert proc.returncode == 0, \
        f"{module} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}"
    return json.loads(out.read_text())


@pytest.mark.slow
def test_serve_chaos_slo_gate(tmp_path):
    """3 subprocess replicas, SIGKILL + wedge under traffic, zero 5xx,
    restart-and-rejoin, p99 recovery, the availability alert — asserted
    by the drill itself (exit 0 == SLO held); then the disaggregation
    drill."""
    report = _drill("serve_chaos", tmp_path)
    assert report["ok"] and not report["failures"]
    assert report["fleet_restarts_total"] >= 2
    assert report["shed"]["batch"] > 0
    assert report["disagg"]["failovers"] >= 1
    assert all(s["tokens"] for s in report["disagg"]["streams"])


@pytest.mark.slow
def test_rollout_drill_end_to_end(tmp_path):
    """train -> blessed checkpoint -> canary -> promote under load with
    zero 5xx, a poisoned blessing rolled back naming probe_accuracy, an
    autoscaling ramp that scales up and drains down."""
    report = _drill("rollout_drill", tmp_path)
    assert report["ok"] and not report["failures"]
    assert report["promote"]["server_5xx"] == 0
    assert report["rollback"]["postmortem_metric"] == "probe_accuracy"
    assert report["autoscale"]["peak_replicas"] > \
        report["autoscale"]["initial_replicas"]
    assert report["autoscale"]["forced_kills"] == 0


def test_chaos_drill_disagg_defaults_are_the_references(tmp_path):
    """The disaggregation drill's prompt length, greedy tokens and
    transfer threshold default to the reference drill's (12, 4, 8) and
    its prompts to the reference's ramp; a longer prompt extends the
    same ramp. Replica logs go beside --out, and nowhere without it."""
    import inspect
    from deeplearning4j_tpu_torch.tools import serve_chaos
    params = inspect.signature(serve_chaos._disagg_drill).parameters
    assert [params[k].default for k in
            ("prompt_tokens", "max_tokens", "min_tokens")] == [12, 4, 8]
    for i in (0, 1, 6, 100, 203):
        assert serve_chaos.disagg_prompt(i, 12, 48) == \
            [(7 * i + j) % 48 for j in range(12)]
    long = serve_chaos.disagg_prompt(3, 382, 1024)
    assert len(long) == 382
    assert long[:12] == serve_chaos.disagg_prompt(3, 12, 1024)
    assert serve_chaos.replica_log_dir(None) is None
    d = serve_chaos.replica_log_dir(str(tmp_path / "chaos.json"))
    assert d == str(tmp_path / "chaos_replicas") and os.path.isdir(d)
    assert serve_chaos.replica_log(d, "kv-0") == os.path.join(d, "kv-0.log")
    assert serve_chaos.replica_log(None, "kv-0") is None
