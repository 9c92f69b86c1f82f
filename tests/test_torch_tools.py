"""The port's tools (`deeplearning4j_tpu_torch/tools/`) against the JAX
package's `tools/` on the same seeded inputs.

- `make_shards` writes shards byte for byte the reference tool's, from an
  image tree and from a CSV;
- `make_dl4j_fixture` writes the reference's zips and expected outputs
  byte for byte (and the fixtures committed under tests/fixtures/dl4j);
- `trace_report` merges the same segments into the same document;
- `goodput_report` draws the same waterfall from the same recorded
  session, and its drill holds on the CPU;
- the smokes (`chaos_fit`, `etl_smoke`, `serve_smoke`,
  `telemetry_smoke`) exit 0 on the CPU; `decode_smoke` holds every gate
  on the CPU but the speculative A/B's inter-token one (fault C.8 in
  ROADMAP.md: the port's speculative round costs 2k+1 plain steps);
- `flash_smoke --device cpu --small` holds; its cases' outputs and
  gradients (the plain versions on the CPU) agree with the reference's
  Pallas kernels run in interpret mode;
- `mfu_probe` and `profile_capture` run at tiny shapes on the CPU and
  label their rows as the CPU's;
- every tool that runs a network raises without CUDA unless asked for
  the CPU.
"""
import filecmp
import importlib.util
import io
import json
import os
import subprocess
import sys
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_TOOLS = ("chaos_fit", "decode_smoke", "etl_smoke", "flash_smoke",
                "goodput_report", "mfu_probe", "profile_capture",
                "serve_smoke", "telemetry_smoke")


def _ref_tool(name):
    """The JAX package's `tools/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"deeplearning4j_tpu_torch.tools.{name}")


def _run(name, *args, timeout=600):
    """`python -m deeplearning4j_tpu_torch.tools.<name> args` in a fresh
    process (the smokes set process-global telemetry): (rc, stdout)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.tools.{name}",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _last_json(text):
    """The last top-level JSON object printed (indented or one line)."""
    return json.loads(text[text.rfind("\n{") + 1:])


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)
    return names


# ------------------------------------------------------------- make_shards
@pytest.fixture
def etl_env(monkeypatch):
    """The converters set their packages' ETL knobs with setdefault:
    pinned here so the test process's environment is restored after."""
    for var in ("DL4J_TPU_ETL_WORKERS", "DL4J_TPU_FIT_PREFETCH",
                "DL4J_CUDA_ETL_WORKERS", "DL4J_CUDA_FIT_PREFETCH"):
        monkeypatch.setenv(var, "0")


def _image_tree(root, classes=3, per_class=7, hw=10):
    from PIL import Image
    rs = np.random.RandomState(5)
    for c in range(classes):
        os.makedirs(root / f"class{c}")
        for i in range(per_class):
            Image.fromarray(rs.randint(0, 256, (hw, hw, 3), dtype=np.uint8)
                            ).save(root / f"class{c}" / f"{i:02d}.png")
    return str(root)


@pytest.mark.parametrize("shuffle", [None, 3])
def test_make_shards_image_tree_is_the_reference_bytes(tmp_path, etl_env,
                                                       shuffle):
    src = _image_tree(tmp_path / "imgs")
    argv = ["--image-dir", src, "--height", "10", "--width", "10",
            "--shard-records", "8", "--batch", "5", "--verify"]
    if shuffle is not None:
        argv += ["--shuffle-seed", str(shuffle)]
    outs = {}
    for side, mod in (("ref", _ref_tool("make_shards")),
                      ("port", _port_tool("make_shards"))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(["--out", str(tmp_path / side)] + argv) == 0
        outs[side] = json.loads(buf.getvalue())
    names = _same_tree(tmp_path / "ref", tmp_path / "port")
    assert "index.json" in names and len(names) == 1 + 3   # 21 records / 8
    for s in outs.values():
        s.pop("out")
    assert outs["port"] == outs["ref"] and outs["port"]["verified"] is True


def test_make_shards_csv_is_the_reference_bytes(tmp_path, etl_env):
    rs = np.random.RandomState(9)
    rows = np.concatenate([rs.randn(50, 4).round(4),
                           rs.randint(0, 3, (50, 1))], axis=1)
    csv = tmp_path / "data.csv"
    csv.write_text("a,b,c,d,label\n" + "\n".join(
        ",".join(f"{v:g}" for v in r) for r in rows) + "\n")
    argv = ["--csv", str(csv), "--label-index", "4", "--num-classes", "3",
            "--skip-lines", "1", "--shard-records", "16", "--batch", "7",
            "--verify"]
    for side, mod in (("ref", _ref_tool("make_shards")),
                      ("port", _port_tool("make_shards"))):
        with redirect_stdout(io.StringIO()):
            assert mod.main(["--out", str(tmp_path / side)] + argv) == 0
    assert len(_same_tree(tmp_path / "ref", tmp_path / "port")) == 1 + 4


def test_make_shards_factory_resolves_against_the_port(tmp_path, etl_env,
                                                       monkeypatch):
    mod = tmp_path / "my_factory.py"
    mod.write_text(
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.data.iterator import "
        "ArrayDataSetIterator\n"
        "def make():\n"
        "    rs = np.random.RandomState(0)\n"
        "    X = rs.randint(0, 256, (30, 4, 4, 1)).astype(np.uint8)\n"
        "    Y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 30)]\n"
        "    return ArrayDataSetIterator(X, Y, batch_size=8, "
        "drop_last=False)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert _port_tool("make_shards").main(
            ["--out", str(tmp_path / "out"), "--factory", "my_factory:make",
             "--verify"]) == 0
    s = json.loads(buf.getvalue())
    assert s["n_records"] == 30 and s["num_classes"] == 2 and s["verified"]


# -------------------------------------------------------- make_dl4j_fixture
def test_make_dl4j_fixture_is_the_reference_bytes(tmp_path):
    ref = _ref_tool("make_dl4j_fixture")
    ref.FIXDIR = str(tmp_path / "ref")
    with redirect_stdout(io.StringIO()):
        ref.main()
        ref.make_cnn()
        ref.make_lstm()
        assert _port_tool("make_dl4j_fixture").main(
            ["--out", str(tmp_path / "port")]) == 0
    names = _same_tree(tmp_path / "ref", tmp_path / "port")
    assert len(names) == 6
    committed = os.path.join(REPO, "tests", "fixtures", "dl4j")
    for n in names:                 # the fixtures the repo's tests read
        assert filecmp.cmp(tmp_path / "port" / n,
                           os.path.join(committed, n), shallow=False), n
    for n in (n for n in names if n.endswith(".zip")):
        with zipfile.ZipFile(tmp_path / "port" / n) as zp, \
                zipfile.ZipFile(tmp_path / "ref" / n) as zr:
            assert zp.namelist() == zr.namelist()
            assert json.loads(zp.read("configuration.json")) == json.loads(
                zr.read("configuration.json"))
            assert zp.read("coefficients.bin") == zr.read("coefficients.bin")


# ------------------------------------------------------------ trace_report
def _segments(tmp_path):
    pid = 4242
    router = {"traceEvents": [
        {"name": "serving/route", "ph": "X", "ts": 10.0, "dur": 50.0,
         "pid": pid, "tid": 1, "args": {"trace_id": "aa" * 16}},
        {"name": "serving/route", "ph": "X", "ts": 70.0, "dur": 20.0,
         "pid": pid, "tid": 2, "args": {"trace_id": "bb" * 16}},
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "router"}}]}
    replica = [   # a bare event array, the pid colliding with the router's
        {"name": "serving/request", "ph": "X", "ts": 20.0, "dur": 30.0,
         "pid": pid, "tid": 7, "args": {"trace_id": "aa" * 16}},
        {"name": "serving/batch", "ph": "i", "ts": 25.0, "pid": pid,
         "tid": 7, "args": {"trace_id": "aa" * 16}},
        {"name": "serving/request", "ph": "X", "ts": 75.0, "dur": 5.0,
         "pid": 9, "tid": 7, "args": {"trace_id": "bb" * 16}}]
    paths = []
    for name, doc in (("fleet.json", router),
                      ("fleet.replica-0.json", replica)):
        p = tmp_path / name
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("trace_id", [None, "aa" * 16])
def test_trace_report_merges_as_the_reference(tmp_path, trace_id):
    paths = _segments(tmp_path)
    inputs = [paths[0], "replica=" + paths[1]]
    got = {}
    for side, mod in (("ref", _ref_tool("trace_report")),
                      ("port", _port_tool("trace_report"))):
        out = tmp_path / f"{side}.json"
        argv = ["--out", str(out)] + inputs
        if trace_id:
            argv += ["--trace-id", trace_id]
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(argv) == 0
        got[side] = (json.loads(out.read_text()),
                     buf.getvalue().replace(str(out), "OUT"))
    assert got["port"] == got["ref"]
    doc = got["port"][0]
    pids = {e["pid"] for e in doc["traceEvents"]}
    assert len(pids) == (2 if trace_id else 3)


def test_trace_report_refuses_what_the_reference_refuses(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no": "events"}))
    for mod in (_ref_tool("trace_report"), _port_tool("trace_report")):
        with redirect_stdout(io.StringIO()):
            assert mod.main([str(tmp_path / "missing.json")]) == 2
            assert mod.main([str(bad)]) == 2
            assert mod.main(_segments(tmp_path)
                            + ["--trace-id", "cc" * 16]) == 2


# ---------------------------------------------------------- goodput_report
def test_goodput_waterfall_is_the_reference_arithmetic():
    """The same recorded session (the categories a fit attributed) draws
    the same waterfall in both tools."""
    summary = {"wall_s": 2.5, "steps": 48, "goodput_pct": 61.2,
               "categories": {"step_compute": 1.53, "data_wait": 0.51,
                              "checkpoint": 0.25, "eval_gate": 0.0004,
                              "compile": 0.0, "host_sync": 0.1,
                              "other": 0.1096}}
    texts = []
    for mod in (_ref_tool("goodput_report"), _port_tool("goodput_report")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod._waterfall("clean fit", summary, 2.51)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "data_wait" in texts[0]


def test_goodput_report_holds_on_the_cpu(tmp_path):
    rc, out, err = _run("goodput_report", "--device", "cpu", "--out",
                        str(tmp_path / "g.json"))
    assert rc == 0, err[-3000:]
    rep = json.loads((tmp_path / "g.json").read_text())
    assert rep["ok"] and rep["device"] == "cpu"
    assert rep["throttled"]["postmortem"]["dominant_category"] == "data_wait"


# ------------------------------------------------------------------ smokes
@pytest.mark.parametrize("name,args", [
    ("chaos_fit", ("--seed", "1")),
    ("etl_smoke", ()),
    ("serve_smoke", ()),
    ("telemetry_smoke", ()),
])
def test_smoke_exits_0_on_the_cpu(name, args):
    rc, out, err = _run(name, "--device", "cpu", *args)
    assert rc == 0, (out[-3000:], err[-3000:])
    rep = _last_json(out)
    assert rep["ok"] is True and rep.get("device", "cpu") == "cpu"


def test_chaos_schedule_is_the_reference_schedule():
    """The seeded fault schedule (which steps get NaN, transient errors,
    the crash) is the reference tool's: the same `random.Random` draws."""
    rc, out, err = _run("chaos_fit", "--device", "cpu", "--seed", "1")
    rep = _last_json(out)
    import random
    rng = random.Random(1)
    pool = list(range(1, rep["total_steps"] - 1))
    rng.shuffle(pool)
    assert rep["total_steps"] == (240 // 24) * 4
    assert rep["nan_at"] == sorted(pool[:3])
    assert rep["transient_at"] == sorted(pool[3:6])
    assert rep["crash_at"] == pool[6]


def test_decode_smoke_on_the_cpu_fails_only_the_spec_itl_gate(tmp_path):
    """Every gate of the decode smoke holds on the CPU — zero 5xx through
    a mid-traffic swap, the first-run ledger balanced, preempted joins,
    prefix-cache hits and hot TTFT >= 2x cold, chunked prefill improving
    the interferer ITL, greedy parity and > 0.5 acceptance of the
    speculative twin, spill-tier parity, affinity beating random — but
    one: speculation does not lower the mean inter-token p99 (fault C.8
    in ROADMAP.md). When C.8 is fixed this test must require exit 0."""
    out = tmp_path / "decode.json"
    rc, stdout, err = _run("decode_smoke", "--device", "cpu", "--out",
                           str(out), "--requests", "12", timeout=900)
    rep = json.loads(out.read_text())
    spec_gate = [f for f in rep["failures"]
                 if f.startswith("speculation did not improve")]
    assert rep["failures"] == spec_gate, rep["failures"]
    assert rc == (1 if spec_gate else 0)
    assert rep["spec_ab"]["mismatched_streams"] == 0
    assert rep["spec_ab"]["acceptance_rate"] > 0.5
    assert rep["ledger"]["compiles"] == rep["ledger"]["warmups"] > 0
    assert rep["prefix_ttft"]["speedup"] >= 2
    assert rep["spill"]["parity"] is True


# ------------------------------------------------------------- flash_smoke
def test_flash_smoke_holds_on_the_cpu():
    rc, out, err = _run("flash_smoke", "--device", "cpu", "--small")
    assert rc == 0, (out[-3000:], err[-3000:])
    rep = _last_json(out)
    assert rep["ok"] and rep["failures"] == []


@pytest.mark.parametrize("idx", [0, 3, 4])
def test_flash_smoke_forward_matches_the_reference_kernel(idx):
    """The smoke's forward case (the plain version on the CPU) against
    the reference's Pallas forward in interpret mode on the same inputs:
    a causal bf16 case, the masked f32 case and the padded case."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.flash_attention import flash_attention
    fs = _port_tool("flash_smoke")
    case = fs.FWD_CASES[idx]
    out, _, row = fs.forward_case(case, torch.device("cpu"), small=True)
    assert row["ok"]
    b, t, h, d = row["shape"]
    dtype = fs.DTYPES[case[5]]
    q, k, v = (jnp.asarray(x.float().numpy(), jnp.bfloat16
                           if dtype == torch.bfloat16 else jnp.float32)
               for x in fs._inputs(0, b, t, h, d, dtype, "cpu"))
    mask = None
    if case[7]:
        m = np.ones((b, t), np.float32)
        m[:, t - t // 4:] = 0.0
        mask = jnp.asarray(m)
    ref = flash_attention(q, k, v, mask=mask, causal=case[6],
                          block_q=case[8], block_k=case[9], interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **fs.FWD_TOL[dtype])


@pytest.mark.parametrize("idx", [1, 3])
def test_flash_smoke_backward_matches_the_reference_kernel(idx):
    """The smoke's gradients of sum(out**2) against the reference's Pallas
    backward in interpret mode: the f32 full case and the padded bf16
    causal case."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.flash_attention import flash_attention
    fs = _port_tool("flash_smoke")
    case = fs.BWD_CASES[idx]
    got, _, row = fs.backward_case(case, torch.device("cpu"), small=True)
    assert row["ok"]
    b, t, h, d = row["shape"]
    dtype = fs.DTYPES[case[5]]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = (jnp.asarray(x.float().numpy(), jdt)
               for x in fs._inputs(1, b, t, h, d, dtype, "cpu"))

    def loss(q, k, v):
        o = flash_attention(q, k, v, causal=case[6], interpret=True)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   **fs.BWD_TOL[dtype])


# --------------------------------------------------- mfu_probe / profiling
def test_mfu_probe_runs_on_the_cpu_and_says_so():
    rc, out, err = _run("mfu_probe", "--device", "cpu")
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    kinds = [r["kind"] for r in rows]
    assert kinds.count("matmul-peak") == 2 and "conv-micro" in kinds
    segs = [r["segment"] for r in rows if r["kind"] == "resnet-segment"]
    assert segs == ["fwd", "fwd+bwd", "full-step", "fit(scan_steps=2)"]
    for r in rows[:-1]:
        assert r["device_kind"] == "cpu" and r["on_gpu"] is False
        assert "pct_of_peak" not in r and "mfu_pct" not in r
    assert kinds[-1] == "metrics-summary"


def test_profile_capture_writes_a_loadable_trace(tmp_path):
    out = tmp_path / "trace.json"
    rc, stdout, err = _run("profile_capture", "--device", "cpu", "--batch",
                           "2", "--hw", "32", "--steps", "2", "--out",
                           str(out))
    assert rc == 0, err[-3000:]
    doc = json.loads(out.read_text())
    assert len(doc["traceEvents"]) > 100
    assert "throughput suppressed" in stdout and "imgs/s" not in stdout


# ---------------------------------------------------------------- devices
@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_tool_raises_without_cuda(name, monkeypatch):
    """CUDA by default: without it a tool raises rather than running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _port_tool(name)
    if name == "etl_smoke":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run()
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
