"""The port's program ledger (`deeplearning4j_tpu_torch/monitor/xla.py`):
the JAX package's ledger cases (tests/test_xla_ledger.py) held against
the port, and its FLOP counts held to analytic ones.

- Capture dedups by fingerprint but counts every capture; distinct
  shapes get distinct fingerprints; the disabled ledger is a no-op;
  failures are cached; a scan fit records steps_per_call = K and
  total_flops_per_call = K x one step; the JSON schema and
  `merge_existing` are the reference's.
- FLOPs: a small MLP's train step and a 2-layer flash TransformerLM's
  equal analytic counts (every matmul, and the flash kernels by their
  formula: per live (q, k) pair 4·D forward, 6·D dQ, 8·D dK/dV). The
  MLP's count is also held to the reference's XLA cost_analysis on the
  CPU: XLA counts elementwise work too (tanh, softmax, the loss, the SGD
  update), which a matmul counter does not, so the port's count lies
  between 65 % and 100 % of XLA's at this width (74.6 % measured).
- `tools/perf_report.py --dir <one synthetic round> --ledger` (stdlib
  only) reads the port's ledger and places its programs on the
  roofline.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import xla as jxla
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
from deeplearning4j_tpu_torch.ops import flash_attention as fa

from test_torch_monitor import _blobs, _graph, _mln

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_ledger():
    for mod in (monitor, jmonitor):
        mod.REGISTRY.reset()
        mod.xla.disable_ledger()
        mod.xla.clear_ledger()
    yield
    for mod in (monitor, jmonitor):
        mod.REGISTRY.reset()
        mod.xla.disable_ledger()
        mod.xla.clear_ledger()


def _f(x):
    return (x * 2.0).sum()


# --------------------------------------------------------------- capture
def test_capture_dedups_by_fingerprint_but_counts_every_compile():
    xla_ledger.enable_ledger()
    x = torch.ones(8, 4)
    r1 = xla_ledger.capture("t/prog", _f, (x,))
    r2 = xla_ledger.capture("t/prog", _f, (x,))   # re-capture, same key
    assert r1 is not None and r2 is not None
    assert r1 is r2 and r1.compiles == 2
    assert len(xla_ledger.records()) == 1
    ctr = monitor.REGISTRY.collect("xla_compiles_total")
    assert ctr.value(program="t/prog") == 2
    assert monitor.REGISTRY.collect("xla_programs").value() == 1
    hist = monitor.REGISTRY.collect("xla_compile_seconds")
    assert hist.snapshot(program="t/prog")["count"] == 2


def test_distinct_shapes_get_distinct_fingerprints():
    xla_ledger.enable_ledger()
    r1 = xla_ledger.capture("t/prog", _f, (torch.ones(8, 4),))
    r2 = xla_ledger.capture("t/prog", _f, (torch.ones(16, 4),))
    r3 = xla_ledger.capture("t/prog", _f, (torch.ones(8, 4),),
                            steps_per_call=2)
    assert len({r1.fingerprint, r2.fingerprint, r3.fingerprint}) == 3
    assert len(xla_ledger.records()) == 3
    assert r1.arg_shapes == ("float32[8,4]",)


def test_capture_counts_a_matmul_and_its_bytes():
    xla_ledger.enable_ledger()
    a, b = torch.ones(32, 16), torch.ones(16, 8)
    rec = xla_ledger.capture("t/matmul", lambda p, q: p @ q, (a, b))
    assert rec.flops == 2 * 32 * 16 * 8
    # operands and the result, f32
    assert rec.bytes_accessed == 4 * (32 * 16 + 16 * 8 + 32 * 8)
    assert rec.arithmetic_intensity == rec.flops / rec.bytes_accessed
    # the CPU has no allocator peak: counted, not faked
    assert rec.hbm is None
    ctr = monitor.REGISTRY.collect("xla_analysis_unavailable_total")
    assert ctr.value(kind="memory") == 1
    g = monitor.REGISTRY.collect("xla_program_flops")
    assert g.value(program="t/matmul", fingerprint=rec.fingerprint) \
        == rec.flops


def test_disabled_ledger_is_a_noop():
    assert xla_ledger.capture("t/p", _f, (torch.ones(3),)) is None
    cache = {}
    assert xla_ledger.capture_cached(cache, "k", "t/p", _f,
                                     (torch.ones(3),)) is None
    assert cache == {}                      # not even a negative entry
    assert xla_ledger.begin_capture("t/p", ()) is None
    xla_ledger.observe_step(None, 0.1)
    assert xla_ledger.records() == []
    assert not xla_ledger.counting()
    assert not any(name.startswith("xla_") for name in monitor.dump())


def test_capture_cached_caches_failures_too():
    xla_ledger.enable_ledger()

    def broken():
        raise RuntimeError("no step")

    cache = {}
    assert xla_ledger.capture_cached(cache, "k", "t/bad", broken, ()) is None
    assert cache == {"k": None}             # probed once, not every step
    assert xla_ledger.capture_cached(cache, "k", "t/bad", broken, ()) is None
    ctr = monitor.REGISTRY.collect("xla_analysis_unavailable_total")
    assert ctr.value(kind="lower") == 1
    assert not xla_ledger.counting()        # the failed capture closed


# ---------------------------------------------------------- fit paths
def test_fit_captures_per_call_and_scan_as_distinct_programs(monkeypatch):
    monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "1e12")
    xla_ledger.enable_ledger()
    X, Y = _blobs()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), epochs=1, batch_size=16, scan_steps=1)
    per_call = [r for r in xla_ledger.records()
                if r.name == "mln/train_step"]
    net.fit((X, Y), epochs=1, batch_size=16, scan_steps=3)
    scan = [r for r in xla_ledger.records() if r.name == "mln/scan_step"]
    assert len(per_call) == 1 and len(scan) == 1
    assert scan[0].fingerprint != per_call[0].fingerprint
    assert scan[0].steps_per_call == 3
    assert per_call[0].steps_per_call == 1
    # one counted step each; the scan record scales it by K
    assert scan[0].flops == per_call[0].flops
    assert scan[0].total_flops_per_call == 3 * per_call[0].flops
    assert per_call[0].examples_per_call == 16
    assert scan[0].examples_per_call == 48
    assert monitor.REGISTRY.collect("train_mfu_pct").value() > 0
    assert xla_ledger.last_mfu("train") > 0
    # a second fit of the same signature counts nothing new
    net.fit((X, Y), epochs=1, batch_size=16, scan_steps=3)
    assert scan[0].compiles == 1 and len(xla_ledger.records()) == 2


def test_accumulate_fit_counts_one_micro_step_scaled_by_k():
    xla_ledger.enable_ledger()
    X, Y = _blobs()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), epochs=1, batch_size=16, accumulate_steps=3)
    (rec,) = [r for r in xla_ledger.records()
              if r.name == "mln/accum_step"]
    assert rec.steps_per_call == 3
    assert rec.flops == _mlp_train_flops(16)
    assert rec.examples_per_call == 48


def test_compute_dtype_is_part_of_the_programs_signature():
    """bf16 compute over f32 master weights: the same input shapes, a
    different program."""
    import dataclasses
    xla_ledger.enable_ledger()
    X, Y = _blobs()
    for dtype in (None, "bfloat16"):
        net = _mln("deeplearning4j_tpu_torch", device="cpu")
        if dtype:
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )
            net = MultiLayerNetwork(dataclasses.replace(
                net.conf, compute_dtype=dtype), device="cpu").init()
        net.fit((X, Y), batch_size=16, scan_steps=1)
    a, b = xla_ledger.records()
    assert a.name == b.name == "mln/train_step"
    assert a.arg_shapes == b.arg_shapes
    assert a.fingerprint != b.fingerprint


def test_fit_with_ledger_disabled_leaves_no_trace():
    X, Y = _blobs()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), epochs=1, batch_size=16, scan_steps=1)
    assert xla_ledger.records() == []
    assert net._ledger_cache == {}
    assert not any(name.startswith("xla_") for name in monitor.dump())


def test_graph_fit_captures_program():
    xla_ledger.enable_ledger()
    net = _graph("deeplearning4j_tpu_torch", device="cpu")
    X, Y = _blobs()
    net.fit((X, Y), epochs=1, scan_steps=1)
    net.fit([DataSet(X[i:i + 8], Y[i:i + 8]) for i in range(0, 32, 8)],
            epochs=1, scan_steps=2)
    names = {r.name for r in xla_ledger.records()}
    assert {"graph/train_step", "graph/scan_step"} <= names


def test_serving_forward_captured_with_serving_domain(monkeypatch):
    monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "1e12")
    from deeplearning4j_tpu_torch.parallel.inference import (
        InferenceMode, ParallelInference,
    )
    xla_ledger.enable_ledger()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    X, _ = _blobs(n=16)
    with ParallelInference(net, mode=InferenceMode.SEQUENTIAL) as pi:
        out = pi.output(X)      # the counted forward
        out = pi.output(X)      # steady state: feeds serving_mfu_pct
    assert out.shape == (16, 3)
    (rec,) = [r for r in xla_ledger.records() if r.domain == "serving"]
    assert rec.name == "inference/forward"
    assert rec.flops == 2 * 16 * (5 * 8 + 8 * 3)
    assert monitor.REGISTRY.collect("serving_mfu_pct").value() > 0


# ------------------------------------------------------------ FLOP counts
def _mlp_train_flops(b):
    """5 -> 8 -> 3 dense: forward 2·B·(5·8 + 8·3); backward the two
    weight gradients and the second layer's input gradient (the first
    layer's input needs none)."""
    fwd = 2 * b * (5 * 8 + 8 * 3)
    return fwd + 2 * b * (5 * 8 + 8 * 3) + 2 * b * 8 * 3


@pytest.mark.parametrize("batch", [16, 48])
def test_mlp_flops_equal_the_analytic_count_and_track_xla(batch):
    xla_ledger.enable_ledger()
    jxla.enable_ledger()
    X, Y = _blobs()
    _mln("deeplearning4j_tpu_torch", device="cpu").fit(
        (X[:batch], Y[:batch]), batch_size=batch, scan_steps=1)
    _mln("deeplearning4j_tpu").fit((X[:batch], Y[:batch]),
                                   batch_size=batch, scan_steps=1)
    (mine,) = xla_ledger.records()
    (ref,) = jxla.records()
    assert mine.name == ref.name == "mln/train_step"
    assert mine.flops == _mlp_train_flops(batch)
    assert 0.65 * ref.flops <= mine.flops <= ref.flops


def lm_train_flops(b, t, layers, e, heads, vocab):
    """The flash TransformerLM's train step: 6 x the matmul weights
    (q, k, v and out projections, the 4x MLP, the vocab head) x tokens,
    plus the three flash kernels, 18·D per causally live pair."""
    d = e // heads
    gemm = 6 * (12 * e * e * layers + e * vocab) * b * t
    flash = 18 * d * fa.live_pairs(t, t, True) * b * heads * layers
    return gemm + flash


@pytest.mark.parametrize("shape", [(4, 8, 2, 16, 2, 16),
                                   (2, 64, 2, 32, 4, 32)])
def test_flash_lm_flops_equal_the_analytic_count(shape):
    b, t, layers, e, heads, vocab = shape
    xla_ledger.enable_ledger()
    lm = model_by_name("TransformerLM", vocab_size=vocab, seq_length=t,
                       n_layers=layers, n_embd=e, n_heads=heads,
                       attention_impl="flash").init(device="cpu")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (b, t, 1)).astype("float32")
    lab = np.eye(vocab, dtype="float32")[rs.randint(0, vocab, (b, t))]
    lm.fit((ids, lab), batch_size=b, scan_steps=1)
    (rec,) = xla_ledger.records()
    assert rec.flops == lm_train_flops(b, t, layers, e, heads, vocab)
    # the kernels' bytes are in, on top of the ops'
    q = torch.zeros(b, t, heads, e // heads)
    kernel_bytes = sum(fa.kernel_work(n, q, q, True)[1]
                       for n in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv")) * layers
    assert rec.bytes_accessed > kernel_bytes


def test_flash_wrapper_counts_only_inside_a_capture():
    q = torch.randn(2, 8, 2, 16, requires_grad=True)
    out = fa.flash_attention(q, q, q, causal=True)
    out.sum().backward()                    # outside any capture
    xla_ledger.enable_ledger()
    q2 = q.detach().requires_grad_()

    def step(x):
        y = fa.flash_attention(x, x, x, causal=True)
        y.sum().backward()
        return y

    rec = xla_ledger.capture("t/flash", step, (q2,))
    pairs = fa.live_pairs(8, 8, True) * 2 * 2
    assert rec.flops == 18 * 16 * pairs
    assert not xla_ledger.counting()


def test_kernel_work_matches_the_bound_formulas():
    q = torch.zeros(4, 2048, 8, 64, dtype=torch.bfloat16)
    pairs = fa.live_pairs(2048, 2048, True)
    assert pairs * 4 * 8 == 67_141_632
    assert fa.kernel_work("flash_fwd", q, q, True)[0] \
        == 4 * 64 * 67_141_632
    assert fa.kernel_work("flash_bwd_dq", q, q, True)[0] \
        == 6 * 64 * 67_141_632
    assert fa.kernel_work("flash_bwd_dkv", q, q, True)[0] \
        == 8 * 64 * 67_141_632
    assert fa.live_pairs(5, 3, True) == 1 + 2 + 3 + 3 + 3
    assert fa.live_pairs(5, 3, False) == 15


def test_peaks_are_keyed_on_the_device_name(monkeypatch):
    assert xla_ledger.PEAK_FLOPS_BY_KIND == {"NVIDIA H100 80GB HBM3": 989e12}
    assert xla_ledger.HBM_BYTES_PER_SEC_BY_KIND == {
        "NVIDIA H100 80GB HBM3": 3.35e12}
    monkeypatch.setattr(xla_ledger, "_device_info",
                        ("NVIDIA H100 80GB HBM3", "cuda"))
    assert xla_ledger.device_peak_flops() == 989e12
    assert xla_ledger.device_hbm_bytes_per_sec() == 3.35e12
    monkeypatch.setattr(xla_ledger, "_device_info", ("cpu", "cpu"))
    assert xla_ledger.device_peak_flops() is None
    monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "2e12")
    assert xla_ledger.device_peak_flops() == 2e12
    monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "fast")   # degrades, warns
    assert xla_ledger.device_peak_flops() is None


# ------------------------------------------------------------ persistence
def test_save_ledger_schema_and_atomicity(tmp_path):
    xla_ledger.enable_ledger(str(tmp_path / "ledger.json"))
    jxla.enable_ledger(str(tmp_path / "ref.json"))
    xla_ledger.capture("t/prog", lambda a, b: a @ b,
                       (torch.ones(8, 4), torch.ones(4, 2)))
    import jax
    jxla.capture("t/prog", jax.jit(lambda a, b: a @ b),
                 (np.ones((8, 4), "float32"), np.ones((4, 2), "float32")))
    assert xla_ledger.save_ledger() == 1
    jxla.save_ledger()
    doc = json.loads((tmp_path / "ledger.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert doc["version"] == ref["version"] == xla_ledger.LEDGER_SCHEMA_VERSION
    assert sorted(doc) == sorted(ref)
    assert sorted(doc["programs"][0]) == sorted(ref["programs"][0])
    assert doc["device_kind"] == "cpu" and doc["backend"] == "cpu"
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_save_ledger_merge_existing_across_processes(tmp_path):
    path = str(tmp_path / "ledger.json")
    xla_ledger.enable_ledger(path)
    xla_ledger.capture("t/a", _f, (torch.ones(8, 4),))
    xla_ledger.save_ledger()
    # the next process: a fresh in-memory ledger on the same file
    xla_ledger.clear_ledger()
    xla_ledger.enable_ledger(path)
    xla_ledger.capture("t/b", _f, (torch.ones(16, 4),))
    assert xla_ledger.save_ledger(merge_existing=True) == 2
    doc = json.loads((tmp_path / "ledger.json").read_text())
    assert {p["name"] for p in doc["programs"]} == {"t/a", "t/b"}
    assert xla_ledger.save_ledger(merge_existing=True) == 2


def test_save_ledger_without_path_raises():
    xla_ledger.enable_ledger()
    with pytest.raises(ValueError):
        xla_ledger.save_ledger()


def test_perf_report_reads_the_ports_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DL4J_CUDA_HBM_BYTES_PER_SEC", "1e11")
    path = str(tmp_path / "ledger.json")
    xla_ledger.enable_ledger(path)
    X, Y = _blobs()
    _mln("deeplearning4j_tpu_torch", device="cpu").fit(
        (X, Y), batch_size=16, scan_steps=3)
    xla_ledger.save_ledger()
    rounds = tmp_path / "rounds"
    rounds.mkdir()
    # one synthetic round (nothing to compare, so nothing gated): the
    # repo's banked trajectory is not read
    (rounds / "BENCH_r01.json").write_text(json.dumps({"parsed": {
        "metric": "resnet50_train_imgs_per_sec_per_chip", "value": 1.0,
        "unit": "imgs/sec", "vs_baseline": None, "tpu_unavailable": True,
        "sweep": []}}))
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "perf_report.py"),
         "--dir", str(rounds), "--ledger", path, "--json"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    text = json.dumps(doc)
    assert "mln/scan_step" in text
    roof = doc.get("roofline") or []
    assert roof and all(row.get("flops") for row in roof)
