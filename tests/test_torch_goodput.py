"""The port's goodput ledger (`monitor/goodput.py`) held to the JAX
package's, and its sessions over the port's fits.

- The same span streams under one fake clock give the same categories,
  goodput %, steps and live stats in both packages, and the anomaly
  detector trips on the same spike with the same postmortem meta.
- A container span (`train/dispatch`, `train/chunk_sync`,
  `xla/compile`) that encloses another attributed span banks only what
  its children did not, so the categories of a session still sum to its
  wall time; the reference books such a second twice (a stream the
  reference's own loops emit on the scan path's first chunk).
- A port fit with goodput on, per call and scan, with the ledger
  counting: categories sum to the session's wall time exactly, and
  `compile` is booked.
- `device_wait` passes host values and CPU tensors through, and without
  a session returns at once.
"""
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import flight as jflight
from deeplearning4j_tpu.monitor import goodput as jgoodput
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight, goodput

from test_torch_monitor import _blobs, _mln

PAIRS = ((goodput, flight, monitor), (jgoodput, jflight, jmonitor))


@pytest.fixture(autouse=True)
def _clean():
    for gp, fl, mon in PAIRS:
        mon.REGISTRY.reset()
        mon.disable_tracing()
        mon.clear_trace()
        gp.disable_goodput()
        fl.disable_flight()
        fl.clear()
        mon.xla.disable_ledger()
        mon.xla.clear_ledger()
    yield
    for gp, fl, mon in PAIRS:
        mon.REGISTRY.reset()
        mon.disable_tracing()
        mon.clear_trace()
        gp.disable_goodput()
        fl.disable_flight()
        fl.clear()
        mon.xla.disable_ledger()
        mon.xla.clear_ledger()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


GOLDEN = [("train/etl", 0.0, 1.0, {}),
          ("train/device_wait", 1.0, 3.0, {}),
          ("train/host_sync", 3.0, 3.5, {}),
          ("train/step", 1.0, 3.5, {"iteration": 0}),
          ("xla/compile", 3.5, 4.0, {}),
          ("resilience/checkpoint_save", 4.0, 5.0, {}),
          ("resilience/eval_gate", 5.0, 5.5, {}),
          ("train/resume_replay", 5.5, 6.0, {}),
          ("train/barrier_wait", 6.0, 6.25, {}),
          ("not/a/category", 6.0, 7.0, {})]


def _replay(gp, stream, end, **knobs):
    clk = _FakeClock()
    led = gp.GoodputLedger(clock=clk, **knobs)
    s = led.fit_begin("golden/fit")
    for name, t0, t1, attrs in stream:
        led.on_span(name, t0, t1, dict(attrs))
        clk.t = max(clk.t, t1)
    live = led.live_stats()
    clk.t = end
    out = led.fit_end(s)
    out.pop("trace_id")
    return out, live


def test_same_stream_same_attribution():
    (mine, mlive), (ref, rlive) = (_replay(gp, GOLDEN, 8.0)
                                   for gp, _, _ in PAIRS)
    assert mine == ref
    assert mlive == rlive
    assert mine["categories"]["other"] == 2.0
    assert sum(mine["categories"].values()) == pytest.approx(8.0)
    for _, _, mon in PAIRS:
        assert mon.REGISTRY.collect("train_goodput_pct").value() == 25.0
    assert monitor.dump() == jmonitor.dump()
    assert goodput.CATEGORIES == jgoodput.CATEGORIES
    assert goodput.SPAN_CATEGORY == jgoodput.SPAN_CATEGORY


def _steady(n, spike_at=None):
    stream, t = [], 0.0
    for i in range(n):
        if i == spike_at:
            stream.append(("train/etl", t, t + 4.8, {}))
            t += 4.8
            stream.append(("train/step", t, t + 0.2, {"iteration": i}))
            t += 0.2
        else:
            stream.append(("train/etl", t, t + 0.1, {}))
            stream.append(("train/step", t + 0.1, t + 1.0,
                           {"iteration": i}))
            t += 1.0
    return stream, t


def test_anomaly_trips_on_the_same_spike(tmp_path):
    stream, end = _steady(40, spike_at=20)
    docs = []
    for gp, fl, mon in PAIRS:
        d = tmp_path / mon.__name__
        d.mkdir()
        fl.enable_flight(dump_dir=str(d))
        out, _ = _replay(gp, stream, end, warmup_steps=4,
                         anomaly_cooldown_steps=32)
        assert out["anomalies"] == 1
        doc = fl.postmortems()[-1]
        docs.append((out, doc["reason"], doc["meta"]))
    (mine, mr, mm), (ref, rr, rm) = docs
    assert mine == ref and mr == rr == "step_time_anomaly"
    mm.pop("trace_id", None)
    rm.pop("trace_id", None)
    assert mm == rm
    assert mm["dominant_category"] == "data_wait" and mm["step"] == 20


def test_a_container_span_banks_only_what_its_children_did_not():
    """The scan path's first chunk: an xla/compile capture (with an nvcc
    build inside it) inside train/dispatch, then train/chunk_sync."""
    stream = [("train/etl", 0.0, 1.0, {}),
              ("xla/compile", 1.5, 2.0, {}),        # nvcc inside capture
              ("xla/compile", 1.2, 3.0, {}),        # the counted step
              ("train/dispatch", 1.0, 4.0, {}),
              ("train/chunk_sync", 4.0, 5.0, {})]
    out, _ = _replay(goodput, stream, 6.0)
    cats = out["categories"]
    assert cats["compile"] == pytest.approx(1.8)
    assert cats["step_compute"] == pytest.approx(1.2 + 1.0)
    assert cats["data_wait"] == pytest.approx(1.0)
    assert cats["other"] == pytest.approx(1.0)
    assert sum(cats.values()) == pytest.approx(out["wall_s"])
    ref, _ = _replay(jgoodput, stream, 6.0)
    # the reference books the nested seconds twice
    assert sum(ref["categories"].values()) > ref["wall_s"] + 1.0


@pytest.mark.parametrize("scan", [1, 3])
def test_a_port_fit_session_sums_to_its_wall_time(scan):
    goodput.enable_goodput()
    monitor.xla.enable_ledger()
    X, Y = _blobs(n=96)
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    net.fit((X, Y), epochs=2, batch_size=16, scan_steps=scan)
    out = goodput.last_session()
    assert out["kind"] == "mln/fit"
    cats = out["categories"]
    assert sum(cats.values()) == pytest.approx(out["wall_s"], abs=1e-5)
    assert all(v >= 0 for v in cats.values())
    assert cats["compile"] > 0 and cats["step_compute"] > 0
    assert cats["data_wait"] > 0
    fam = monitor.REGISTRY.collect("train_time_seconds_total")
    assert sum(fam.value(category=c) for c in goodput.CATEGORIES) \
        == pytest.approx(out["wall_s"], abs=1e-5)
    if scan == 1:
        assert out["steps"] == 12


def test_session_closes_when_the_fit_raises():
    goodput.enable_goodput()
    net = _mln("deeplearning4j_tpu_torch", device="cpu")
    X, _ = _blobs()
    with pytest.raises(Exception):
        net.fit((X, X[:, :2]), batch_size=16)      # wrong label width
    assert goodput.ledger()._session is None
    assert goodput.last_session() is not None


def test_device_wait_passthrough():
    assert goodput.device_wait(3.0) == 3.0
    t = torch.ones(2)
    assert goodput.device_wait(t) is t          # no ledger
    goodput.enable_goodput()
    assert goodput.device_wait(t) is t          # no session
    s = goodput.fit_begin()
    assert goodput.device_wait(t) is t          # a CPU tensor
    goodput.fit_end(s)


def test_decode_split_notes_aggregate_as_the_reference():
    for gp, _, _ in PAIRS:
        gp.enable_goodput()
        for cat, secs in (("admission", 0.5), ("step_compute", 2.0),
                          ("idle", 1.0), ("step_compute", 0.25),
                          ("page_stall", 0.0)):
            gp.decode_note("lm", cat, secs)
    assert goodput.decode_totals() == jgoodput.decode_totals()
    assert monitor.dump() == jmonitor.dump()
