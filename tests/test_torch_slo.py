"""The port's time-series ring and SLO engine (`monitor/timeseries.py`,
`monitor/slo.py`) held to the JAX package's under one injected clock.

The same synthetic series — request counters with error bursts, a
latency histogram with a slow tail, a gauge — go into both packages'
registries; every sample, the windowed views (increase, rate, quantiles,
gauge stats) and every engine evaluation (verdicts, alert states,
burn-rate firings and their trips) must agree. The flight recorder's
postmortem file of an SLO trip has the reference's keys.
"""
import json

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import slo as jslo
from deeplearning4j_tpu.monitor import timeseries as jts
from deeplearning4j_tpu.monitor.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import slo
from deeplearning4j_tpu_torch.monitor import timeseries as ts
from deeplearning4j_tpu_torch.monitor.metrics import MetricsRegistry

PAIRS = ((MetricsRegistry, ts, slo, monitor),
         (JRegistry, jts, jslo, jmonitor))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean():
    for _, tsm, slm, mon in PAIRS:
        slm.disable_slo()
        tsm.disable_timeseries()
        mon.REGISTRY.reset()
        mon.flight.disable_flight()
        mon.flight.clear()
    yield
    for _, tsm, slm, mon in PAIRS:
        slm.disable_slo()
        tsm.disable_timeseries()
        mon.REGISTRY.reset()
        mon.flight.disable_flight()
        mon.flight.clear()


def _series(seed=0, n=90):
    """Per tick: (ok, errors, latencies, queue depth)."""
    rs = np.random.RandomState(seed)
    ticks = []
    for i in range(n):
        bad = int(rs.poisson(6)) if 30 <= i < 50 else 0
        lat = list(rs.exponential(0.02, size=8))
        if 40 <= i < 60:
            lat += [0.4, 0.6]                      # a slow tail
        ticks.append((int(rs.poisson(20)), bad, lat, float(rs.randint(9))))
    return ticks


def _run(reg_cls, tsm, slm, ticks):
    clock = FakeClock()
    reg = reg_cls()
    ring = tsm.TimeSeriesRing(registry=reg, time_fn=clock, wall_fn=clock)
    c = reg.counter("serving_requests_total", "r", labels=("model", "code"))
    h = reg.histogram("serving_request_seconds", "lat", labels=("model",),
                      buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0))
    g = reg.gauge("serving_queue_depth", "q", labels=("model",))
    c.inc(0, model="m", code="500")
    rules = (slm.BurnRule("page", 20.0, 5.0, 2.0, keep_firing_s=4.0),
             slm.BurnRule("ticket", 40.0, 10.0, 1.5, keep_firing_s=8.0))
    objectives = slm.server_objectives(slo_p99_ms=100.0,
                                       availability_target=0.99)
    trips = []
    eng = slm.SLOEngine(ring, objectives, rules=rules, time_fn=clock,
                        wall_fn=clock,
                        trip_fn=lambda reason, **m: trips.append(
                            (reason, m)))
    states, views = [], []
    for ok, bad, lat, depth in ticks:
        c.inc(ok, model="m", code="200")
        if bad:
            c.inc(bad, model="m", code="500")
        for v in lat:
            h.observe(v, model="m")
        g.set(depth, model="m")
        clock.advance(1.0)
        ring.sample()
        eng.evaluate()
        states.append({(o, s): eng.alert_state(o, s)
                       for o in ("availability", "latency_p99")
                       for s in ("page", "ticket")})
        views.append((ring.increase("serving_requests_total", 10.0),
                      ring.rate("serving_requests_total", 10.0),
                      ring.increase_by("serving_requests_total", 10.0,
                                       "code")))
    verdict = eng.verdict()
    verdict.pop("now_unix", None)
    return {"states": states, "views": views, "trips": trips,
            "history": eng.history(), "verdict": verdict,
            "describe": ring.describe(),
            "q": ring.query("serving_request_seconds", 30.0, model="m"),
            "g": ring.query("serving_queue_depth", 30.0, model="m")}


def test_same_series_same_views_verdicts_and_firings():
    ticks = _series()
    (mine, ref) = (_run(r, t, s, ticks) for r, t, s, _ in PAIRS)
    assert any(st[("availability", "page")] == "firing"
               for st in ref["states"])
    assert ref["trips"]
    for key in ("states", "views", "trips", "history", "verdict", "q",
                "g"):
        assert mine[key] == ref[key], key
    mine["describe"].pop("now_unix", None)
    ref["describe"].pop("now_unix", None)
    assert mine["describe"] == ref["describe"]


@pytest.mark.parametrize("seed", [1, 2])
def test_counter_resets_and_quiet_series_agree(seed):
    outs = []
    for reg_cls, tsm, _, _ in PAIRS:
        clock = FakeClock()
        reg = reg_cls()
        ring = tsm.TimeSeriesRing(registry=reg, time_fn=clock,
                                  wall_fn=clock)
        rs = np.random.RandomState(seed)
        vals = []
        for i in range(40):
            if i == 20:
                reg.reset()                     # a process restart
            reg.counter("x_total", "x").inc(float(rs.poisson(3)))
            clock.advance(1.0)
            ring.sample()
            vals.append((ring.increase("x_total", 15.0),
                         ring.increase("nope_total", 15.0),
                         ring.rate("x_total", 0.5)))
        outs.append(vals)
    assert outs[0] == outs[1]


def test_engine_exports_the_references_slo_families():
    dumps = []
    for reg_cls, tsm, slm, mon in PAIRS:
        clock = FakeClock()
        ring = tsm.TimeSeriesRing(registry=mon.REGISTRY, time_fn=clock,
                                  wall_fn=clock)
        c = mon.counter("reqs_total", "r", labels=("code",))
        eng = slm.SLOEngine(
            ring, [slm.Objective("avail", "availability", "reqs_total",
                                 0.9)],
            rules=(slm.BurnRule("page", 20.0, 5.0, 2.0),), time_fn=clock,
            wall_fn=clock, trip_fn=lambda *a, **k: None)
        for ok, bad in ((1, 1), (5, 5)):
            c.inc(ok, code="200")
            c.inc(bad, code="500")
            clock.advance(1.0)
            ring.sample()
        eng.evaluate()
        d = mon.dump()
        for fam in d.values():
            for s in fam["series"]:
                s.pop("value", None)
                s.pop("sum", None)
                s.pop("buckets", None)
        dumps.append(d)
    assert dumps[0] == dumps[1]
    assert "slo_alert_state" in dumps[0]


def test_slo_trip_postmortem_has_the_references_keys(tmp_path):
    docs = []
    for reg_cls, tsm, slm, mon in PAIRS:
        d = tmp_path / mon.__name__
        d.mkdir()
        mon.flight.enable_flight(dump_dir=str(d))
        clock = FakeClock()
        ring = tsm.TimeSeriesRing(registry=mon.REGISTRY, time_fn=clock,
                                  wall_fn=clock)
        c = mon.counter("serving_requests_total", "r",
                        labels=("model", "code"))
        c.inc(0, model="m", code="500")
        eng = slm.SLOEngine(ring, slm.server_objectives(
            availability_target=0.99),
            rules=(slm.BurnRule("page", 10.0, 2.0, 2.0),), time_fn=clock,
            wall_fn=clock)
        for i in range(12):
            c.inc(5, model="m", code="200")
            c.inc(5 if i > 4 else 0, model="m", code="500")
            clock.advance(1.0)
            ring.sample()
            eng.evaluate()
        (path,) = list(d.iterdir())
        assert "slo_availability_burn" in path.name
        docs.append(json.loads(path.read_text()))
    mine, ref = docs
    assert sorted(mine) == sorted(ref)
    assert mine["reason"] == ref["reason"] == "slo_availability_burn"
    assert sorted(mine["meta"]) == sorted(ref["meta"])
    assert mine["meta"]["severity"] == ref["meta"]["severity"]


def test_timeseries_and_slo_are_off_by_default():
    import threading
    assert not ts.timeseries_enabled() and ts.default_ring() is None
    assert slo.default_engine() is None
    assert not any(t.name == "timeseries-sampler"
                   for t in threading.enumerate())
    ring = ts.enable_timeseries(interval_s=60.0)
    assert ts.enable_timeseries() is ring
    ts.disable_timeseries()
    assert ts.default_ring() is None
    with pytest.raises(RuntimeError):
        slo.enable_slo([slo.Objective("a", "availability", "x_total", 0.9)])
    assert [(r.long_window_s, r.short_window_s, r.burn_threshold)
            for r in slo.DEFAULT_RULES] \
        == [(r.long_window_s, r.short_window_s, r.burn_threshold)
            for r in jslo.DEFAULT_RULES]
