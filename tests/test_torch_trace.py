"""The port's tracing and flight recorder (`monitor/trace.py`,
`monitor/flight.py`) held to the JAX package's.

- One fixed sequence of spans (nested, thread-bound contexts, explicit
  contexts, add_span, instants, another thread) gives trace JSON with the
  reference's event structure, names, args and nesting; timestamps, pids,
  thread ids and minted ids aside.
- `traceparent` parse and mint agree: the same headers parse to the same
  triples (malformed ones to None), and a minted context has the
  reference's shape and round-trips through the other package's parser.
- The flight recorder's ring, notes and snapshot have the reference's
  structure; the zero-cost contract holds (shared null span, no context
  while disabled).
- `enable_tracing(profiler_ranges=True)` mirrors spans into
  `torch.profiler` (the reference's `jax_annotations=True`).
"""
import json
import threading

import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import flight as jflight
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight


@pytest.fixture(autouse=True)
def _clean():
    for mon, fl in ((monitor, flight), (jmonitor, jflight)):
        mon.disable_tracing()
        mon.clear_trace()
        mon.REGISTRY.reset()
        fl.disable_flight()
        fl.clear()
    yield
    for mon, fl in ((monitor, flight), (jmonitor, jflight)):
        mon.disable_tracing()
        mon.clear_trace()
        mon.REGISTRY.reset()
        fl.disable_flight()
        fl.clear()


FIXED = "00-0123456789abcdef0123456789abcdef-fedcba9876543210-01"


def _drive(mon, tmp_path, tag):
    """The fixed sequence; returns the saved trace document."""
    mon.enable_tracing()
    ctx = mon.parse_traceparent(FIXED)
    with mon.span("outer", model="m", n=3):
        with mon.bind_context(ctx):
            with mon.span("inner", k=1.5):
                mon.instant("mark", why="x")
            mon.add_span("explicit", 1.0, 2.0, ctx=ctx, rows=4)
        with mon.span("after"):
            pass
    t = threading.Thread(target=lambda: mon.add_span("worker", 3.0, 4.0),
                         name="side-thread")
    t.start()
    t.join()
    path = tmp_path / f"{tag}.json"
    n = mon.save_trace(str(path))
    doc = json.loads(path.read_text())
    assert n == len([e for e in doc["traceEvents"] if e["ph"] != "M"])
    return doc


def _shape(doc):
    """Events without clocks, processes or thread ids; nesting as each
    event's enclosing span names on its thread."""
    evs = doc["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    out = []
    for e in evs:
        keep = {k: v for k, v in e.items()
                if k not in ("ts", "dur", "pid", "tid")}
        if e["ph"] == "M":
            keep["args"] = {"name": e["args"]["name"]} \
                if "name" in e.get("args", {}) else e.get("args")
            keep["thread"] = e["args"].get("name")
        args = dict(keep.get("args") or {})
        args.pop("ctx_span", None)
        keep["args"] = args
        if e["ph"] in ("X", "i"):
            keep["parents"] = sorted(
                p["name"] for p in spans if p is not e
                and p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                and e["ts"] + e.get("dur", 0) <= p["ts"] + p["dur"])
        out.append(keep)
    key = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
    return sorted(out, key=key)


def test_trace_json_has_the_references_structure(tmp_path):
    mine = _drive(monitor, tmp_path, "mine")
    ref = _drive(jmonitor, tmp_path, "ref")
    assert sorted(mine) == sorted(ref)
    assert {k: v for k, v in mine.items() if k != "traceEvents"} \
        == {k: v for k, v in ref.items() if k != "traceEvents"}
    assert _shape(mine) == _shape(ref)


@pytest.mark.parametrize("header", [
    FIXED, None, "", "garbage", "00-short-beef-01",
    "00-" + "g" * 32 + "-" + "a" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "a" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 29 + "_bb" + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
])
def test_traceparent_parse_agrees(header):
    mine, ref = monitor.parse_traceparent(header), \
        jmonitor.parse_traceparent(header)
    assert (mine is None) == (ref is None)
    if mine is not None:
        assert (mine.trace_id, mine.span_id, mine.parent_id) \
            == (ref.trace_id, ref.span_id, ref.parent_id)
        assert mine.header() == ref.header()


def test_minted_contexts_round_trip_across_packages():
    for mon, other in ((monitor, jmonitor), (jmonitor, monitor)):
        ctx = mon.mint_context()
        assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
        parsed = other.parse_traceparent(ctx.header())
        assert (parsed.trace_id, parsed.span_id) == (ctx.trace_id,
                                                     ctx.span_id)
        child = parsed.child()
        assert child.trace_id == ctx.trace_id
        assert child.parent_id == ctx.span_id
    assert monitor.TRACEPARENT_HEADER == jmonitor.TRACEPARENT_HEADER


def test_request_context_minted_vs_adopted_as_the_reference():
    for fl, mon in ((flight, monitor), (jflight, jmonitor)):
        fl.enable_flight()
        adopted = fl.request_context(FIXED, "server")
        assert adopted.trace_id == "0123456789abcdef0123456789abcdef"
        assert adopted.parent_id == "fedcba9876543210"
        fresh = fl.request_context("not-a-header", "server")
        assert fresh is not None and fresh.parent_id is None
    assert sorted(monitor.dump()) == sorted(jmonitor.dump())


def test_flight_ring_snapshot_and_postmortem_match(tmp_path):
    docs = []
    for fl, mon, d in ((flight, monitor, tmp_path / "mine"),
                       (jflight, jmonitor, tmp_path / "ref")):
        d.mkdir()
        fl.enable_flight(capacity=4, dump_dir=str(d))
        ctx = mon.parse_traceparent(FIXED)
        rec = fl.begin(ctx, "predict", model="m")
        fl.note(ctx, "dispatch", wait_ms=1.5)
        fl.finish(rec, "http_500", code=500)
        for _ in range(6):
            fl.finish(fl.begin(mon.mint_context(), "predict"), "ok")
        path = fl.trip("http_5xx", model="m", trace_id=ctx.trace_id)
        assert fl.trip("http_5xx", model="m") is None      # cooldown
        snap = fl.snapshot()
        assert len(snap["records"]) == 4
        docs.append((snap, json.loads(open(path).read())))
    (snap, pm), (jsnap, jpm) = docs
    assert sorted(snap) == sorted(jsnap)
    assert sorted(snap["records"][0]) == sorted(jsnap["records"][0])
    assert sorted(pm) == sorted(jpm)
    assert pm["reason"] == jpm["reason"] == "http_5xx"
    assert pm["meta"] == jpm["meta"]


def test_disabled_request_path_allocates_nothing():
    assert monitor.span("x", model="m") is monitor.span("y", n=3)
    assert flight.request_context(FIXED, "server") is None
    assert flight.begin(monitor.mint_context(), "predict") is None
    flight.note("deadbeef", "event")
    flight.finish(None, "ok")
    with monitor.bind_context(None):
        assert monitor.current_context() is None
    assert monitor.trace_events() == []
    assert flight.snapshot()["records"] == []


def test_profiler_ranges_mirror_spans_into_torch_profiler():
    from torch.profiler import ProfilerActivity, profile
    monitor.enable_tracing(profiler_ranges=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monitor.span("train/step"):
            torch.ones(4) + 1
    names = {e.name for e in prof.events()}
    assert "train/step" in names
    assert [e["name"] for e in monitor.trace_events()] == ["train/step"]
    monitor.enable_tracing()           # plain tracing: no mirroring
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monitor.span("train/etl"):
            pass
    assert "train/etl" not in {e.name for e in prof.events()}
