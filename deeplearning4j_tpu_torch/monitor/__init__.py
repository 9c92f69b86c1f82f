"""Unified telemetry: metrics registry, trace spans, the program ledger.

Counterpart of the JAX package's `monitor/`, with its names as the
contract: metric families, label sets, help strings, span names, goodput
categories and the ledger's JSON schema are the reference's, so its
catalog (docs/OBSERVABILITY.md) and its stdlib-only readers
(`tools/perf_report.py --ledger`, `tools/trace_report.py`) read the
port's output unchanged. The halves:

- **Metrics** (monitor/metrics.py): thread-safe labeled counters /
  gauges / fixed-bucket histograms in a process-global registry,
  exposed as Prometheus text at ``GET /metrics`` on the model server
  and as `dump()` / `summary()` dicts for tools and tests.
- **Tracing** (monitor/trace.py): `span("name", **attrs)` context
  manager — zero-cost while disabled — producing thread-aware Chrome
  trace-event JSON loadable in Perfetto / chrome://tracing, with
  optional mirroring into `torch.profiler` and NVTX ranges.
- **Program ledger** (monitor/xla.py, `monitor.xla.*`): every hot-path
  step program's fingerprint, capture time, FLOPs and bytes counted over
  one eager step (the flash kernels by their formula), and HBM
  breakdown — `xla_*` metric families, live `train_mfu_pct` /
  `serving_mfu_pct` gauges, and a JSON perf-ledger artifact. Zero-cost
  while disabled (the default), same contract as `span()`.
- **Time-series + SLO engine** (monitor/timeseries.py, monitor/slo.py):
  a bounded ring of registry snapshots turning counters/histograms into
  windowed rates and percentiles, and declarative SLO objectives
  evaluated as multi-window burn-rate alerts whose firings call
  `flight.trip()` — served at ``GET /v1/slo`` / ``GET /v1/timeseries``
  by the serving stack. Zero-cost while disabled, same contract.

Everything in-tree records into the default registry: the fit loops of
both containers (step wall time, host sync, examples, score), the ETL
pipeline (queue depth, fetch wait, per-worker decode), and the serving
stack (request latency, batch size, queue depth, decode split, KV
utilization). Nothing here imports torch at import time: spawned ETL
workers import this package.

Quickstart:

    from deeplearning4j_tpu_torch import monitor
    monitor.enable_tracing()
    net.fit(data, epochs=1)                   # instrumented end to end
    monitor.save_trace("/tmp/fit_trace.json") # load in ui.perfetto.dev
    print(monitor.prometheus_text())          # or scrape GET /metrics
"""
from deeplearning4j_tpu_torch.monitor.metrics import (
    DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    counter, dump, gauge, histogram, openmetrics_text, prometheus_text,
    summary,
)
from deeplearning4j_tpu_torch.monitor.trace import (
    TRACEPARENT_HEADER, TraceContext, add_span, bind_context, clear_trace,
    current_context, disable_tracing, enable_tracing, instant,
    mint_context, parse_traceparent, save_trace, span, trace_events,
    tracing_enabled,
)
# the program ledger (xla_* families, MFU gauges, perf ledger JSON) —
# namespaced as monitor.xla
from deeplearning4j_tpu_torch.monitor import xla  # noqa: E402,F401
# the per-request flight recorder + SLO postmortems — namespaced as
# monitor.flight; see docs/OBSERVABILITY.md "Tracing a single request"
from deeplearning4j_tpu_torch.monitor import flight  # noqa: E402,F401
# the in-process metrics time-series ring (windowed rates/percentiles)
# — namespaced as monitor.timeseries; docs/OBSERVABILITY.md "SLOs and
# burn-rate alerting"
from deeplearning4j_tpu_torch.monitor import timeseries  # noqa: E402,F401
# the SLO engine (objectives, multi-window burn-rate alerts, fleet
# verdicts on GET /v1/slo) — namespaced as monitor.slo
from deeplearning4j_tpu_torch.monitor import slo  # noqa: E402,F401
# the goodput ledger (wall-clock attribution per fit, train_goodput_pct,
# step-time anomaly trips) — namespaced as monitor.goodput;
# docs/OBSERVABILITY.md "Goodput accounting"
from deeplearning4j_tpu_torch.monitor import goodput  # noqa: E402,F401

__all__ = [
    "DEFAULT_BUCKETS", "REGISTRY", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "counter", "dump", "gauge", "histogram",
    "openmetrics_text", "prometheus_text", "summary",
    "TRACEPARENT_HEADER", "TraceContext", "add_span", "bind_context",
    "clear_trace", "current_context", "disable_tracing", "enable_tracing",
    "instant", "mint_context", "parse_traceparent", "save_trace", "span",
    "trace_events", "tracing_enabled",
    "xla", "flight", "timeseries", "slo", "goodput",
]
