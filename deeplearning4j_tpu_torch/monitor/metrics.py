"""Metrics half of the telemetry subsystem (see monitor/__init__.py).

A dependency-free, thread-safe registry of labeled counters, gauges, and
fixed-bucket histograms, exposed two ways:

- `prometheus_text()` — the Prometheus text exposition format (v0.0.4),
  served by `UIServer` at ``GET /metrics`` so any scraper (Prometheus,
  curl, a load balancer health probe) can read the training/serving
  telemetry without extra dependencies;
- `dump()` / `summary()` — plain dict views for tests and CLI tools.

Two more faces serve specific consumers: `openmetrics_text()` is the
opt-in OpenMetrics 1.0 exposition (``GET /metrics?format=openmetrics``)
that renders histogram trace exemplars scrapably, and `raw_sample()` is
the compact numeric snapshot `monitor/timeseries.py` rings buffer to
compute windowed rates, percentiles and SLO burn rates.

Design notes:

- Metric *families* (name + label names) hold *children* (one per label
  value combination). Instrumented code looks families up by name on
  every use (`monitor.counter("x").inc()`): the lookup is one dict get
  under a lock (~µs), and it keeps call sites robust against a test
  calling `REGISTRY.reset()` between runs — no stale cached handles.
- Counters/gauges are plain floats guarded by the family lock; the fit
  loops only ever touch host scalars here, never device values, so
  instrumentation can't introduce a device->host sync on the fast path.
- Histograms are Prometheus-style cumulative fixed-bucket: ``le`` upper
  bounds are inclusive, every observation lands in `+Inf`, and `_sum` /
  `_count` ride along.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: Prometheus' default duration buckets (seconds) — right-sized for step
#: times, ETL waits, checkpoint IO, and request latencies alike.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integers without the trailing
    .0 (so counter lines read `x_total 3`), floats via repr (full
    precision round-trip)."""
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Family:
    """One metric family: name, help, label names, children by label
    values. Subclasses define the child state and sample rendering."""

    type_name = ""

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _child(self, labels: Dict[str, str]):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._new_child()
            self._children[key] = child
        return child

    def _new_child(self):
        raise NotImplementedError

    # rendering -----------------------------------------------------------
    def _render(self, lines: List[str]):
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.type_name}")
        with self._lock:
            items = sorted(self._children.items())
            for key, child in items:
                self._render_child(lines, key, child)

    def _render_child(self, lines, key, child):
        raise NotImplementedError

    def _dump_series_all(self) -> List[dict]:
        """Every child's dump-series dict (the per-family slice of
        MetricsRegistry.dump())."""
        with self._lock:
            return [self._dump_series(k, c)
                    for k, c in sorted(self._children.items())]

    def _raw_value(self, child):
        """The child's compact numeric state for raw_sample() — floats
        for counters/gauges, (bucket_counts, sum, count) for
        histograms. Must be immutable-by-copy: the time-series ring
        stores it verbatim."""
        raise NotImplementedError

    # OpenMetrics rendering -----------------------------------------------
    def _om_name(self) -> str:
        """The family's OpenMetrics metric name (counters drop the
        _total suffix on HELP/TYPE lines; samples keep it)."""
        return self.name

    def _render_om(self, lines: List[str]):
        base = self._om_name()
        lines.append(f"# HELP {base} {self.help}")
        lines.append(f"# TYPE {base} {self.type_name}")
        with self._lock:
            for key, child in sorted(self._children.items()):
                self._render_om_child(lines, key, child)

    def _render_om_child(self, lines, key, child):
        # identical to v0.0.4 for scalars; Histogram overrides to carry
        # exemplars
        self._render_child(lines, key, child)


class Counter(_Family):
    """Monotonically increasing value (events, bytes, steps)."""

    type_name = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._child(labels)[0])

    def _render_child(self, lines, key, child):
        lines.append(f"{self.name}{_label_str(self.label_names, key)} "
                     f"{_fmt(child[0])}")

    def _dump_series(self, key, child):
        return {"labels": dict(zip(self.label_names, key)),
                "value": float(child[0])}

    def _raw_value(self, child):
        return float(child[0])

    def _om_name(self) -> str:
        # OpenMetrics: a counter family is named without the _total
        # suffix; the sample lines keep it
        if self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name


class Gauge(_Family):
    """Point-in-time value (queue depth, last score, examples/sec)."""

    type_name = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels):
        with self._lock:
            self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            self._child(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._child(labels)[0])

    _render_child = Counter._render_child
    _dump_series = Counter._dump_series
    _raw_value = Counter._raw_value


class _HistChild:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets      # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        #: bucket index -> (value, trace_id): the LAST exemplar observed
        #: per bucket, so a p99 bucket links to a concrete request trace
        #: (docs/OBSERVABILITY.md "Tracing a single request"). None until
        #: an observation actually carries an exemplar — the plain
        #: observe() path allocates nothing.
        self.exemplars = None


class Histogram(_Family):
    """Fixed-bucket Prometheus histogram: `le` bounds are inclusive
    upper edges, rendered cumulatively with a final `+Inf` bucket."""

    type_name = "histogram"

    def __init__(self, name, help, label_names,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        self.buckets = self._normalize_buckets(buckets)

    @staticmethod
    def _normalize_buckets(buckets: Sequence[float]) -> Tuple[float, ...]:
        bs = sorted(float(b) for b in buckets)
        if bs and bs[-1] == float("inf"):      # +Inf is implicit
            bs = bs[:-1]
        if not bs:
            raise ValueError("histogram needs at least one finite bucket")
        return tuple(bs)

    def _new_child(self):
        return _HistChild(len(self.buckets) + 1)

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels):
        """Record one observation. `exemplar` (a trace_id) is stored as
        the landing bucket's last exemplar — never rendered into the
        v0.0.4 text exposition (classic scrapers would choke); read it
        via dump() / exemplars()."""
        value = float(value)
        i = 0
        for b in self.buckets:          # tiny fixed list: linear is fine
            if value <= b:
                break
            i += 1
        with self._lock:
            c = self._child(labels)
            c.counts[i] += 1
            c.sum += value
            c.count += 1
            if exemplar is not None:
                if c.exemplars is None:
                    c.exemplars = {}
                c.exemplars[i] = (value, str(exemplar))

    def exemplars(self, **labels) -> dict:
        """`le` bound -> {"value", "trace_id"} for every bucket that has
        seen an exemplar-carrying observation."""
        with self._lock:
            c = self._child(labels)
            ex = dict(c.exemplars) if c.exemplars else {}
        bounds = tuple(_fmt(b) for b in self.buckets) + ("+Inf",)
        return {bounds[i]: {"value": v, "trace_id": t}
                for i, (v, t) in sorted(ex.items())}

    def snapshot(self, **labels) -> dict:
        """Cumulative bucket counts keyed by `le` string, plus sum/count."""
        with self._lock:
            c = self._child(labels)
            counts, total, n = list(c.counts), c.sum, c.count
        cum, out = 0, {}
        for b, cnt in zip(self.buckets, counts):
            cum += cnt
            out[_fmt(b)] = cum
        out["+Inf"] = cum + counts[-1]
        return {"buckets": out, "sum": total, "count": n}

    def _render_child(self, lines, key, child):
        cum = 0
        for b, cnt in zip(self.buckets, child.counts):
            cum += cnt
            lines.append(
                f"{self.name}_bucket"
                f"{_label_str(self.label_names + ('le',), key + (_fmt(b),))}"
                f" {cum}")
        cum += child.counts[-1]
        lines.append(
            f"{self.name}_bucket"
            f"{_label_str(self.label_names + ('le',), key + ('+Inf',))}"
            f" {cum}")
        ls = _label_str(self.label_names, key)
        lines.append(f"{self.name}_sum{ls} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{ls} {child.count}")

    def _raw_value(self, child):
        return (tuple(child.counts), float(child.sum), int(child.count))

    def _render_om_child(self, lines, key, child):
        """Bucket lines as in v0.0.4 plus OpenMetrics exemplar syntax
        (`... # {trace_id="..."} value`) on buckets that saw an
        exemplar-carrying observation — the scrapeable face of the
        trace exemplars."""
        ex = child.exemplars or {}
        bounds = tuple(_fmt(b) for b in self.buckets) + ("+Inf",)
        cum = 0
        for i, bound in enumerate(bounds):
            cum += child.counts[i]
            line = (f"{self.name}_bucket"
                    f"{_label_str(self.label_names + ('le',), key + (bound,))}"
                    f" {cum}")
            if i in ex:
                value, trace_id = ex[i]
                line += (f' # {{trace_id="{_escape_label(trace_id)}"}}'
                         f" {_fmt(value)}")
            lines.append(line)
        ls = _label_str(self.label_names, key)
        lines.append(f"{self.name}_sum{ls} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{ls} {child.count}")

    def _dump_series(self, key, child):
        cum, buckets = 0, {}
        for b, cnt in zip(self.buckets, child.counts):
            cum += cnt
            buckets[_fmt(b)] = cum
        buckets["+Inf"] = cum + child.counts[-1]
        out = {"labels": dict(zip(self.label_names, key)),
               "buckets": buckets, "sum": float(child.sum),
               "count": int(child.count)}
        if child.exemplars:
            bounds = tuple(_fmt(b) for b in self.buckets) + ("+Inf",)
            out["exemplars"] = {
                bounds[i]: {"value": v, "trace_id": t}
                for i, (v, t) in sorted(child.exemplars.items())}
        return out


class MetricsRegistry:
    """Thread-safe name -> family registry. Re-registering an existing
    name returns the existing family (label names and kind must match —
    instrumented call sites are the declaration)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, label_names, **kw):
        label_names = tuple(label_names)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, label_names, **kw)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.type_name}, not {cls.type_name}")
        if fam.label_names != label_names:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.label_names}, not {label_names}")
        if "buckets" in kw \
                and fam.buckets != Histogram._normalize_buckets(
                    kw["buckets"]):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam.buckets}, not {tuple(kw['buckets'])}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def prometheus_text(self) -> str:
        """The full registry in Prometheus text exposition format v0.0.4
        (families sorted by name, children by label values)."""
        with self._lock:
            fams = sorted(self._families.items())
        lines: List[str] = []
        for _, fam in fams:
            fam._render(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def openmetrics_text(self) -> str:
        """The registry in OpenMetrics 1.0 text format — the opt-in
        exposition behind ``GET /metrics?format=openmetrics``. Three
        deliberate differences from `prometheus_text()` (which stays
        byte-identical): counter families are declared without the
        ``_total`` suffix (samples keep it), histogram bucket lines
        carry ``# {trace_id="..."} value`` exemplars where one was
        observed, and the stream ends with ``# EOF``."""
        with self._lock:
            fams = sorted(self._families.items())
        lines: List[str] = []
        for _, fam in fams:
            fam._render_om(lines)
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def raw_sample(self) -> Tuple[dict, dict]:
        """Compact numeric snapshot for monitor/timeseries.py's ring.

        Returns ``(meta, values)``: ``meta`` maps family name ->
        ``(type_name, label_names, buckets_or_None)``; ``values`` maps
        ``(family, label_values)`` -> the child's raw state (float for
        counters/gauges, ``(bucket_counts, sum, count)`` for
        histograms). Cheaper than dump() — no cumulative re-render, no
        per-series dicts — because the ring stores hundreds of these.
        """
        with self._lock:
            fams = list(self._families.items())
        meta: Dict[str, tuple] = {}
        values: Dict[Tuple[str, Tuple[str, ...]], object] = {}
        for name, fam in fams:
            meta[name] = (fam.type_name, fam.label_names,
                          getattr(fam, "buckets", None))
            with fam._lock:
                for key, child in fam._children.items():
                    values[(name, key)] = fam._raw_value(child)
        return meta, values

    def dump(self) -> dict:
        """Full structured view: {name: {type, help, series: [...]}}.
        Histogram series carry cumulative buckets plus sum/count."""
        with self._lock:
            fams = sorted(self._families.items())
        out = {}
        for name, fam in fams:
            with fam._lock:
                series = [fam._dump_series(k, c)
                          for k, c in sorted(fam._children.items())]
            out[name] = {"type": fam.type_name, "help": fam.help,
                         "series": series}
        return out

    def summary(self) -> dict:
        """Compact scalar view for CLI/smoke reports: counters and gauges
        collapse to their value (label-joined keys), histograms to
        count/sum/mean."""
        out = {}
        for name, fam in self.dump().items():
            for s in fam["series"]:
                key = name
                if s["labels"]:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(s["labels"].items())
                    ) + "}"
                if fam["type"] == "histogram":
                    n = s["count"]
                    out[key] = {"count": n, "sum": round(s["sum"], 6),
                                "mean": round(s["sum"] / n, 6) if n else 0.0}
                else:
                    out[key] = s["value"]
        return out

    def collect(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self):
        """Drop every registered family (tests)."""
        with self._lock:
            self._families.clear()


#: process-global default registry — everything in-tree records here, and
#: UIServer's /metrics route serves it.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets=buckets)


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def openmetrics_text() -> str:
    return REGISTRY.openmetrics_text()


def dump() -> dict:
    return REGISTRY.dump()


def summary() -> dict:
    return REGISTRY.summary()
