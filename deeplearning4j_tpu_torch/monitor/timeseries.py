"""In-process metrics time-series: the windowed-evidence layer.

``GET /metrics`` is a point-in-time snapshot; every verdict the serving
stack wants to render — error rate over the last five minutes, p99 over
the last hour, "is this replica burning its error budget" — needs
*windows*. This module keeps a bounded ring of periodic registry
snapshots (`metrics.MetricsRegistry.raw_sample()`) and computes windowed
views over it:

- counter series -> `increase()` / `rate()` with Prometheus-style
  counter-reset handling (a restarted replica's counter restarts at
  zero; the window must not go negative, and the post-reset value
  counts in full);
- gauge series -> `gauge_stats()` last/min/max/avg over the window;
- histogram series -> windowed `percentile()` via bucket-delta
  interpolation and `fraction_le()` — the "what share of requests beat
  the latency threshold" primitive `monitor/slo.py` objectives read.

Sampling is either manual (`ring.sample()` — tests drive it on a fake
clock) or periodic via one named daemon thread (`ring.start()`).
Listeners registered with `add_listener` run after every sample; the
SLO engine evaluates its burn-rate rules there, so alerting latency
equals one sampling interval.

Zero-cost-when-disabled is the same hard contract as `span()` and the
flight recorder: nothing here runs until an operator calls
`enable_timeseries()` (or passes an ``--slo-*`` flag) — no sampler
thread, and never any per-request work: the ring only ever *reads* the
registry on its own schedule; the request path is untouched either way.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.monitor import metrics

log = logging.getLogger("deeplearning4j_tpu_torch")


def _bucket_quantile(bounds, counts, q: float) -> Optional[float]:
    """Quantile q (0..1) from non-cumulative bucket counts (`+Inf`
    last) by linear interpolation inside the landing bucket; a quantile
    landing in `+Inf` clamps to the last finite bound — the same
    convention as Prometheus `histogram_quantile`."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum, lo = 0.0, 0.0
    for i, hi in enumerate(bounds):
        nxt = cum + counts[i]
        if rank <= nxt and counts[i] > 0:
            frac = (rank - cum) / counts[i]
            return lo + (hi - lo) * frac
        cum = nxt
        lo = hi
    return float(bounds[-1])


def _fraction_le(bounds, counts, threshold: float) -> Optional[float]:
    """Share of observations <= threshold from non-cumulative bucket
    counts, linearly interpolated within the straddling bucket. The
    `+Inf` bucket never counts as under any finite threshold."""
    total = sum(counts)
    if total <= 0:
        return None
    cum, lo = 0.0, 0.0
    for i, hi in enumerate(bounds):
        if threshold >= hi:
            cum += counts[i]
            lo = hi
            continue
        if threshold > lo and hi > lo:
            cum += counts[i] * (threshold - lo) / (hi - lo)
        break
    return min(1.0, cum / total)


class TimeSeriesRing:
    """Bounded ring of periodic registry snapshots plus windowed
    queries over them.

    `time_fn` (monotonic; all window math) and `wall_fn` (unix stamps
    on query documents) are injectable: unit tests advance a fake clock
    and call `sample()` by hand — no sleeps, no threads. Defaults
    (interval 5s, capacity 720) hold one hour of history in roughly
    sub-MB of floats for the in-tree family count.
    """

    def __init__(self, registry: Optional[metrics.MetricsRegistry] = None,
                 interval_s: float = 5.0, capacity: int = 720,
                 time_fn: Callable[[], float] = time.monotonic,
                 wall_fn: Callable[[], float] = time.time):
        self.registry = registry if registry is not None else metrics.REGISTRY
        self.interval_s = float(interval_s)
        self.capacity = max(2, int(capacity))
        self._time = time_fn
        self._wall = wall_fn
        self._lock = threading.Lock()
        #: (monotonic, unix, {(family, label_values): raw}), newest last
        self._samples: deque = deque(maxlen=self.capacity)
        #: family -> (type_name, label_names, buckets|None); latest wins
        self._meta: Dict[str, tuple] = {}
        self._listeners: List[Callable[[], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ sampling
    def add_listener(self, fn: Callable[[], None]):
        """Run `fn()` after every sample (the SLO engine's evaluation
        hook). A failing listener is logged, never fatal to sampling."""
        with self._lock:
            self._listeners.append(fn)

    def sample(self):
        """Snapshot the registry NOW (on the injected clock) and notify
        listeners."""
        t0 = time.perf_counter()
        meta, values = self.registry.raw_sample()
        with self._lock:
            self._meta.update(meta)
            self._samples.append((self._time(), self._wall(), values))
            listeners = list(self._listeners)
        metrics.counter(
            "timeseries_samples_total",
            "Registry snapshots taken into the time-series ring").inc()
        metrics.gauge(
            "timeseries_series",
            "Labeled series captured in the newest time-series sample",
        ).set(len(values))
        metrics.histogram(
            "timeseries_sample_seconds",
            "Wall time to snapshot the registry into the ring").observe(
            time.perf_counter() - t0)
        for fn in listeners:
            try:
                fn()
            except Exception:    # noqa: BLE001 — a broken listener (SLO
                # evaluation) must not stop the sampler
                log.exception("timeseries: sample listener failed")

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:                # noqa: BLE001 — keep sampling
                log.exception("timeseries: sample failed")

    def start(self):
        """Start the periodic sampler daemon (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(target=self._run, daemon=True,
                                 name="timeseries-sampler")
            self._thread = t
        t.start()

    def stop(self, timeout: float = 5.0):
        """Stop and join the sampler (no-op when not started)."""
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop.set()
        if t is not None:
            t.join(timeout)

    # ------------------------------------------------------------- queries
    def meta(self, family: str) -> Optional[tuple]:
        with self._lock:
            return self._meta.get(family)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._meta)

    def describe(self) -> dict:
        """Ring shape + coverage (the no-arg GET /v1/timeseries doc)."""
        with self._lock:
            n = len(self._samples)
            span = (self._samples[-1][0] - self._samples[0][0]
                    if n >= 2 else 0.0)
            names = sorted(self._meta)
        return {"interval_s": self.interval_s, "capacity": self.capacity,
                "samples": n, "span_s": round(span, 3), "series": names}

    def _window(self, window_s: float) -> List[tuple]:
        cutoff = self._time() - float(window_s)
        with self._lock:
            return [s for s in self._samples if s[0] >= cutoff]

    def _match_index(self, label_names, match: Dict[str, str]):
        """(position, wanted) filters for a partial label match; {}
        matches every child, an unknown label name matches nothing
        (None)."""
        idx = []
        for name, want in match.items():
            if name not in label_names:
                return None
            idx.append((label_names.index(name), str(want)))
        return idx

    def _counter_deltas(self, family: str, window_s: float,
                        match: Dict[str, str]):
        """{label_values: increase} over the window plus the window's
        covered seconds; (None, None) when the family is unknown / not
        a counter / matches no label or the window holds < 2 samples.

        Reset handling is per consecutive sample pair and per series: a
        value that dropped means the process restarted, so the post-
        reset value counts in full; a series absent from the previous
        sample is a baseline (contributes nothing yet).
        """
        m = self.meta(family)
        if m is None or m[0] != "counter":
            return None, None
        idx = self._match_index(m[1], match)
        if idx is None:
            return None, None
        samples = self._window(window_s)
        if len(samples) < 2:
            return None, None
        inc: Dict[tuple, float] = {}
        prev = None
        for _, _, values in samples:
            for (name, key), val in values.items():
                if name != family:
                    continue
                if any(key[i] != want for i, want in idx):
                    continue
                if prev is not None and (family, key) in prev:
                    pv = prev[(family, key)]
                    inc[key] = inc.get(key, 0.0) + (
                        val - pv if val >= pv else val)   # counter reset
                else:
                    inc.setdefault(key, 0.0)
            prev = values
        return inc, samples[-1][0] - samples[0][0]

    def increase(self, family: str, window_s: float,
                 **match) -> Optional[float]:
        """Total windowed counter increase across matching children."""
        inc, _ = self._counter_deltas(family, window_s, match)
        return None if inc is None else sum(inc.values())

    def rate(self, family: str, window_s: float, **match) -> Optional[float]:
        """Windowed per-second rate (increase over covered seconds)."""
        inc, elapsed = self._counter_deltas(family, window_s, match)
        if inc is None or not elapsed:
            return None
        return sum(inc.values()) / elapsed

    def increase_by(self, family: str, window_s: float, by: str,
                    **match) -> Optional[Dict[str, float]]:
        """Windowed increase grouped by one label's values — the
        availability objective's per-status-code view."""
        m = self.meta(family)
        if m is None or by not in m[1]:
            return None
        inc, _ = self._counter_deltas(family, window_s, match)
        if inc is None:
            return None
        pos = m[1].index(by)
        out: Dict[str, float] = {}
        for key, delta in inc.items():
            out[key[pos]] = out.get(key[pos], 0.0) + delta
        return out

    def gauge_stats(self, family: str, window_s: float,
                    **match) -> Optional[dict]:
        """last/min/max/avg of the matching children's sum, per sample,
        over the window."""
        m = self.meta(family)
        if m is None or m[0] != "gauge":
            return None
        idx = self._match_index(m[1], match)
        if idx is None:
            return None
        points = []
        for _, _, values in self._window(window_s):
            total, seen = 0.0, False
            for (name, key), val in values.items():
                if name != family:
                    continue
                if any(key[i] != want for i, want in idx):
                    continue
                total += val
                seen = True
            if seen:
                points.append(total)
        if not points:
            return None
        return {"last": points[-1], "min": min(points), "max": max(points),
                "avg": sum(points) / len(points), "samples": len(points)}

    def hist_window(self, family: str, window_s: float,
                    **match) -> Optional[dict]:
        """Windowed histogram: per-bucket observation deltas summed
        across matching children, reset-safe (a child whose total count
        dropped restarted — its current counts ARE the delta). Returns
        {"bounds", "counts" (non-cumulative, +Inf last), "count",
        "sum"}; None without >= 2 samples or any windowed observation."""
        m = self.meta(family)
        if m is None or m[0] != "histogram":
            return None
        idx = self._match_index(m[1], match)
        if idx is None:
            return None
        samples = self._window(window_s)
        if len(samples) < 2:
            return None
        bounds = m[2]
        agg = [0.0] * (len(bounds) + 1)
        total_sum = 0.0
        prev = None
        for _, _, values in samples:
            for (name, key), val in values.items():
                if name != family:
                    continue
                if any(key[i] != want for i, want in idx):
                    continue
                if prev is None or (family, key) not in prev:
                    continue                      # baseline sample
                pcounts, psum, pcount = prev[(family, key)]
                counts, vsum, vcount = val
                if vcount < pcount:               # restart: post-reset
                    deltas, dsum = counts, vsum   # counts count in full
                else:
                    deltas = [max(0, c - p)
                              for c, p in zip(counts, pcounts)]
                    dsum = vsum - psum
                for i, d in enumerate(deltas):
                    agg[i] += d
                total_sum += dsum
            prev = values
        count = sum(agg)
        if count <= 0:
            return None
        return {"bounds": tuple(bounds), "counts": agg,
                "count": count, "sum": total_sum}

    def percentile(self, family: str, window_s: float, q: float,
                   **match) -> Optional[float]:
        """Windowed quantile (q in [0, 100]) over matching children."""
        win = self.hist_window(family, window_s, **match)
        if win is None:
            return None
        return _bucket_quantile(win["bounds"], win["counts"], q / 100.0)

    def fraction_le(self, family: str, window_s: float, threshold: float,
                    **match) -> Optional[float]:
        """Share of windowed observations <= threshold — the latency
        objective's good fraction."""
        win = self.hist_window(family, window_s, **match)
        if win is None:
            return None
        return _fraction_le(win["bounds"], win["counts"], float(threshold))

    def query(self, family: str, window_s: float, **match) -> dict:
        """The GET /v1/timeseries document for one series: a typed
        windowed view (counter -> increase/rate, gauge -> stats,
        histogram -> count/rate/percentiles)."""
        doc = {"series": family, "window_s": float(window_s),
               "now_unix": round(self._wall(), 3)}
        if match:
            doc["match"] = dict(match)
        m = self.meta(family)
        if m is None:
            doc["error"] = "unknown series"
            return doc
        kind, label_names, _ = m
        doc["kind"] = kind
        doc["labels"] = list(label_names)
        if kind == "counter":
            inc, elapsed = self._counter_deltas(family, window_s, match)
            if inc is None or not elapsed:
                doc["increase"] = doc["rate_per_s"] = None
            else:
                total = sum(inc.values())
                doc["increase"] = round(total, 6)
                doc["rate_per_s"] = round(total / elapsed, 6)
        elif kind == "gauge":
            stats = self.gauge_stats(family, window_s, **match)
            doc["stats"] = stats and {k: round(v, 6) if k != "samples"
                                      else v for k, v in stats.items()}
        else:
            win = self.hist_window(family, window_s, **match)
            if win is None:
                doc["count"] = 0
            else:
                doc["count"] = round(win["count"], 6)
                doc["sum"] = round(win["sum"], 6)
                for q in (50, 95, 99):
                    p = _bucket_quantile(win["bounds"], win["counts"],
                                         q / 100.0)
                    doc[f"p{q}"] = None if p is None else round(p, 6)
        return doc


# -------------------------------------------------------------------------
# process-default ring — the zero-cost-when-disabled seam. Nothing exists
# (no ring, no thread) until enable_timeseries(); endpoints answer
# {"enabled": false} while default_ring() is None.
_module_lock = threading.Lock()
_ring: Optional[TimeSeriesRing] = None


def enable_timeseries(interval_s: float = 5.0, capacity: int = 720,
                      registry: Optional[metrics.MetricsRegistry] = None,
                      time_fn: Callable[[], float] = time.monotonic,
                      wall_fn: Callable[[], float] = time.time,
                      autostart: bool = True) -> TimeSeriesRing:
    """Create (or return) the process-default ring. With `autostart`
    the named sampler daemon starts immediately; tests pass
    autostart=False and drive `sample()` on a fake clock."""
    global _ring
    with _module_lock:
        if _ring is None:
            _ring = TimeSeriesRing(registry=registry, interval_s=interval_s,
                                   capacity=capacity, time_fn=time_fn,
                                   wall_fn=wall_fn)
        ring = _ring
    if autostart:
        ring.start()
    return ring


def disable_timeseries():
    """Stop the sampler and drop the default ring (idempotent). Call
    `slo.disable_slo()` first when an engine is attached — a live
    engine keeps evaluating on whatever ring it holds."""
    global _ring
    with _module_lock:
        ring = _ring
        _ring = None
    if ring is not None:
        ring.stop()


def timeseries_enabled() -> bool:
    return _ring is not None


def default_ring() -> Optional[TimeSeriesRing]:
    """The process-default ring, or None while disabled."""
    return _ring
