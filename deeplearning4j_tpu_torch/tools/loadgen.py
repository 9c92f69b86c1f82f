"""Load generator for the serving HTTP surface: the parts of the JAX
package's `tools/serve_loadgen.py` that the fleet drills drive.

Closed loop (`LoadGen.run_closed`): N worker threads each keep one
predict in flight. A closed-loop client is a *polite* client: on 429/503
it honours the server's ``Retry-After`` hint (jittered server-side so
shed clients do not stampede back in step) before retrying, up to
``max_retries`` per logical request. Ramp (`LoadGen.run_ramp`): a stepped
open-loop schedule, each step at its own fixed arrival rate, with an
optional sampler of the router's ``/v1/fleet`` (ready replicas over
time — the autoscaling drill's evidence). Open-loop requests never
retry: an offered request is an offered request.

Priority classes: a ``priority_mix`` like ``{"interactive": 3, "batch":
1}`` tags requests with ``X-Priority`` headers in a deterministic
weighted cycle; the report breaks latency and outcomes down per class.

The knobs come in as attributes of an ``args`` object (``url``,
``model``, ``requests``, ``concurrency``, ``batch_sizes``,
``priority_mix``, ``max_retries``, ``retry_cap_s``, ``deadline_ms``,
``timeout_s``, ``seed``; ``rate`` is read by the report only). Two are
the port's own, both optional: ``vocab`` makes the inputs integer token
ids in ``[0, vocab)`` (an LM's predict input) instead of uniform floats,
and ``npy`` sends and accepts ``.npy`` bodies (``application/
octet-stream``) instead of JSON — the format for a full-width LM, whose
logits would be hundreds of MB of JSON.
"""
from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def calibrate(trials: int = 9) -> float:
    """Machine-speed reference: median wall-ms of a FIXED numpy f32 matmul
    workload, the JAX package's drills' ``calib_cpu_ms``. Nothing in the
    serving code can move it, only the host."""
    a = np.random.RandomState(0).rand(384, 384).astype(np.float32)
    b = np.random.RandomState(1).rand(384, 384).astype(np.float32)
    samples = []
    with np.errstate(over="ignore", invalid="ignore"):   # values blow up
        for _ in range(trials):
            t0 = time.perf_counter()
            c = a
            for _ in range(20):
                c = c @ b
            float(c[0, 0])          # force materialization
            samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return round(samples[len(samples) // 2], 3)


def mint_traceparent():
    """(trace_id, traceparent header) minted client-side — the origin of
    the request's cross-process trace."""
    trace_id = os.urandom(16).hex()
    return trace_id, f"00-{trace_id}-{os.urandom(8).hex()}-01"


def percentile(xs, p):
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[i]


def classify(code) -> str:
    """Error taxonomy: what *kind* of failure (or backpressure) was it."""
    if isinstance(code, int):
        if 200 <= code < 300:
            return "ok"
        if code == 429:
            return "shed_429"
        if code == 503:
            return "unavailable_503"
        if code == 504:
            return "deadline_504"
        if 500 <= code < 600:
            return "server_5xx"
        return f"client_{code}"
    return "transport"


def _latency_stats(lat_s):
    ms = [v * 1e3 for v in lat_s]
    return {
        "p50": round(percentile(ms, 50), 3) if ms else None,
        "p90": round(percentile(ms, 90), 3) if ms else None,
        "p99": round(percentile(ms, 99), 3) if ms else None,
        "max": round(max(ms), 3) if ms else None,
    }


def parse_priority_mix(spec):
    """``interactive=3,batch=1`` -> {"interactive": 3, "batch": 1}."""
    if not spec:
        return {}
    mix = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition("=")
        try:
            mix[name.strip()] = int(w) if sep else 1
        except ValueError:
            raise SystemExit(
                f"--priority-mix expects CLASS=WEIGHT, got {part!r}") from None
        if mix[name.strip()] < 1:
            raise SystemExit(f"--priority-mix weight must be >= 1: {part!r}")
    return mix


class LoadGen:
    def __init__(self, args, input_shape):
        self.args = args
        self.input_shape = tuple(input_shape or ())
        self.url = (f"{args.url}/v1/models/{args.model}/predict"
                    + (f"?deadline_ms={args.deadline_ms}"
                       if args.deadline_ms else ""))
        self.lock = threading.Lock()
        self.latencies = {}             # class -> [seconds], 2xx only
        self.traced = {}                # class -> [(seconds, trace_id)]
        self.slow_k = int(getattr(args, "slow_k", 3) or 0)
        self.codes = {}
        self.class_codes = {}           # class -> {taxonomy: count}
        self.retries = 0
        self.retry_wait_s = 0.0
        self.issued = 0        # logical requests, across every run_* call
        self.rs = np.random.RandomState(args.seed)
        vocab = getattr(args, "vocab", None)
        self.npy = bool(getattr(args, "npy", False))
        self.bodies = []
        for b in (args.batch_sizes or [1]):
            if vocab:
                x = self.rs.randint(0, int(vocab), (b, *self.input_shape))
            else:
                x = self.rs.rand(b, *self.input_shape)
            x = x.astype("float32")
            if self.npy:
                buf = io.BytesIO()
                np.save(buf, x)
                self.bodies.append(buf.getvalue())
            else:
                self.bodies.append(json.dumps({"inputs": x.tolist()}).encode())
        # deterministic weighted cycle of priority classes (None = no
        # header) so runs are reproducible request-for-request
        mix = args.priority_mix or {}
        self.class_cycle = [c for c, w in sorted(mix.items())
                            for _ in range(w)] or [None]

    def _class_of(self, i: int):
        return self.class_cycle[i % len(self.class_cycle)]

    def _send(self, i: int, traceparent=None):
        """One HTTP attempt: (code_or_0, latency_s, retry_after_or_None)."""
        body = self.bodies[i % len(self.bodies)]
        if self.npy:
            headers = {"Content-Type": "application/octet-stream",
                       "Accept": "application/octet-stream"}
        else:
            headers = {"Content-Type": "application/json"}
        cls = self._class_of(i)
        if cls is not None:
            headers["X-Priority"] = cls
        if traceparent is not None:
            headers["traceparent"] = traceparent
        t0 = time.perf_counter()
        retry_after = None
        try:
            r = urllib.request.urlopen(urllib.request.Request(
                self.url, data=body, headers=headers),
                timeout=self.args.timeout_s)
            code = r.status
            r.read()
        except urllib.error.HTTPError as e:
            code = e.code
            retry_after = e.headers.get("Retry-After")
            e.read()
        except Exception:               # noqa: BLE001 — refused/reset/timeout
            code = 0
        return code, time.perf_counter() - t0, retry_after

    def _record(self, i: int, code, dt: float, trace_id=None):
        cls = self._class_of(i) or "default"
        kind = classify(code if code != 0 else "transport")
        with self.lock:
            key = code if code != 0 else "transport"
            self.codes[key] = self.codes.get(key, 0) + 1
            self.class_codes.setdefault(cls, {})
            self.class_codes[cls][kind] = \
                self.class_codes[cls].get(kind, 0) + 1
            if isinstance(code, int) and 200 <= code < 300:
                self.latencies.setdefault(cls, []).append(dt)
                if trace_id is not None:
                    self.traced.setdefault(cls, []).append((dt, trace_id))

    def _attempt(self, i: int, traceparent=None, trace_id=None):
        code, dt, retry_after = self._send(i, traceparent)
        self._record(i, code, dt, trace_id=trace_id)
        return code, retry_after

    def one_closed(self, i: int) -> bool:
        """One logical request, honouring Retry-After backpressure. Every
        ATTEMPT is recorded in the code histogram; True iff the request
        ultimately succeeded. All attempts share ONE client-minted trace
        id."""
        with self.lock:
            self.issued += 1
        trace_id, traceparent = mint_traceparent()
        attempts = 0
        while True:
            code, retry_after = self._attempt(i, traceparent, trace_id)
            if isinstance(code, int) and 200 <= code < 300:
                return True
            if code not in (429, 503) or attempts >= self.args.max_retries:
                return False
            attempts += 1
            try:
                wait = min(float(retry_after), self.args.retry_cap_s) \
                    if retry_after else 0.1
            except ValueError:
                wait = 0.1
            with self.lock:
                self.retries += 1
                self.retry_wait_s += wait
            time.sleep(wait)

    def one_open(self, i: int) -> bool:
        with self.lock:
            self.issued += 1
        trace_id, traceparent = mint_traceparent()
        code, _ = self._attempt(i, traceparent, trace_id)
        return isinstance(code, int) and 200 <= code < 300

    def run_closed(self):
        n = self.args.requests
        counter = iter(range(n))
        counter_lock = threading.Lock()
        ok = [0]

        def worker():
            try:
                while True:
                    with counter_lock:
                        i = next(counter, None)
                    if i is None:
                        return
                    if self.one_closed(i):
                        with self.lock:
                            ok[0] += 1
            except Exception as e:          # noqa: BLE001 — fail loud:
                # a crashed worker silently shrinks concurrency and
                # undercounts; the report must say why
                print(f"loadgen: worker crashed: {e!r}", file=sys.stderr)
                raise

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"loadgen-worker-{w}")
                   for w in range(self.args.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0, ok[0]

    def run_ramp(self, steps, fleet_url=None, sample_interval_s=1.0):
        """Stepped open-loop schedule: ``steps`` is [(rate_rps, secs),
        ...]; each step fires at its own fixed arrival rate. With
        ``fleet_url``, a sampler thread polls ``/v1/fleet`` alongside and
        records the ready-replica count over time."""
        threads = []
        ok = [0]
        samples = []
        current_rate = [0.0]
        stop = threading.Event()

        def fire(i):
            try:
                if self.one_open(i):
                    with self.lock:
                        ok[0] += 1
            except Exception as e:          # noqa: BLE001 — fail loud
                print(f"loadgen: ramp request {i} crashed: {e!r}",
                      file=sys.stderr)
                raise

        t0 = time.perf_counter()

        def sample_fleet():
            while not stop.wait(sample_interval_s):
                doc = {}
                try:
                    doc = json.loads(urllib.request.urlopen(
                        f"{fleet_url}/v1/fleet", timeout=5).read())
                except Exception as e:      # noqa: BLE001 — a missed
                    # sample is a gap in the chart, not a run failure
                    print(f"loadgen: fleet sample failed: {e!r}",
                          file=sys.stderr)
                reps = doc.get("replicas", [])
                samples.append({
                    "t_s": round(time.perf_counter() - t0, 1),
                    "offered_rps": current_rate[0],
                    "ready": sum(1 for r in reps
                                 if r.get("state") == "ready"),
                    "draining": sum(1 for r in reps
                                    if r.get("state") == "draining"),
                    "replicas": len(reps)})

        sampler = None
        if fleet_url:
            sampler = threading.Thread(target=sample_fleet, daemon=True,
                                       name="loadgen-fleet-sampler")
            sampler.start()
        i = 0
        for rate, dur in steps:
            current_rate[0] = rate
            period = 1.0 / rate
            step_start = time.perf_counter()
            for k in range(max(1, int(rate * dur))):
                target = step_start + k * period
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                t = threading.Thread(target=fire, args=(i,), daemon=True,
                                     name=f"loadgen-ramp-{i}")
                t.start()
                threads.append(t)
                i += 1
        for t in threads:
            t.join(timeout=self.args.timeout_s + 5)
        stop.set()
        if sampler is not None:
            sampler.join(timeout=sample_interval_s + 5)
        self.replica_samples = samples
        self.ramp_steps = [{"rate_rps": r, "seconds": d}
                           for r, d in steps]
        return time.perf_counter() - t0, ok[0]

    def report(self, wall: float, ok: int) -> dict:
        all_lat = [v for lats in self.latencies.values() for v in lats]
        taxonomy = {}
        for cls_counts in self.class_codes.values():
            for kind, cnt in cls_counts.items():
                taxonomy[kind] = taxonomy.get(kind, 0) + cnt
        ramp = getattr(self, "ramp_steps", None)
        rep = {
            "mode": "ramp" if ramp
            else ("open" if getattr(self.args, "rate", None) else "closed"),
            "workload": "predict",
            # issued, not args.requests: callers accumulate several
            # run_closed() passes into one LoadGen/report
            "requests": self.issued,
            "ok": ok,
            "errors": self.issued - ok,
            "codes": {str(k): v for k, v in sorted(
                self.codes.items(), key=lambda kv: str(kv[0]))},
            "error_classes": dict(sorted(taxonomy.items())),
            "retries": self.retries,
            "retry_wait_s": round(self.retry_wait_s, 3),
            "wall_s": round(wall, 3),
            "goodput_rps": round(ok / wall, 2) if wall > 0 else None,
            "latency_ms": _latency_stats(all_lat),
        }
        if ramp:
            rep["ramp"] = ramp
            rep["replicas_over_time"] = getattr(self, "replica_samples",
                                                [])
        if self.slow_k > 0:
            # the K slowest successful requests per class, by trace_id
            rep["slowest"] = {
                cls: [{"trace_id": t, "ms": round(lat * 1e3, 3)}
                      for lat, t in sorted(pairs, reverse=True)
                      [:self.slow_k]]
                for cls, pairs in sorted(self.traced.items())}
        if len(self.class_cycle) > 1 or self.class_cycle[0] is not None:
            rep["per_class"] = {
                cls: {"latency_ms": _latency_stats(
                          self.latencies.get(cls, [])),
                      "outcomes": dict(sorted(counts.items()))}
                for cls, counts in sorted(self.class_codes.items())}
        return rep
