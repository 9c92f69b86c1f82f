"""Load generator for the serving HTTP surface: the parts of the JAX
package's `tools/serve_loadgen.py` that the fleet drills and the decode
smoke drive.

Closed loop (`LoadGen.run_closed`): N worker threads each keep one
predict in flight. A closed-loop client is a *polite* client: on 429/503
it honours the server's ``Retry-After`` hint (jittered server-side so
shed clients do not stampede back in step) before retrying, up to
``max_retries`` per logical request. Ramp (`LoadGen.run_ramp`): a stepped
open-loop schedule, each step at its own fixed arrival rate, with an
optional sampler of the router's ``/v1/fleet`` (ready replicas over
time — the autoscaling drill's evidence). Open-loop requests never
retry: an offered request is an offered request.

Decode (``args.mode == "decode"``): each logical request is one SSE
stream of the generate surface, consumed token by token; the report adds
TTFT, inter-token gaps and tokens/sec, overall and per class, and with a
``prefix_mix`` (``{"shared": 3, "unique": 1}``: shared prompts open with
one common ``shared_prefix_len`` prefix) the prefix cache's hit rate and
hot/cold TTFT, per replica when a router names it (``X-Served-By``). A
stream truncated before its ``done`` event counts as a transport
failure, never as success.

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


def _spec_cols(st):
    """Speculative-decoding columns from summed done-event counters:
    acceptance rate (accepted / proposed draft tokens) and tokens per
    verify round (each round emits accepted + 1)."""
    return {
        "spec_streams": st["streams"],
        "spec_acceptance_rate": round(st["accepted"] / st["proposed"], 4)
        if st["proposed"] else None,
        "spec_accepted_per_step": round(
            (st["accepted"] + st["rounds"]) / st["rounds"], 4)
        if st["rounds"] else None,
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
        self.mode = getattr(args, "mode", "predict") or "predict"
        self.input_shape = tuple(input_shape or ())
        verb = "generate" if self.mode == "decode" else "predict"
        self.url = (f"{args.url}/v1/models/{args.model}/{verb}"
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
        if self.mode == "decode":
            self.vocab = int(getattr(args, "vocab", None) or 0)
            if self.vocab < 2:
                raise SystemExit("--mode decode needs --vocab (or a "
                                 "servable describing vocab_size)")
            # shared/unique-prefix workload: a deterministic weighted
            # cycle of prefix classes; "shared" prompts open with ONE
            # common prefix (the system-prompt shape the server's KV
            # prefix cache exists for) + a per-request unique suffix,
            # every other class gets a fully unique prompt
            self.prefix_mix = dict(getattr(args, "prefix_mix", None)
                                   or {})
            self.prefix_cycle = [c for c, w in sorted(
                self.prefix_mix.items()) for _ in range(w)] or [None]
            shared_len = int(getattr(args, "shared_prefix_len", None)
                             or (2 * args.prompt_len) // 3)
            if self.prefix_mix:
                if not 0 < shared_len < args.prompt_len:
                    raise SystemExit(
                        f"--shared-prefix-len must be in (0, "
                        f"{args.prompt_len}); got {shared_len}")
                shared_prefix = self.rs.randint(
                    0, self.vocab, shared_len).tolist()

                def prompt_for(i):
                    if self.prefix_cycle[i % len(self.prefix_cycle)] \
                            == "shared":
                        return shared_prefix + self.rs.randint(
                            0, self.vocab,
                            args.prompt_len - shared_len).tolist()
                    return self.rs.randint(
                        0, self.vocab, args.prompt_len).tolist()

                n_bodies = args.requests
            else:
                def prompt_for(i):
                    return self.rs.randint(
                        0, self.vocab, args.prompt_len).tolist()

                n_bodies = 16           # a cycle of distinct prompts
            self.bodies = [
                json.dumps({
                    "prompt": prompt_for(i),
                    "max_tokens": args.max_new_tokens,
                    "temperature": args.temperature,
                    "top_k": args.top_k,
                    "stream": True,
                }).encode()
                for i in range(n_bodies)
            ]
            self.ttfts = {}             # class -> [seconds]
            self.itls = {}              # class -> [seconds] between tokens
            self.tokens = 0
            self.prefix_stats = {}      # prefix class -> counters/ttfts
            self.replica_stats = {}     # X-Served-By -> requests/hits
            # speculative-decoding counters per class, read off the done
            # event (0/0/0 streams on a plain servable stay comparable)
            self.spec_stats = {}        # class -> proposed/accepted/rounds
        else:
            for b in (args.batch_sizes or [1]):
                if vocab:
                    x = self.rs.randint(0, int(vocab),
                                        (b, *self.input_shape))
                else:
                    x = self.rs.rand(b, *self.input_shape)
                x = x.astype("float32")
                if self.npy:
                    buf = io.BytesIO()
                    np.save(buf, x)
                    self.bodies.append(buf.getvalue())
                else:
                    self.bodies.append(
                        json.dumps({"inputs": x.tolist()}).encode())
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

    def _send_decode(self, i: int, traceparent=None):
        """One token-stream attempt: consume the SSE response as tokens
        arrive, measuring TTFT and every inter-token gap. A stream that
        never reaches its ``done`` event counts as a transport failure —
        truncated generations must not read as success."""
        body = self.bodies[i % len(self.bodies)]
        headers = {"Content-Type": "application/json"}
        cls = self._class_of(i)
        if cls is not None:
            headers["X-Priority"] = cls
        if traceparent is not None:
            headers["traceparent"] = traceparent
        t0 = time.perf_counter()
        retry_after = None
        ttft, itls, ntok, last, done = None, [], 0, None, False
        cached = spec = served = None
        try:
            r = urllib.request.urlopen(urllib.request.Request(
                self.url, data=body, headers=headers),
                timeout=self.args.timeout_s)
            # fleet mode: the router names the replica that took the
            # stream — the per-replica cache-hit split keys off it
            served = r.headers.get("X-Served-By")
            for line in r:
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                now = time.perf_counter()
                if "token" in ev:
                    ntok += 1
                    if ttft is None:
                        ttft = now - t0
                    else:
                        itls.append(now - last)
                    last = now
                elif ev.get("done"):
                    done = True
                    cached = ev.get("cached_tokens")
                    if ev.get("spec_rounds") is not None:
                        spec = (int(ev.get("spec_proposed") or 0),
                                int(ev.get("spec_accepted") or 0),
                                int(ev.get("spec_rounds") or 0))
                elif "error" in ev:
                    break
            code = r.status if done else 0
        except urllib.error.HTTPError as e:
            code = e.code
            retry_after = e.headers.get("Retry-After")
            e.read()
        except Exception:               # connection refused/reset, timeout
            code = 0
        return (code, time.perf_counter() - t0, retry_after, ttft, itls,
                ntok, cached, spec, served)

    def _record(self, i: int, code, dt: float, ttft=None, itls=(),
                ntok: int = 0, trace_id=None, cached=None, spec=None,
                served=None):
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
                if self.mode == "decode":
                    self.tokens += ntok
                    if ttft is not None:
                        self.ttfts.setdefault(cls, []).append(ttft)
                    if itls:
                        self.itls.setdefault(cls, []).extend(itls)
                    if spec is not None:
                        st = self.spec_stats.setdefault(
                            cls, {"streams": 0, "proposed": 0,
                                  "accepted": 0, "rounds": 0})
                        st["streams"] += 1
                        st["proposed"] += spec[0]
                        st["accepted"] += spec[1]
                        st["rounds"] += spec[2]
                    if self.prefix_mix and cached is not None:
                        # hot = the server's prefix cache served >= one
                        # full page of this prompt's KV; split TTFT by
                        # it so the report shows what a cache hit buys
                        pcls = self.prefix_cycle[
                            i % len(self.prefix_cycle)] or "unique"
                        st = self.prefix_stats.setdefault(
                            pcls, {"requests": 0, "hits": 0,
                                   "ttft_hot": [], "ttft_cold": []})
                        st["requests"] += 1
                        hot = cached > 0
                        st["hits"] += int(hot)
                        if ttft is not None:
                            st["ttft_hot" if hot
                               else "ttft_cold"].append(ttft)
                        if served is not None:
                            # fleet view: WHERE did the hits land —
                            # prefix-affinity routing concentrates the
                            # shared class's hits on the owner replica
                            rst = self.replica_stats.setdefault(
                                served, {"requests": 0, "hits": 0})
                            rst["requests"] += 1
                            rst["hits"] += int(hot)

    def _attempt(self, i: int, traceparent=None, trace_id=None):
        """One wire attempt in the configured workload; returns
        (code, retry_after)."""
        if self.mode == "decode":
            (code, dt, retry_after, ttft, itls, ntok, cached,
             spec, served) = self._send_decode(i, traceparent)
            self._record(i, code, dt, ttft=ttft, itls=itls, ntok=ntok,
                         trace_id=trace_id, cached=cached, spec=spec,
                         served=served)
        else:
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
            "workload": self.mode,
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
        if self.mode == "decode":
            all_ttft = [v for xs in self.ttfts.values() for v in xs]
            all_itl = [v for xs in self.itls.values() for v in xs]
            rep["decode"] = {
                "streams_ok": ok,
                "tokens": self.tokens,
                # goodput in the unit decode is bought for: generated
                # tokens per wall second across all concurrent streams
                "decode_tokens_sec": round(self.tokens / wall, 2)
                if wall > 0 else None,
                "ttft_ms": _latency_stats(all_ttft),
                "inter_token_ms": _latency_stats(all_itl),
            }
            if self.spec_stats:
                tot = {"streams": 0, "proposed": 0, "accepted": 0,
                       "rounds": 0}
                for st in self.spec_stats.values():
                    for key in tot:
                        tot[key] += st[key]
                rep["decode"].update(_spec_cols(tot))
            if self.prefix_mix:
                total = sum(s["requests"]
                            for s in self.prefix_stats.values())
                hits = sum(s["hits"] for s in self.prefix_stats.values())
                hot = [t for s in self.prefix_stats.values()
                       for t in s["ttft_hot"]]
                cold = [t for s in self.prefix_stats.values()
                        for t in s["ttft_cold"]]
                rep["prefix"] = {
                    "cache_hit_rate": round(hits / total, 4)
                    if total else None,
                    "ttft_hot_ms": _latency_stats(hot),
                    "ttft_cold_ms": _latency_stats(cold),
                    "per_class": {
                        pcls: {
                            "requests": s["requests"],
                            "cache_hit_rate": round(
                                s["hits"] / s["requests"], 4)
                            if s["requests"] else None,
                            "ttft_hot_ms": _latency_stats(s["ttft_hot"]),
                            "ttft_cold_ms": _latency_stats(
                                s["ttft_cold"]),
                        } for pcls, s in sorted(
                            self.prefix_stats.items())},
                }
                if self.replica_stats:
                    # which replica the hits landed on (fleet runs via
                    # the router's X-Served-By header): affinity routing
                    # shows up as hit rates concentrated on owners
                    rep["prefix"]["per_replica"] = {
                        name: {"requests": s["requests"],
                               "cache_hit_rate": round(
                                   s["hits"] / s["requests"], 4)
                               if s["requests"] else None}
                        for name, s in sorted(self.replica_stats.items())}
        if len(self.class_cycle) > 1 or self.class_cycle[0] is not None:
            rep["per_class"] = {
                cls: {"latency_ms": _latency_stats(
                          self.latencies.get(cls, [])),
                      "outcomes": dict(sorted(counts.items()))}
                for cls, counts in sorted(self.class_codes.items())}
            if self.mode == "decode":
                for cls, sub in rep["per_class"].items():
                    sub["ttft_ms"] = _latency_stats(
                        self.ttfts.get(cls, []))
                    sub["inter_token_ms"] = _latency_stats(
                        self.itls.get(cls, []))
                    if cls in self.spec_stats:
                        sub.update(_spec_cols(self.spec_stats[cls]))
        return rep
