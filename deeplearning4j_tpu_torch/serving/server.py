"""ModelServer — the HTTP front end over a ModelRegistry.

Counterpart of the JAX package's `serving/server.py`, for the predict
and generate surfaces:

    POST /v1/models/{name}/predict    JSON {"inputs": [...]} or raw .npy
                                      (Content-Type:
                                      application/octet-stream); answers
                                      JSON, or .npy with
                                      Accept: application/octet-stream
    POST /v1/models/{name}/generate   JSON {"prompt": [ids...],
                                      "max_tokens", "temperature",
                                      "top_k", "eos_id", "stream"} on an
                                      LM servable (`deploy_lm`); answers
                                      chunked text/event-stream, one
                                      event per token and a done event,
                                      or one JSON document
    POST /v1/models/{name}/swap       {"source": <zip|dir|zoo:Arch>}: a
                                      warmed version swap (rolling for
                                      an LM servable)
    POST /v1/models/{name}/rollback   back to the previous version
    POST /v1/models/{name}/kv/export  JSON {"prompt": [ids...]} on an LM
                                      servable; answers the framed KV
                                      page transfer (octet-stream)
    POST /v1/models/{name}/kv/import  a blob from kv/export, landed into
                                      this server's prefix cache
    GET  /v1/models                   all servables
    GET  /v1/models/{name}            one servable
    GET  /healthz                     process liveness (always 200)
    GET  /readyz                      200 only when warmed and not draining;
                                      carries the server's rollout role
                                      and generation, its kv_role and
                                      each LM's prefix-ownership digests
    POST /v1/rollout/role             {"role": "stable"|"canary",
                                      "rollout_generation": N}: the
                                      fleet's rollout state, mirrored
                                      onto this server's /readyz
    GET  /metrics                     Prometheus exposition (monitor/);
                                      ``?format=openmetrics`` adds
                                      trace exemplars + ``# EOF``
    GET  /v1/debug/flight             flight-recorder snapshot (monitor/
                                      flight.py): recent request
                                      timelines, postmortems, exemplars
    GET  /v1/slo                      SLO verdict (monitor/slo.py):
                                      burn rates + alert states, or
                                      {"enabled": false} when off
    GET  /v1/timeseries               windowed series views (monitor/
                                      timeseries.py): ?series=&window=
    GET/POST /v1/faults               the serving fault toggles, only on a
                                      server started with fault injection
                                      (`--enable-fault-injection`)

Every request adopts the caller's ``traceparent`` header (or mints a
fresh trace context at ingress, while tracing or the flight recorder is
on), binds it to the handling thread so the request/batch/decode spans
carry one trace_id, opens a flight-recorder record, and answers with an
``X-Trace-Id`` header. An unexpected 500 trips an automatic flight
postmortem. Every response increments ``serving_requests_total{model,
code}`` and observes ``serving_request_seconds``, so a /metrics scrape
sees exactly what clients saw.

Status contract: 404 unknown model, 400 bad payload (a corrupt KV
blob, a swap source that cannot load or does not fit), 429 with
Retry-After when the batcher's or the join queue is full, 504 when a
request's deadline expires, 503 with Retry-After while draining (a swap
racing a drain included), 499 (logged, nothing sent) when a streaming
client went away, and anything unexpected a JSON 500 with the error
class only — a traceback never crosses the wire.
"""
from __future__ import annotations

import io
import json
import logging
import queue
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight, slo, timeseries
from deeplearning4j_tpu_torch.serving.batcher import (
    DeadlineExceededError, ServerDrainingError, ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ModelRegistry,
)
from deeplearning4j_tpu_torch.util import faults as fault_util

log = logging.getLogger("deeplearning4j_tpu_torch")

_MAX_BODY = 256 << 20           # admission guard on Content-Length

ENDPOINTS = ["/v1/models", "/v1/models/{name}", "/v1/models/{name}/predict",
             "/v1/models/{name}/generate", "/v1/models/{name}/swap",
             "/v1/models/{name}/rollback", "/v1/models/{name}/kv/export",
             "/v1/models/{name}/kv/import", "/healthz", "/readyz",
             "/metrics", "/v1/debug/flight", "/v1/slo", "/v1/timeseries",
             "/v1/rollout/role", "/v1/faults"]

KV_ROLES = ("prefill", "decode", "mixed")


def retry_after_seconds(queue_depth: int, queue_limit: int,
                        draining: bool = False,
                        rng: Optional[random.Random] = None) -> int:
    """Jittered Retry-After hint for 429/503: the ceiling scales with
    queue fullness (a flat 5 s while draining), and the value is drawn
    uniformly from [1, ceiling] so shed clients do not retry in step.
    `rng` (default: the module-level `random`) makes the draw
    reproducible; the router passes its own."""
    rng = rng if rng is not None else random
    if draining:
        ceiling = 5
    else:
        fullness = min(1.0, queue_depth / max(1, queue_limit))
        ceiling = 1 + int(round(4 * fullness))
    return rng.randint(1, max(1, ceiling))


def metrics_payload(query: str):
    """``GET /metrics`` body + content type. ``?format=openmetrics`` opts
    into the exemplar-carrying OpenMetrics exposition; the default stays
    the v0.0.4 text."""
    fmt = parse_qs(query or "").get("format", [""])[0]
    if fmt == "openmetrics":
        return (monitor.openmetrics_text().encode(),
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")
    return (monitor.prometheus_text().encode(),
            "text/plain; version=0.0.4; charset=utf-8")


def timeseries_doc(ring, query: str) -> dict:
    """The ``GET /v1/timeseries`` document. No ``series`` param lists the
    ring (names + coverage); ``series=<family>&window=<seconds>`` answers
    the typed windowed view, and every other query param pins a label
    value (e.g. ``&model=m``)."""
    if ring is None:
        return {"enabled": False}
    q = {k: v[0] for k, v in parse_qs(query or "").items()}
    series = q.pop("series", None)
    try:
        window = float(q.pop("window", 60.0))
    except (TypeError, ValueError):
        return {"enabled": True, "error": "window must be a number"}
    if series is None:
        doc = ring.describe()
    else:
        doc = ring.query(series, window, **q)
    doc["enabled"] = True
    return doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JCUDA-Serving/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):          # requests are metered, not logged
        pass

    @property
    def _srv(self) -> "ModelServer":
        return self.server.model_server        # type: ignore[attr-defined]

    def _reply(self, code: int, body: bytes, ctype: str, extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            self.send_header("X-Trace-Id", ctx.trace_id)
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200, extra=()):
        self._reply(code, json.dumps(obj).encode(), "application/json", extra)

    def _ingress(self):
        """Adopt/mint the request's trace context (None while tracing
        and the flight recorder are both disabled) and remember it so
        every response carries X-Trace-Id."""
        ctx = flight.request_context(
            self.headers.get(monitor.TRACEPARENT_HEADER), "server")
        self._trace_ctx = ctx
        return ctx

    def _meter(self, model: str, code: int, t0: float):
        if code == 404:
            # client-supplied names that don't resolve must not mint new
            # label sets — a URL prober would grow the registry unbounded
            model = "_unknown"
        monitor.counter("serving_requests_total",
                        "HTTP serving requests by model and status code",
                        labels=("model", "code")).inc(
            model=model, code=str(code))
        ctx = getattr(self, "_trace_ctx", None)
        monitor.histogram("serving_request_seconds",
                          "End-to-end HTTP request latency",
                          labels=("model",)).observe(
            time.perf_counter() - t0, model=model,
            exemplar=None if ctx is None else ctx.trace_id)

    def _body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except (TypeError, ValueError):
            raise ValueError("bad Content-Length header") from None
        if length < 0 or length > _MAX_BODY:
            raise ValueError(f"unreasonable Content-Length {length}")
        return self.rfile.read(length)

    # ---------------------------------------------------------------- GET
    def do_GET(self):
        self._trace_ctx = None          # keep-alive: no stale ids
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if url.path == "/v1/debug/flight":
            self._json(flight.snapshot())
            return
        if url.path in ("/healthz", "/readyz"):
            try:
                # fault point: a wedged server answers probes slowly (or
                # not at all)
                self._srv.faults.on_probe()
            except Exception as e:      # noqa: BLE001 — injected blackhole
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
                return
        if url.path == "/healthz":
            self._json({"status": "alive"})
            return
        if url.path == "/readyz":
            if self._srv.ready():
                # KV-fabric publication: the disaggregation role and each
                # LM's leading-block ownership digests
                self._json({"status": "ready",
                            "models": self._srv.registry.names(),
                            "role": self._srv.role,
                            "rollout_generation":
                                self._srv.rollout_generation,
                            "kv_role": self._srv.kv_role,
                            "kv_ownership": self._srv.kv_ownership()})
            else:
                self._json({"status": "draining"
                            if self._srv.draining else "loading"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
            return
        if url.path == "/v1/faults":
            if not self._srv.enable_faults:
                self._json({"error": "not found"}, code=404)
            else:
                self._json(self._srv.faults.describe())
            return
        if url.path == "/metrics":
            body, ctype = metrics_payload(url.query)
            self._reply(200, body, ctype)
            return
        if url.path == "/v1/slo":
            engine = self._srv.slo_engine or slo.default_engine()
            self._json(engine.verdict() if engine is not None
                       else {"enabled": False})
            return
        if url.path == "/v1/timeseries":
            ring = self._srv.timeseries_ring or timeseries.default_ring()
            self._json(timeseries_doc(ring, url.query))
            return
        if parts[:2] == ["v1", "models"]:
            if len(parts) == 2:
                self._json(self._srv.registry.describe())
                return
            if len(parts) == 3:
                served = self._srv.registry.get(parts[2])
                if served is None:
                    self._json({"error": f"unknown model {parts[2]!r}"},
                               code=404)
                else:
                    self._json(served.describe())
                return
        self._json({"error": "not found"}, code=404)

    # --------------------------------------------------------------- POST
    def do_POST(self):
        self._trace_ctx = None          # keep-alive: no stale ids
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if parts[:2] == ["v1", "models"] and len(parts) == 4:
            if parts[3] == "predict":
                self._predict(parts[2], url)
                return
            if parts[3] == "generate":
                self._generate(parts[2], url)
                return
            if parts[3] in ("swap", "rollback"):
                self._admin(parts[2], parts[3])
                return
        if parts[:2] == ["v1", "models"] and len(parts) == 5 \
                and parts[3] == "kv" and parts[4] in ("export", "import"):
            self._kv(parts[2], parts[4])
            return
        if url.path == "/v1/rollout/role":
            # rollout control surface: the fleet's RolloutController (or
            # SubprocessReplica.set_role relaying for it) marks this
            # server canary/stable so its own /readyz agrees with the
            # fleet view on the router's /v1/fleet
            try:
                payload = json.loads(self._body() or b"{}")
                role = payload.get("role")
                if role not in ("stable", "canary"):
                    raise ValueError('role must be "stable" or "canary"')
                self._srv.role = role
                self._srv.rollout_generation = int(
                    payload.get("rollout_generation", 0))
            except (ValueError, TypeError, AttributeError) as e:
                self._json({"error": str(e)}, code=400)
                return
            self._json({"role": self._srv.role,
                        "rollout_generation": self._srv.rollout_generation})
            return
        if url.path == "/v1/faults" and self._srv.enable_faults:
            # chaos surface: wedge/unwedge THIS server mid-traffic. Only
            # exists when fault injection was requested at startup.
            try:
                payload = json.loads(self._body() or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                self._srv.faults.set(**payload)
                self._json(self._srv.faults.describe())
            except (ValueError, TypeError) as e:
                self._json({"error": str(e)}, code=400)
            return
        self._json({"error": "not found"}, code=404)

    def _served_or_reply(self, name: str, t0: float):
        """The servable `name`, or None after answering (and metering) 503
        (the drain emptied the registry) or 404."""
        served = self._srv.registry.get(name)
        if served is None:
            if self._srv.draining:
                self._meter(name, 503, t0)
                self._json({"error": "server draining"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
            else:
                self._meter(name, 404, t0)
                self._json({"error": f"unknown model {name!r}"}, code=404)
        return served

    def _admin(self, name: str, verb: str):
        """POST /v1/models/{name}/swap {"source": ...} and /rollback."""
        t0 = time.perf_counter()
        ctx = self._ingress()
        served = self._served_or_reply(name, t0)
        if served is None:
            return
        code = 500
        try:
            if verb == "swap":
                payload = json.loads(self._body() or b"{}")
                source = payload.get("source") \
                    if isinstance(payload, dict) else None
                if not source or not isinstance(source, str):
                    raise ValueError('body must be {"source": <path>}')
                info = served.swap(source)
            else:
                info = served.rollback()
            code = 200
            self._json({"model": name, "active": info,
                        "seconds": served.last_swap_seconds})
        except ServerDrainingError as e:
            # swap/rollback racing a drain is an expected shutdown-window
            # outcome, not a server fault — 503, never a 500
            code = 503
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, ModelLoadError) as e:
            code = 400
            self._json({"error": str(e)}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            code = 500
            log.exception("serving[%s]: %s failed", name, verb)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            flight.trip("http_5xx", model=name, verb=verb,
                        error=type(e).__name__,
                        trace_id=None if ctx is None else ctx.trace_id)
        finally:
            self._meter(name, code, t0)

    def _kv(self, name: str, verb: str):
        """POST /v1/models/{name}/kv/export — JSON {"prompt": [ids...]}
        answered with the framed page-transfer blob (octet-stream);
        POST /v1/models/{name}/kv/import — a blob produced by export,
        landed into this server's prefix cache. A corrupt or truncated
        blob is a clean 400 (kvfabric verifies before any pool write)."""
        t0 = time.perf_counter()
        ctx = self._ingress()
        served = self._served_or_reply(name, t0)
        if served is None:
            return
        code, nbytes = 500, 0
        try:
            if not hasattr(served, "export_prefix"):
                raise ValueError(
                    f"model {name!r} is a predict servable; the KV "
                    "fabric needs an LM deployed via --lm / deploy_lm")
            with monitor.bind_context(ctx), \
                    monitor.span(f"serving/kv_{verb}", model=name):
                if verb == "export":
                    payload = json.loads(self._body() or b"{}")
                    if not isinstance(payload, dict) \
                            or "prompt" not in payload:
                        raise ValueError(
                            'JSON body must be {"prompt": [ids...]}')
                    blob = served.export_prefix(payload["prompt"])
                    nbytes = len(blob)
                    code = 200
                    self._reply(200, blob, "application/octet-stream")
                else:
                    body = self._body()
                    nbytes = len(body)
                    info = served.import_prefix(body)
                    code = 200
                    self._json(dict(info, model=name))
        except ServerOverloadedError as e:
            code = 429
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            code = 504
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            code = 503
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, TypeError) as e:
            # kvfabric.FrameError subclasses ValueError: a corrupt or
            # mismatched shipment is the sender's fault, not ours
            code = 400
            self._json({"error": f"{type(e).__name__}: {e}"}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            code = 500
            log.exception("serving[%s]: kv %s failed", name, verb)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            flight.trip("http_5xx", model=name, verb=f"kv_{verb}",
                        error=type(e).__name__,
                        trace_id=None if ctx is None else ctx.trace_id)
        finally:
            outcome = "ok" if code == 200 else (
                "rejected" if code == 400 else "error")
            monitor.counter(
                "serving_transfer_requests_total",
                "KV page-transfer requests by direction and outcome",
                labels=("model", "direction", "outcome")).inc(
                model=name, direction=verb, outcome=outcome)
            if nbytes:
                monitor.counter(
                    "serving_transfer_bytes_total",
                    "Serialized KV page bytes moved over the fabric",
                    labels=("model", "direction")).inc(
                    nbytes, model=name, direction=verb)
            monitor.histogram(
                "serving_transfer_seconds",
                "KV page transfer handling latency",
                labels=("model", "direction"),
                buckets=(0.005, 0.025, 0.1, 0.25, 1, 2.5, 10, 30)
            ).observe(time.perf_counter() - t0, model=name,
                      direction=verb)
            self._meter(name, code, t0)

    def _parse_inputs(self) -> np.ndarray:
        """Request payload -> float array: JSON {"inputs": nested lists}
        or a raw .npy body (Content-Type: application/octet-stream)."""
        body = self._body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/octet-stream":
            x = np.load(io.BytesIO(body), allow_pickle=False)
        else:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict) or "inputs" not in payload:
                raise ValueError('JSON body must be {"inputs": [...]}')
            x = np.asarray(payload["inputs"], "float32")
        if x.ndim == 0:
            raise ValueError("inputs must be at least rank 1")
        return x

    def _predict(self, name: str, url):
        t0 = time.perf_counter()
        ctx = self._ingress()
        q = parse_qs(url.query)
        served = self._served_or_reply(name, t0)
        if served is None:
            return
        fr = flight.begin(ctx, "predict", model=name)
        code = 500
        try:
            if not hasattr(served, "predict"):
                raise ValueError(
                    f"model {name!r} is an LM servable; it answers "
                    "POST /v1/models/{name}/generate")
            with monitor.bind_context(ctx), \
                    monitor.span("serving/request", model=name):
                x = self._parse_inputs()
                batched = x.shape[1:] == served.input_shape
                if not batched and x.shape == served.input_shape:
                    x = x[None]          # single unbatched example
                try:
                    deadline = float(q["deadline_ms"][0]) / 1e3 \
                        if "deadline_ms" in q else self._srv.default_deadline
                except ValueError:
                    raise ValueError("deadline_ms must be a number") \
                        from None
                self._srv.faults.on_predict()
                y = served.predict(x, deadline=deadline)
                if not batched and y.shape[0] == 1:
                    y = y[0]
            code = 200
            if "application/octet-stream" in self.headers.get("Accept", ""):
                buf = io.BytesIO()
                np.save(buf, np.asarray(y), allow_pickle=False)
                self._reply(200, buf.getvalue(), "application/octet-stream")
            else:
                self._json({
                    "model": name,
                    "version": served.active_info["version"],
                    "outputs": np.asarray(y).tolist(),
                    "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
                })
        except ServerOverloadedError as e:
            code = 429
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            code = 504
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            code = 503
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except ValueError as e:
            code = 400
            self._json({"error": str(e)}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            code = 500
            log.exception("serving[%s]: predict failed", name)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            flight.trip("http_5xx", model=name,
                        error=type(e).__name__,
                        trace_id=None if ctx is None else ctx.trace_id)
        finally:
            self._meter(name, code, t0)
            flight.finish(fr, "ok" if code == 200 else f"http_{code}",
                          code=code)

    # ---------------------------------------------------------- generation
    @staticmethod
    def _sse(obj) -> bytes:
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    def _chunk(self, data: bytes):
        """One HTTP/1.1 chunked-transfer frame (the stream has no
        Content-Length, so chunking is mandatory on a keep-alive wire)."""
        self.wfile.write(f"{len(data):X}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _generate(self, name: str, url):
        """POST /v1/models/{name}/generate — token-level generation on a
        decode servable (serving/decode.py). JSON body::

            {"prompt": [ids...], "max_tokens": 32, "temperature": 0.0,
             "top_k": 0, "eos_id": null, "stream": true}

        stream=true (default) answers ``text/event-stream`` over chunked
        transfer — one ``data: {"token": id, "index": i}`` event per
        generated token as it is sampled, closed by a ``done`` event with
        the finish reason. stream=false buffers the generation into one
        JSON answer. Status mapping matches predict: 429 (join queue
        full, Retry-After), 503 (draining), 504 (deadline before the
        first token), 400 (bad prompt/params); 499 when the client went
        away mid-stream."""
        t0 = time.perf_counter()
        ctx = self._ingress()
        q = parse_qs(url.query)
        served = self._served_or_reply(name, t0)
        if served is None:
            return
        fr = flight.begin(ctx, "stream", model=name)
        code = 500
        self._gen_started = False
        req = None
        try:
            if not hasattr(served, "generate"):
                raise ValueError(
                    f"model {name!r} is a predict servable; generation "
                    "needs an LM deployed via --lm / deploy_lm")
            payload = json.loads(self._body() or b"{}")
            if not isinstance(payload, dict) or "prompt" not in payload:
                raise ValueError('JSON body must be {"prompt": [ids...]}')
            stream = bool(payload.get("stream", True))
            try:
                deadline = float(q["deadline_ms"][0]) / 1e3 \
                    if "deadline_ms" in q else self._srv.default_deadline
            except ValueError:
                raise ValueError("deadline_ms must be a number") from None
            self._srv.faults.on_predict()
            with monitor.bind_context(ctx), \
                    monitor.span("serving/generate", model=name,
                                 stream=1 if stream else 0):
                req = served.generate(
                    payload["prompt"],
                    max_new_tokens=int(payload.get("max_tokens", 32)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    eos_id=payload.get("eos_id"),
                    deadline=deadline)
                code = self._relay_generation(name, req, t0, deadline,
                                              stream)
        except ServerOverloadedError as e:
            code = 429
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            code = 504
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            code = 503
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, TypeError) as e:
            code = 400
            self._json({"error": str(e)}, code=400)
        except (BrokenPipeError, ConnectionResetError):
            # 499: the client went away mid-stream; free the slot, there
            # is nobody to answer
            code = 499
            log.info("serving[%s]: generate client went away (499)", name)
            if req is not None:
                req.cancel()
        except Exception as e:          # noqa: BLE001 — never a traceback
            code = 500
            log.exception("serving[%s]: generate failed", name)
            if req is not None:
                req.cancel()
            if not self._gen_started:   # headers not sent: clean JSON 500
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            flight.trip("http_5xx", model=name,
                        error=type(e).__name__,
                        trace_id=None if ctx is None else ctx.trace_id)
        finally:
            self._meter(name, code, t0)
            flight.finish(fr, "ok" if code == 200 else f"http_{code}",
                          code=code,
                          finish_reason=None if req is None
                          else req.finish_reason,
                          tokens=None if req is None else req.n_emitted,
                          cached_tokens=None if req is None
                          else req.cached_tokens)

    def _relay_generation(self, name: str, req, t0: float, deadline: float,
                          stream: bool) -> int:
        """Pump one GenerateRequest's event queue onto the wire. Returns
        the HTTP status metered for the request; raises the serving
        errors the caller maps (only BEFORE the first byte is sent)."""
        wait = max(0.05, deadline) + 5.0
        first = self._event(req, wait)
        # the first event decides the status line: an error before any
        # token maps to a clean non-200 exactly like predict
        if first[0] == "error":
            raise first[1]
        if not stream:
            tokens = []
            ev = first
            while ev[0] == "token":
                tokens.append(ev[1])
                ev = self._event(req, wait)
            if ev[0] == "error":
                raise ev[1]
            info = ev[1]
            self._json({
                "model": name, "version": info.get("version"),
                "tokens": tokens,
                "finish_reason": info.get("finish_reason"),
                "cached_tokens": info.get("cached_tokens"),
                "prefill_chunks": info.get("prefill_chunks"),
                "spec_proposed": info.get("spec_proposed"),
                "spec_accepted": info.get("spec_accepted"),
                "spec_rounds": info.get("spec_rounds"),
                "ttft_ms": round((req.first_token_at - req.enqueued) * 1e3,
                                 3) if req.first_token_at else None,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
            })
            return 200
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            self.send_header("X-Trace-Id", ctx.trace_id)
        if req.version is not None:
            self.send_header("X-Model-Version", str(req.version))
        self.end_headers()
        self._gen_started = True
        ev, index = first, 0
        while True:
            if ev[0] == "token":
                self._chunk(self._sse({"token": ev[1], "index": index}))
                index += 1
            elif ev[0] == "done":
                info = dict(ev[1])
                info["done"] = True
                info["ttft_ms"] = round(
                    (req.first_token_at - req.enqueued) * 1e3, 3) \
                    if req.first_token_at else None
                self._chunk(self._sse(info))
                break
            else:                               # mid-stream failure
                self._chunk(self._sse(
                    {"error": f"{type(ev[1]).__name__}: {ev[1]}"}))
                break
            ev = self._event(req, wait)
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()
        return 200

    @staticmethod
    def _event(req, wait: float):
        """Next scheduler event, or a synthesized deadline error if the
        stream stalls past its budget."""
        try:
            return req.events.get(timeout=wait)
        except queue.Empty:
            req.cancel()
            return ("error", DeadlineExceededError(
                f"generation produced no event within {wait:.1f}s"))


class ModelServer:
    """HTTP front end over a ModelRegistry.

        registry = ModelRegistry(device="cuda")
        registry.deploy("lm", "zoo:TransformerLM?attention_impl=flash")
        server = ModelServer(registry, port=8500)   # serving immediately
        ...
        server.drain()                              # graceful stop
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 default_deadline_s: float = 30.0, kv_role: str = "mixed",
                 enable_faults: bool = False,
                 faults: Optional[fault_util.ServingFaults] = None,
                 slo_engine=None, timeseries_ring=None):
        self.registry = registry if registry is not None else ModelRegistry()
        self.default_deadline = float(default_deadline_s)
        self.enable_faults = bool(enable_faults)
        # GET /v1/slo and /v1/timeseries sources; None falls back to the
        # process defaults (slo.default_engine() / timeseries.
        # default_ring()) so the CLI's enable_* calls just work
        self.slo_engine = slo_engine
        self.timeseries_ring = timeseries_ring
        # fault toggles are per-server injectable; the default stays the
        # process singleton (env-armed processes)
        self.faults = faults if faults is not None \
            else fault_util.serving_faults()
        if self.enable_faults:
            self.faults.apply_env()
        self.draining = False
        # rollout state mirrored from the fleet (POST /v1/rollout/role),
        # surfaced on /readyz
        self.role = "stable"
        self.rollout_generation = 0
        # KV-fabric disaggregation role: "prefill" servers compute KV for
        # long prompts and ship pages, "decode" servers only serve
        # generation, "mixed" (default) does both — published on /readyz
        if kv_role not in KV_ROLES:
            raise ValueError(
                f'kv_role must be "prefill", "decode" or "mixed", '
                f"got {kv_role!r}")
        self.kv_role = kv_role
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.model_server = self          # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="ModelServer")
        self._thread.start()
        log.info("serving: listening on http://%s:%d", host, self.port)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def ready(self) -> bool:
        return not self.draining and self.registry.all_ready()

    def kv_ownership(self) -> dict:
        """Per-LM prefix-ownership advertisement for /readyz: the block
        size plus the leading-block digests this server can serve warm
        (device-resident or spill tier)."""
        own = {}
        for name in self.registry.names():
            served = self.registry.get(name)
            sched = getattr(served, "scheduler", None)
            if sched is None:
                continue
            engine = sched.admitting_engine()
            if engine is None or not engine.cfg.prefix_cache:
                continue
            own[name] = {"block": int(engine.cfg.page_size),
                         "digests": engine.cache.ownership_digests()}
        return own

    def retry_after(self, served=None) -> str:
        """Retry-After value for 429/503 from the implicated (or fullest)
        batcher queue."""
        models = [served] if served is not None else [
            m for m in map(self.registry.get, self.registry.names()) if m]
        depth, limit = 0, 1
        for m in models:
            if hasattr(m, "queue_state"):           # an LM's join queue
                d, lim = m.queue_state()
            else:
                d, lim = m.batcher._queue.qsize(), m.batcher._queue.maxsize
            lim = lim or 1
            if d / lim >= depth / limit:
                depth, limit = d, lim
        return str(retry_after_seconds(depth, limit, draining=self.draining))

    def drain(self, timeout: float = 30.0):
        """Graceful shutdown: readyz -> 503, flush queued requests through
        the batchers, then stop the listener."""
        if self.draining:
            return
        self.draining = True
        monitor.counter("serving_drains_total",
                        "Graceful drain/shutdown sequences").inc()
        log.warning("serving: draining (readyz now 503; flushing queues)")
        self.registry.shutdown(drain=True, timeout=timeout)
        self.stop()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
