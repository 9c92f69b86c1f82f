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
                                      carries the server's kv_role and
                                      each LM's prefix-ownership digests

Status contract: 404 unknown model, 400 bad payload (a corrupt KV
blob, a swap source that cannot load or does not fit), 429 with
Retry-After when the batcher's or the join queue is full, 504 when a
request's deadline expires, 503 with Retry-After while draining (a swap
racing a drain included), 499 (logged, nothing sent) when a streaming
client went away, and anything unexpected a JSON 500 with the error
class only — a traceback never crosses the wire.

`/metrics`, flight, SLO and fault endpoints come with ROADMAP A.13, and
`/v1/rollout/role` with A.14.
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

from deeplearning4j_tpu_torch.serving.batcher import (
    DeadlineExceededError, ServerDrainingError, ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ModelRegistry,
)

log = logging.getLogger("deeplearning4j_tpu_torch")

_MAX_BODY = 256 << 20           # admission guard on Content-Length

ENDPOINTS = ["/v1/models", "/v1/models/{name}", "/v1/models/{name}/predict",
             "/v1/models/{name}/generate", "/v1/models/{name}/swap",
             "/v1/models/{name}/rollback", "/v1/models/{name}/kv/export",
             "/v1/models/{name}/kv/import", "/healthz", "/readyz"]

KV_ROLES = ("prefill", "decode", "mixed")


def retry_after_seconds(queue_depth: int, queue_limit: int,
                        draining: bool = False) -> int:
    """Jittered Retry-After hint for 429/503: the ceiling scales with
    queue fullness (a flat 5 s while draining), and the value is drawn
    uniformly from [1, ceiling] so shed clients do not retry in step."""
    if draining:
        ceiling = 5
    else:
        fullness = min(1.0, queue_depth / max(1, queue_limit))
        ceiling = 1 + int(round(4 * fullness))
    return random.randint(1, max(1, ceiling))


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JCUDA-Serving/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    @property
    def _srv(self) -> "ModelServer":
        return self.server.model_server        # type: ignore[attr-defined]

    def _reply(self, code: int, body: bytes, ctype: str, extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200, extra=()):
        self._reply(code, json.dumps(obj).encode(), "application/json", extra)

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
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if url.path == "/healthz":
            self._json({"status": "alive"})
            return
        if url.path == "/readyz":
            if self._srv.ready():
                # KV-fabric publication: the disaggregation role and each
                # LM's leading-block ownership digests
                self._json({"status": "ready",
                            "models": self._srv.registry.names(),
                            "kv_role": self._srv.kv_role,
                            "kv_ownership": self._srv.kv_ownership()})
            else:
                self._json({"status": "draining"
                            if self._srv.draining else "loading"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
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
        self._json({"error": "not found"}, code=404)

    def _served_or_reply(self, name: str):
        """The servable `name`, or None after answering 503 (the drain
        emptied the registry) or 404."""
        served = self._srv.registry.get(name)
        if served is None:
            if self._srv.draining:
                self._json({"error": "server draining"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
            else:
                self._json({"error": f"unknown model {name!r}"}, code=404)
        return served

    def _admin(self, name: str, verb: str):
        """POST /v1/models/{name}/swap {"source": ...} and /rollback."""
        served = self._served_or_reply(name)
        if served is None:
            return
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
            self._json({"model": name, "active": info,
                        "seconds": served.last_swap_seconds})
        except ServerDrainingError as e:
            # swap/rollback racing a drain is an expected shutdown-window
            # outcome, not a server fault — 503, never a 500
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, ModelLoadError) as e:
            self._json({"error": str(e)}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            log.exception("serving[%s]: %s failed", name, verb)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

    def _kv(self, name: str, verb: str):
        """POST /v1/models/{name}/kv/export — JSON {"prompt": [ids...]}
        answered with the framed page-transfer blob (octet-stream);
        POST /v1/models/{name}/kv/import — a blob produced by export,
        landed into this server's prefix cache. A corrupt or truncated
        blob is a clean 400 (kvfabric verifies before any pool write)."""
        served = self._served_or_reply(name)
        if served is None:
            return
        try:
            if not hasattr(served, "export_prefix"):
                raise ValueError(
                    f"model {name!r} is a predict servable; the KV "
                    "fabric needs an LM deployed via --lm / deploy_lm")
            if verb == "export":
                payload = json.loads(self._body() or b"{}")
                if not isinstance(payload, dict) or "prompt" not in payload:
                    raise ValueError('JSON body must be {"prompt": [ids...]}')
                blob = served.export_prefix(payload["prompt"])
                self._reply(200, blob, "application/octet-stream")
            else:
                info = served.import_prefix(self._body())
                self._json(dict(info, model=name))
        except ServerOverloadedError as e:
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, TypeError) as e:
            # kvfabric.FrameError subclasses ValueError: a corrupt or
            # mismatched shipment is the sender's fault, not ours
            self._json({"error": f"{type(e).__name__}: {e}"}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            log.exception("serving[%s]: kv %s failed", name, verb)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

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
        q = parse_qs(url.query)
        served = self._srv.registry.get(name)
        if served is None:
            if self._srv.draining:
                # the drain emptied the registry: "server going away"
                self._json({"error": "server draining"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
                return
            self._json({"error": f"unknown model {name!r}"}, code=404)
            return
        try:
            if not hasattr(served, "predict"):
                raise ValueError(
                    f"model {name!r} is an LM servable; it answers "
                    "POST /v1/models/{name}/generate")
            x = self._parse_inputs()
            batched = x.shape[1:] == served.input_shape
            if not batched and x.shape == served.input_shape:
                x = x[None]          # single unbatched example
            try:
                deadline = float(q["deadline_ms"][0]) / 1e3 \
                    if "deadline_ms" in q else self._srv.default_deadline
            except ValueError:
                raise ValueError("deadline_ms must be a number") from None
            y = served.predict(x, deadline=deadline)
            if not batched and y.shape[0] == 1:
                y = y[0]
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
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except ValueError as e:
            self._json({"error": str(e)}, code=400)
        except Exception as e:          # noqa: BLE001 — never a traceback
            log.exception("serving[%s]: predict failed", name)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

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
        q = parse_qs(url.query)
        served = self._srv.registry.get(name)
        if served is None:
            if self._srv.draining:
                self._json({"error": "server draining"}, code=503,
                           extra=(("Retry-After", self._srv.retry_after()),))
                return
            self._json({"error": f"unknown model {name!r}"}, code=404)
            return
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
            req = served.generate(
                payload["prompt"],
                max_new_tokens=int(payload.get("max_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                eos_id=payload.get("eos_id"),
                deadline=deadline)
            self._relay_generation(name, req, t0, deadline, stream)
        except ServerOverloadedError as e:
            self._json({"error": str(e)}, code=429,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except DeadlineExceededError as e:
            self._json({"error": str(e)}, code=504)
        except ServerDrainingError as e:
            self._json({"error": str(e)}, code=503,
                       extra=(("Retry-After", self._srv.retry_after(served)),))
        except (ValueError, TypeError) as e:
            self._json({"error": str(e)}, code=400)
        except (BrokenPipeError, ConnectionResetError):
            # 499: the client went away mid-stream; free the slot, there
            # is nobody to answer
            log.info("serving[%s]: generate client went away (499)", name)
            if req is not None:
                req.cancel()
        except Exception as e:          # noqa: BLE001 — never a traceback
            log.exception("serving[%s]: generate failed", name)
            if req is not None:
                req.cancel()
            if not self._gen_started:   # headers not sent: clean JSON 500
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

    def _relay_generation(self, name: str, req, t0: float, deadline: float,
                          stream: bool):
        """Pump one GenerateRequest's event queue onto the wire. Raises
        the serving errors the caller maps (only BEFORE the first byte is
        sent)."""
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
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
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
                 default_deadline_s: float = 30.0, kv_role: str = "mixed"):
        self.registry = registry if registry is not None else ModelRegistry()
        self.default_deadline = float(default_deadline_s)
        self.draining = False
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
        log.warning("serving: draining (readyz now 503; flushing queues)")
        self.registry.shutdown(drain=True, timeout=timeout)
        self.stop()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
