"""ParallelInference — thread-safe inference with dynamic batching.

Counterpart of the JAX package's `parallel/inference.py` (DL4J's
`ParallelInference.java` and `BatchedInferenceObservable.java`):

- SEQUENTIAL mode: each caller's batch runs as it comes, round-robin over
  the replicas.
- BATCHED mode: concurrent requests are coalesced into one batch (up to
  `max_batch_size`), split into contiguous blocks across the replicas,
  run at once, and the results scattered back.

`mesh` is None (the network's own device), a device, or a list of
devices: one replica per device (the network itself on its own device,
copies elsewhere), as the reference shards its batch over the mesh's
data axis. Tensor-parallel servables (`plan=`) come with tensor-parallel
compute (ROADMAP A.15c) and raise NotImplementedError.
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock
from deeplearning4j_tpu_torch.util.platform import resolve_device


class InferenceMode(str, enum.Enum):
    """DL4J InferenceMode (SEQUENTIAL | BATCHED)."""
    SEQUENTIAL = "sequential"
    BATCHED = "batched"


class _Request:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _mesh_devices(mesh, model) -> list:
    """The devices inference runs on, one replica each. `mesh` is None
    (the network's own device), a device, or a sequence of devices. One
    named device must be the network's own (it is not moved); with
    several, copies are made on the others."""
    own = torch.device(model.device)
    if mesh is None:
        return [own]
    devices = [resolve_device(d) for d in (
        [mesh] if isinstance(mesh, (str, torch.device)) else list(mesh))]
    if not devices:
        raise ValueError("mesh names no device")
    if len(devices) == 1 and not _same_device(devices[0], own):
        raise ValueError(f"the network lives on {own}, the mesh names "
                         f"{devices[0]}; load it there first")
    return [own if _same_device(d, own) else d for d in devices]


def _replica(model, device: torch.device):
    """`model` on `device`: the network itself when it lives there, else
    a copy of its parameters and layer state there."""
    if _same_device(torch.device(model.device), device):
        return model
    from deeplearning4j_tpu_torch.nn.multilayer import tree_to
    clone = model.copy()
    clone.device = device
    clone.params = tree_to(clone.params, device)
    clone.state = tree_to(clone.state, device)
    clone._reset_fit_state()
    return clone


class ParallelInference:
    """Thread-safe batched inference over one replica per device.

        pi = ParallelInference(net, mode=InferenceMode.BATCHED,
                               max_batch_size=64)
        y = pi.output(x)          # safe from many threads, numpy out
        pi.shutdown()
    """

    def __init__(self, model, mesh=None,
                 mode: InferenceMode = InferenceMode.BATCHED,
                 max_batch_size: int = 64, queue_limit: int = 64,
                 plan=None):
        if model.params is None:
            raise RuntimeError("model must be initialized before serving")
        if plan is not None:
            raise NotImplementedError(
                "tensor-parallel servables (a sharding plan) come with "
                "tensor-parallel compute (ROADMAP A.15c: split matmuls, "
                "ParallelInference(plan=))")
        self.devices = _mesh_devices(mesh, model)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        self.model = model
        self._replicas = [_replica(model, d) for d in self.devices]
        self._next = 0
        self.mode = InferenceMode(mode)
        self.max_batch_size = int(max_batch_size)
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._stop = threading.Event()
        self._swap_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.parallel.inference.ParallelInference."
            "_swap_lock")
        self._ledger_cache: dict = {}    # monitor.xla programs per shape
        self._worker = None
        if self.mode == InferenceMode.BATCHED:
            self._worker = threading.Thread(target=self._serve_loop,
                                            daemon=True,
                                            name="ParallelInference")
            self._worker.start()

    # ---------------------------------------------------------------- device
    @staticmethod
    def _forward(model, x) -> np.ndarray:
        """One forward of `model` on its device -> numpy (the copy back
        synchronizes). A graph answers its first network output."""
        y = model.output(x)
        if isinstance(y, (tuple, list)):
            y = y[0]
        return y.float().cpu().numpy()

    def _run_with(self, model, x) -> np.ndarray:
        """`_forward`, and with the program ledger on the serving forward
        as program ``inference/forward`` (domain "serving"): the first
        forward of a (network, input shape) is the counted one — the
        batcher's warmups flow through here, so every ladder bucket is
        counted before a live request — and later ones feed
        `serving_mfu_pct` (their fetch synchronizes, so the wall time is
        the forward's)."""
        if not xla_ledger.enabled():
            return self._forward(model, x)
        key = (id(model), tuple(np.shape(x)), str(np.asarray(x).dtype))
        if key not in self._ledger_cache:
            cap = xla_ledger.begin_capture(
                "inference/forward",
                (model.params, getattr(model, "state", None), x),
                domain="serving", examples_per_call=int(np.shape(x)[0]),
                variant=f"compute={getattr(model, '_compute_dtype', '')}")
            with cap:
                out = cap.output = self._forward(model, x)
            self._ledger_cache[key] = cap.finish()
            return out
        t0 = time.perf_counter()
        out = self._forward(model, x)
        xla_ledger.observe_step(self._ledger_cache[key],
                                time.perf_counter() - t0, domain="serving")
        return out

    def _run_batch(self, x, batched: bool = False):
        """One replica's forward (SEQUENTIAL: round-robin), or the batch
        split in contiguous blocks over every replica at once (BATCHED)."""
        with self._swap_lock:   # the replicas are read atomically vs a swap
            replicas = self._replicas
            turn = self._next
            self._next = (self._next + 1) % len(replicas)
        if not batched or len(replicas) == 1:
            return self._run_with(replicas[turn], x)
        n = x.shape[0]
        per = -(-n // len(replicas))
        blocks = [(r, x[i * per:(i + 1) * per])
                  for i, r in enumerate(replicas) if i * per < n]
        outs, errors = [None] * len(blocks), []

        def run(i):
            try:
                outs[i] = self._run_with(*blocks[i])
            except Exception as e:      # noqa: BLE001 — raised below
                errors.append(e)
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(1, len(blocks))]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------ API
    def output(self, x, timeout: Optional[float] = 60.0):
        """Synchronous inference; thread-safe. In BATCHED mode the call
        may be coalesced with concurrent callers."""
        x = np.asarray(x)
        t0 = time.perf_counter()
        monitor.counter("inference_requests_total",
                        "ParallelInference.output() calls").inc()
        try:
            with monitor.span("inference/request", n=int(x.shape[0])):
                if self.mode == InferenceMode.SEQUENTIAL \
                        or self._worker is None:
                    return self._run_batch(x)
                if self._stop.is_set() or not self._worker.is_alive():
                    raise RuntimeError(
                        "ParallelInference has been shut down")
                req = _Request(x)
                self._queue.put(req, timeout=timeout)
                monitor.gauge("inference_queue_depth",
                              "Pending inference requests").set(
                    self._queue.qsize())
                if not req.event.wait(timeout):
                    monitor.counter("inference_timeouts_total",
                                    "Requests that hit their deadline"
                                    ).inc()
                    raise TimeoutError("inference request timed out")
                if req.error is not None:
                    raise req.error
                return req.result
        finally:
            monitor.histogram("inference_request_seconds",
                              "End-to-end request latency (queueing + "
                              "batching + device run)").observe(
                time.perf_counter() - t0)

    def _serve_loop(self):
        pending = None      # request popped but deferred to the next batch
        while not self._stop.is_set():
            if pending is not None:
                first, pending = pending, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            reqs = [first]
            total = first.x.shape[0]
            # coalesce whatever is queued right now, up to max_batch_size
            # (a request that would overflow the cap waits for the next
            # device batch)
            while total < self.max_batch_size:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if total + nxt.x.shape[0] > self.max_batch_size:
                    pending = nxt
                    break
                reqs.append(nxt)
                total += nxt.x.shape[0]
            try:
                batch = np.concatenate([r.x for r in reqs], axis=0)
                monitor.histogram(
                    "inference_batch_size",
                    "Coalesced device-batch sizes (examples)",
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                ).observe(batch.shape[0])
                monitor.gauge("inference_queue_depth",
                              "Pending inference requests").set(
                    self._queue.qsize())
                with monitor.span("inference/batch",
                                  n=int(batch.shape[0]),
                                  requests=len(reqs)):
                    out = self._run_batch(batch, batched=True)
                ofs = 0
                for r in reqs:
                    r.result = out[ofs:ofs + r.x.shape[0]]
                    ofs += r.x.shape[0]
            except Exception as e:      # noqa: BLE001 — surfaced to waiters
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.event.set()
        # drain: fail any stranded waiters instead of leaving them blocked
        leftovers = [] if pending is None else [pending]
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = RuntimeError("ParallelInference has been shut down")
            r.event.set()

    def update_model(self, model, warmup=None):
        """Hot-swap the served network (DL4J ParallelInference.
        updateModel). `warmup`, when given, is called with a
        ``run(x) -> np.ndarray`` closure over the NEW network BEFORE the
        swap: live traffic keeps hitting the old network while the
        replacement pays its first-use costs. The swap itself is atomic
        with respect to any batch in flight; batches already running
        finish on the old network."""
        if model.params is None:
            raise RuntimeError("replacement model must be initialized")
        if torch.device(model.device) != self.device:
            raise ValueError(f"replacement lives on {model.device}, this "
                             f"ParallelInference serves on {self.device}")
        replicas = [_replica(model, d) for d in self.devices]
        if warmup is not None:
            for r in replicas:
                warmup(lambda x, r=r: self._run_with(r, x))
        with self._swap_lock:
            self.model = model
            self._replicas = replicas

    def shutdown(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
