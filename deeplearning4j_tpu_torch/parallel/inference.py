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
data axis.

`plan` (a `ShardingPlan`) serves a tensor-parallel servable over the
process group, in the form `fit(plan=)` has: every rank of the group
builds the ParallelInference (the plan is engaged on its network, whose
rule-split kernels stay this rank's pieces and compute split,
`parallel/tensor.py`) and calls `output(x)` with the same batch; the
batch is padded to a multiple of the ``data`` degree, as the reference
pads it, each ``data`` rank runs its block and the answers are gathered
back. `update_model` engages the plan on the replacement (every rank
calls it). Where one process alone takes the requests (the registry's
rank 0 behind HTTP), it is the leader (``role="leader"``): each forward,
warm-up and swap it runs is broadcast over the group first, and the
other ranks run `follow()`, which replays them until the leader's
`shutdown()`. A swap's replacement is warmed on every rank as the
candidate and goes live on the leader's commit; a leader whose warm-up
fails aborts it on every rank. The reference drives all its devices
from one process; the leader and its followers are the port's own
design.
"""
from __future__ import annotations

import enum
import json
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger

log = logging.getLogger("deeplearning4j_tpu_torch")
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


#: the leader's broadcast commands (`ParallelInference.follow`)
_STOP, _RUN, _COMMIT, _CALL, _ABORT = 0, 1, 2, 3, 4
#: header: command, model slot (0 live, 1 a swap's candidate), dtype code,
#: ndim, then the shape
_HEAD = 12
_DTYPES = ("float32", "float64", "float16", "int64", "int32", "uint8",
           "bool")


def _grouped_world() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_world_size() > 1


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
                 plan=None, role: Optional[str] = None):
        if model.params is None:
            raise RuntimeError("model must be initialized before serving")
        if role not in (None, "leader", "follower"):
            raise ValueError(f"role must be None, 'leader' or 'follower', "
                             f"got {role!r}")
        self._plan = plan
        #: None: every rank calls output(); "leader": this rank takes the
        #: requests and broadcasts them; "follower": follow() replays them
        self.role = role if plan is not None and _grouped_world() else None
        self._leader = self.role == "leader"
        self._candidate = None          # a swap's warming replacement
        self._announced_stop = False
        self._on_call = None            # follow()'s callback
        self._runs = 0                  # forwards a follower replayed
        self._stopped = False           # a follower saw the leader stop
        self._vote_pending = False      # a follower owes the leader a vote
        if plan is not None:
            from deeplearning4j_tpu_torch.parallel.plan import ShardingPlan
            if not isinstance(plan, ShardingPlan):
                raise TypeError(f"plan must be a parallel.ShardingPlan, got "
                                f"{type(plan).__name__}")
            if mesh is not None:
                raise ValueError("a plan names its own mesh: pass plan= or "
                                 "mesh=, not both")
            model._engage_plan(plan)
            # forwards and their collectives run one at a time
            self._collective_lock = threading.Lock()
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

    # ------------------------------------------------------------- the plan
    def _plan_forward(self, model, x, slot: int) -> np.ndarray:
        """The forward of `model` under the plan: the leader's broadcast
        first; the batch padded to the ``data`` degree, this rank's block
        run, the blocks gathered back."""
        x = np.asarray(x)
        with self._collective_lock:
            if self._leader:
                self._announce(_RUN, slot, x)
            return self._plan_block(model, x)

    def _plan_block(self, model, x) -> np.ndarray:
        from deeplearning4j_tpu_torch.parallel.mesh import (
            DATA_AXIS, all_gather_dim,
        )
        rt = model._plan_rt
        n, nd = x.shape[0], rt.n_data
        padded = -(-max(n, 1) // nd) * nd
        if padded != n:
            x = np.concatenate(
                [x, np.zeros((padded - n,) + x.shape[1:], x.dtype)], 0)
        blk = padded // nd
        y = self._run_with(model, x[rt.data_index * blk:
                                    (rt.data_index + 1) * blk])
        if nd > 1:
            t = torch.from_numpy(y).to(model.device)
            y = all_gather_dim(t, 0, rt.mesh.group(DATA_AXIS),
                               nd).cpu().numpy()
            rt.syncs += 1
        return y[:n]

    def _wire(self) -> torch.device:
        """The device of the broadcasts' tensors: gloo takes host tensors,
        NCCL the card's."""
        import torch.distributed as dist
        return self.device if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def _announce(self, cmd: int, slot: int = 0, x=None):
        """Leader: broadcast one command (and its array) to the
        followers."""
        import torch.distributed as dist
        dev = self._wire()
        x = None if x is None else np.ascontiguousarray(x)
        head = np.zeros(_HEAD, np.int64)
        head[:3] = (cmd, slot, -1 if x is None else _DTYPES.index(
            str(x.dtype)))
        if x is not None:
            head[3] = x.ndim
            head[4:4 + x.ndim] = x.shape
        dist.broadcast(torch.from_numpy(head).to(dev), src=0)
        if x is not None:
            dist.broadcast(torch.from_numpy(x).to(dev), src=0)

    def _receive(self):
        """Follower: (cmd, slot, array or None) of the next broadcast."""
        import torch.distributed as dist
        dev = self._wire()
        head = torch.empty(_HEAD, dtype=torch.int64, device=dev)
        dist.broadcast(head, src=0)
        cmd, slot, code, ndim = (int(v) for v in head[:4].tolist())
        if code < 0:
            return cmd, slot, None
        shape = tuple(int(v) for v in head[4:4 + ndim].tolist())
        x = torch.empty(shape, dtype=getattr(torch, _DTYPES[code]),
                        device=dev)
        dist.broadcast(x, src=0)
        return cmd, slot, x.cpu().numpy()

    def announce_call(self, message: dict, agree: bool = False):
        """Leader: hand `message` (JSON) to every follower's `follow`
        callback, in order with the forwards. With `agree`, wait for the
        followers' votes (`agree`) and return True when all took it."""
        data = np.frombuffer(json.dumps(message).encode(), np.uint8)
        with self._collective_lock:
            self._announce(_CALL, int(agree), data)
            return self.agree(True) if agree else True

    def agree(self, ok: bool) -> bool:
        """This rank's vote on the leader's call, and the group's verdict:
        True when every rank voted True (one all-reduce of an int)."""
        import torch.distributed as dist
        self._vote_pending = False
        t = torch.tensor([int(bool(ok))], dtype=torch.int64,
                         device=self._wire())
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def follow(self, on_call=None):
        """Follower: replay the leader's forwards, swaps and calls until
        its `shutdown()` (`on_call(message)` takes its `announce_call`
        messages; an error there is logged and the loop goes on).
        Returns the number of forwards run."""
        if self.role != "follower":
            raise RuntimeError("follow() runs on a follower rank of a "
                               "ParallelInference(plan=, role='follower')")
        self._on_call = on_call
        while not self._stopped:
            self._serve_one()
        return self._runs

    def _serve_one(self) -> int:
        """Follower: run the leader's next command; returns it (a commit
        or an abort is left to the swap waiting for it)."""
        cmd, slot, x = self._receive()
        if cmd == _RUN:
            self._plan_block(self._candidate if slot else self.model, x)
            self._runs += 1
        elif cmd == _STOP:
            self._stopped = True
        elif cmd == _CALL:
            # slot 1: the leader waits for every rank's vote on the call
            self._vote_pending = bool(slot)
            ok = True
            try:
                if self._on_call is not None:
                    self._on_call(json.loads(bytes(x).decode()))
            except Exception as e:
                ok = False
                log.warning("ParallelInference: follower failed the "
                            "leader's call (%s: %s); following on",
                            type(e).__name__, e)
            if self._vote_pending:
                self.agree(ok)
        return cmd

    def _commit(self):
        with self._swap_lock:
            self.model = self._candidate
            self._replicas = [self._candidate]
            self._candidate = None

    def _run_batch(self, x, batched: bool = False):
        """One replica's forward (SEQUENTIAL: round-robin), or the batch
        split in contiguous blocks over every replica at once (BATCHED);
        under a plan, the plan's forward."""
        with self._swap_lock:   # the replicas are read atomically vs a swap
            replicas = self._replicas
            turn = self._next
            self._next = (self._next + 1) % len(replicas)
        if self._plan is not None:
            return self._plan_forward(replicas[0], x, 0)
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
        threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                    name=f"ParallelInference-split-{i}")
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
        if self._plan is not None:
            self._swap_under_plan(model, warmup)
            return
        replicas = [_replica(model, d) for d in self.devices]
        if warmup is not None:
            for r in replicas:
                warmup(lambda x, r=r: self._run_with(r, x))
        with self._swap_lock:
            self.model = model
            self._replicas = replicas

    def _swap_under_plan(self, model, warmup):
        """update_model under the plan: the replacement's plan engaged
        (on every rank), warmed as the candidate (the leader's warm-up
        forwards replayed on the followers' candidate), then live. A
        follower stages the candidate and replays the leader's forwards
        until its commit swaps it in (or its abort drops it)."""
        model._engage_plan(self._plan)
        self._candidate = model
        if self.role == "follower":
            # the leader's warm-up forwards, then its commit or abort
            while True:
                cmd = self._serve_one()
                if cmd == _COMMIT:
                    self._commit()
                    return
                if cmd in (_ABORT, _STOP):
                    self._candidate = None
                    raise RuntimeError(
                        "the leader abandoned the swap" if cmd == _ABORT
                        else "the leader shut down during the swap")
        try:
            if warmup is not None:
                warmup(lambda x: self._plan_forward(model, x, 1))
        except BaseException:
            with self._collective_lock:
                if self._leader:
                    self._announce(_ABORT)
                self._candidate = None
            raise
        with self._collective_lock:
            if self._leader:
                self._announce(_COMMIT)
            self._commit()

    def shutdown(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
        if self._leader and not self._announced_stop:
            self._announced_stop = True
            with self._collective_lock:
                self._announce(_STOP)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
