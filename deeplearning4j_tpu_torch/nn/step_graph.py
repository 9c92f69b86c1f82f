"""The chunked fit loop of both containers, and its captured train steps.

The reference's input-pipelined fit runs K optimizer steps in one jit
(`lax.scan`) and fetches the K losses once per chunk, one chunk late, so
the host never waits on the device inside a chunk
(`deeplearning4j_tpu/nn/multilayer.py:117-166,1133-1239`). The port's
counterpart on CUDA is a `torch.cuda.CUDAGraph` of the whole train step
(forward, backward, the updater chain with clipping, the in-place update,
the constraints' projection and the write-back of batch-norm state),
captured once per batch signature and replayed once per step. What the
reference promises of scan-of-K holds here too: the update math, the
dropout stream and the listener calls are the per-call path's; only the
overlap between host and device changes.

- The graph reads static input buffers that each step copies its batch
  into (from pinned memory, or device to device from the prefetch
  thread's tensors), and writes the new optimizer and layer state into
  the same tensors it read (`commit`). Parameters are updated in place.
- The first step of a signature runs eagerly, on a side stream: it is a
  real step of the sequence and warms up autograd, the cuBLAS and cuDNN
  workspaces and the flash libraries' first load. Then the step is
  captured and the chunk's later steps replay it.
- The epoch's dropout generator is registered with each graph, so a
  replay advances it as an eager step would and draws the same masks.
- Each step's loss is copied into a (K,) device buffer; `process` reads
  it once per chunk, one chunk late (`run_scan_pipeline`).
- Gradient accumulation captures a micro-step graph (forward, backward,
  add into a static gradient sum, batch-norm state per micro-batch) and
  one update graph (the 1/len mean, the updater, the update). An
  iteration that a gradient listener captures runs its update eagerly
  and hands the listener the averaged gradients and the updates.

Telemetry (`monitor/`) stays on the host side of every replay: the
reference's `train/etl`, `train/dispatch` and `train/chunk_sync` spans
around a chunk, `record_iteration` per loss of the chunk's one fetch,
and, with the program ledger on, the counted step (`monitor/xla.py`) is
the eager warm-up before a capture, never the captured or replayed one.

On the CPU, which the caller asked for, the same chunked loop runs eager
steps. On CUDA the graph is always used: a failure to capture or replay
raises, and nothing falls back to eager steps.
"""
from __future__ import annotations

import operator
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.async_iterator import dtype_of, pinned
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
from deeplearning4j_tpu_torch.util.env import env_int

_CAPTURE = threading.local()


def default_scan_steps() -> int:
    """fit()'s scan default: DL4J_CUDA_SCAN_STEPS, else 1 (per-call), the
    reference's default off the TPU."""
    return env_int("DL4J_CUDA_SCAN_STEPS", 1)


def holds_batches(device, prefetch: bool, chunked: bool) -> bool:
    """Whether a fit holds a source's batch past its next pull, so a ring
    of view batches (`data/pipeline.py`, copy=False) must yield copies
    for it (`mark_copy_for_stacking`). On CUDA the prefetch thread makes
    a pinned host copy of each batch before it pulls the next, and a
    per-call step is done with its batch before the next pull; the
    chunked paths without prefetch hold K host batches, and on the CPU
    the prefetch queue holds host batches themselves."""
    if prefetch and torch.device(device).type == "cuda":
        return False
    return prefetch or chunked


def scan_incompatible_listeners(listeners) -> bool:
    """Listeners that read the model or capture gradients need
    iteration_done in lockstep with the params; the chunked fit delivers
    it up to 2K-1 steps late, so they force the per-call path."""
    return any(getattr(lst, "wants_gradients", False)
               or getattr(lst, "reads_model", False) for lst in listeners)


def run_scan_pipeline(batches, sig_of, dispatch, process, K, defer=True):
    """Group consecutive batches of one signature into chunks of at most
    K, `dispatch(group, etl_ms)` each, and `process(pending)` chunk i only
    after chunk i+1 is dispatched (defer=False: in lockstep)."""
    pending = None
    group, gsig = [], None
    etl_start = time.perf_counter()

    def flush():
        nonlocal pending, group, etl_start
        etl_end = time.perf_counter()
        monitor.add_span("train/etl", etl_start, etl_end, batches=len(group))
        monitor.counter("train_chunks_dispatched_total",
                        "Scan/accum chunks dispatched to the device").inc()
        with monitor.span("train/dispatch", batches=len(group)):
            fresh = dispatch(group, (etl_end - etl_start) * 1e3)
        if not defer:
            with monitor.span("train/chunk_sync"):
                process(fresh)
        else:
            if pending is not None:
                with monitor.span("train/chunk_sync"):
                    process(pending)
            pending = fresh
        group, etl_start = [], time.perf_counter()

    for b in batches:
        s = sig_of(b)
        if group and (s != gsig or len(group) == K):
            flush()
        group.append(b)
        gsig = s
    if group:
        flush()
    if pending is not None:
        with monitor.span("train/chunk_sync"):
            process(pending)


# --------------------------------------------------------------- structures
def flatten(struct) -> list:
    """Leaves of nested tuples (None is a leaf)."""
    if isinstance(struct, tuple):
        return [leaf for s in struct for leaf in flatten(s)]
    return [struct]


def unflatten(like, leaves):
    """Rebuild `like`'s nesting from `leaves` (consumed in order)."""
    it = iter(leaves)

    def build(s):
        if isinstance(s, tuple):
            return tuple(build(x) for x in s)
        return next(it)
    return build(like)


def signature(struct) -> tuple:
    """Shape and dtype of every leaf (None for an absent one)."""
    return tuple(None if a is None else (tuple(np.shape(a)), dtype_of(a))
                 for a in flatten(struct))


def tree_tensors(*trees) -> list:
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return [t for tree in trees for t in tree_leaves(tree)]


def commit(dst, src):
    """Write the values of tree `src` into the tensors of tree `dst` (one
    structure), so a captured step finds its state where it was captured.
    A leaf whose dtype or shape changed takes the new tensor instead (f32
    batch-norm statistics become f64 in the first step of an f64 network,
    as in the reference's per-call step)."""
    pairs = []

    def walk(d, s):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, s[k])
            elif v is not s[k]:
                if v.dtype == s[k].dtype and v.shape == s[k].shape:
                    pairs.append((v, s[k]))
                else:
                    d[k] = s[k]
    walk(dst, src)
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


# -------------------------------------------------------------- id checks
def check_ids(layer, idx: torch.Tensor, n: int, message: str):
    """Raise ValueError(message) for an id outside [0, n): on CUDA such an
    index trips a device-side assert that poisons the context. Inside a
    capture the device check (a host sync) is not allowed: there the fit
    loop has checked the batch's host array before it was copied in, and
    only the layers it checked may skip."""
    if idx.is_cuda and torch.cuda.is_current_stream_capturing():
        if id(layer) not in getattr(_CAPTURE, "checked", ()):
            raise RuntimeError(
                f"{type(layer).__name__} reads ids that are not a network "
                "input; they cannot be range-checked inside a CUDA graph")
        return
    if bool(((idx < 0) | (idx >= n)).any()):
        raise ValueError(message)


def check_host_ids(a, n: int, message: str):
    """The same check on a host array (float ids truncate, as the
    layer's int64 conversion does)."""
    ids = np.asarray(a).astype(np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(message)


# --------------------------------------------------------- captured steps
class StepGraph:
    """One function captured for one input signature: static input
    buffers, the graph and its output. `bound` holds the tensors the
    capture read (parameters, optimizer and layer state, the affine); a
    replay is valid only while the network still holds those very
    tensors."""

    def __init__(self, like_struct, device):
        self.static = [None if a is None else torch.empty(
            tuple(np.shape(a)), dtype=dtype_of(a), device=device)
            for a in flatten(like_struct)]
        self.struct = unflatten(like_struct, [None] * len(self.static))
        self.bound: Optional[List[torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None

    def valid_for(self, bound: List[torch.Tensor]) -> bool:
        return self.bound is not None and len(bound) == len(self.bound) \
            and all(map(operator.is_, bound, self.bound))

    def load(self, struct):
        """Copy a batch into the static buffers, in stream order."""
        for dst, a in zip(self.static, flatten(struct)):
            if dst is None:
                continue
            if isinstance(a, torch.Tensor) and a.is_cuda:
                dst.copy_(a)
            else:
                dst.copy_(pinned(a), non_blocking=True)

    def inputs(self):
        return unflatten(self.struct, self.static)

    @staticmethod
    def warm_up(fn: Callable):
        """Run `fn` eagerly on a side stream (a real step) and return its
        output."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def capture(self, fn: Callable, bound: List[torch.Tensor],
                generator=None, checked_layers=()):
        g = torch.cuda.CUDAGraph()
        if generator is not None:
            g.register_generator_state(generator)
        _CAPTURE.checked = {id(layer) for layer in checked_layers}
        try:
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            _CAPTURE.checked = ()
        self.graph, self.bound = g, bound

    def replay(self):
        self.graph.replay()
        return self.out


def record_iteration(score: float, batch_size: int,
                      step_seconds: Optional[float] = None,
                      sync_seconds: Optional[float] = None):
    """One optimizer step's worth of telemetry (monitor/metrics.py) —
    shared by every fit path of both containers, so `train_*` series mean
    the same thing everywhere. Only host scalars are touched: `score` is
    the loss the fit already fetched, so no device sync is introduced."""
    monitor.counter("train_iterations_total",
                    "Optimizer steps applied").inc()
    monitor.counter("train_examples_total",
                    "Training examples consumed").inc(batch_size)
    monitor.gauge("train_score", "Last training loss/score").set(score)
    if step_seconds is not None:
        monitor.histogram("train_step_seconds",
                          "Train step wall time (dispatch + host sync)"
                          ).observe(step_seconds)
    if sync_seconds is not None:
        monitor.histogram("train_host_sync_seconds",
                          "Blocking device->host loss fetch per step"
                          ).observe(sync_seconds)


class ChunkedFit:
    """One epoch of the chunked fit for a container. The container gives:

    - `_batch_struct(batch)`: the batch as nested tuples of arrays;
    - `_step_struct(struct, generator)`: one train step on host arrays
      or device tensors, state committed in place; returns the loss;
    - `_grad_struct(struct, generator)`: (loss, grads, new_state,
      new_carries);
    - `_apply_grads(grads, loss)`: the updater chain and the in-place
      update (under a sharding plan the data group's reduction first);
      returns the loss;
    - `_bound_tensors()`: the tensors a captured step reads;
    - `_affine_key()`: what of the device affine a captured step reads;
    - `_id_inputs()`: (flat leaf index, layer, (n, message)) of each
      feature that feeds an embedding, and `_check_ids(batch)`;
    - listeners, counters and `_score`.
    """

    def __init__(self, net, generator):
        self.net = net
        self.gen = generator
        self.cuda = net.device.type == "cuda"
        self._last_mark = None      # the previous chunk's end (MFU clock)

    # ------------------------------------------------------------ helpers
    def _check_group(self, group):
        """Range-check the ids of a chunk's batches before any of its
        steps runs, unless the fit's prefetch thread already did (the
        batch is marked so). The CPU checks in the layers."""
        if self.cuda:
            for batch in group:
                if not getattr(batch, "_host_checked", False):
                    self.net._check_ids(batch)

    def _graph(self, key, struct, extra) -> StepGraph:
        graphs: Dict[Any, StepGraph] = self.net._step_graphs
        g = graphs.get(key)
        if g is None or not g.valid_for(self.net._bound_tensors()
                                        + list(extra)):
            g = graphs[key] = StepGraph(struct, self.net.device)
        return g

    def _run_step(self, key, struct, fn, extra=(), program=None):
        """fn(struct_on_device) -> output, through the graph of `key` on
        CUDA (warm-up, capture or replay), eagerly on the CPU. `extra`:
        tensors besides the network's that fn reads and writes.
        `program` (name, examples, K): with the ledger on, the key's first
        step is its counted step (the warm-up on CUDA; the graph capture
        after it joins the record's capture time; an eager step where the
        graph was captured before the ledger was on)."""
        net = self.net
        count = program is not None and xla_ledger.enabled() \
            and key not in net._ledger_cache
        if not self.cuda:
            if count:
                return net._counted(key, program[0], struct, program[1],
                                    program[2], lambda: fn(struct))[0]
            return fn(struct)
        g = self._graph(key, struct, extra)
        g.load(struct)
        if g.graph is not None:
            if count:
                # captured before the ledger was on: this step runs once
                # eagerly as the counted one (the same update a replay
                # makes), and replays follow
                return net._counted(key, program[0], struct, program[1],
                                    program[2], lambda: fn(g.inputs()))[0]
            return g.replay()

        def capture():
            # the warm-up may rebind widened state (see `commit`): the
            # graph reads what the network holds now
            checked = [layer for _, layer, _ in net._id_inputs()]
            g.capture(lambda: fn(g.inputs()),
                      net._bound_tensors() + list(extra), self.gen, checked)

        if count:
            return net._counted(key, program[0], struct, program[1],
                                program[2],
                                lambda: g.warm_up(lambda: fn(g.inputs())),
                                finish=capture)[0]
        out = g.warm_up(lambda: fn(g.inputs()))
        capture()
        return out

    def _mark(self):
        """The MFU clock's mark at a chunk's end, taken only while the
        ledger is on: a timing event recorded behind the chunk's last
        step on CUDA (no launch, no sync), the host clock on the CPU."""
        if not xla_ledger.enabled():
            return None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _process(self, pending):
        losses, bs, etl_ms, key, fresh, mark, captured = pending
        net = self.net
        for loss in losses.tolist():        # the chunk's one host sync
            net._score = float(loss)
            record_iteration(net._score, bs)
            if captured is not None:
                capture, grads, updates = captured
                captured = None
                for lst in capture:
                    lst.on_gradients(net, net.iteration_count,
                                     net.epoch_count, grads, updates)
            for lst in net.listeners:
                lst.iteration_done(net, net.iteration_count, net.epoch_count,
                                   net._score, etl_ms, bs)
            net.iteration_count += 1
            etl_ms = 0.0
        if mark is None:
            return
        # a chunk's wall time = the spacing of two consecutive chunks'
        # end marks. On CUDA the marks are events on the device timeline:
        # the fetch above is stream-ordered, so it waits for every chunk
        # already queued, and host stamps around it could not tell two
        # chunks apart. The first chunk and the counted one are skipped;
        # the mark advances on EVERY chunk, a ragged tail's included.
        prev, self._last_mark = self._last_mark, mark
        rec = net._ledger_cache.get(key)
        if rec is None or fresh or prev is None:
            return
        seconds = prev.elapsed_time(mark) / 1e3 if self.cuda \
            else mark - prev
        xla_ledger.observe_step(rec, seconds)

    def _fresh(self, key) -> bool:
        """Whether `key`'s step is still to be counted (the chunk that
        counts it must not feed the MFU clock)."""
        fresh = xla_ledger.enabled() and key not in self.net._ledger_cache
        if fresh:
            self._last_mark = None
        return fresh

    def _sig(self, batch):
        return signature(self.net._batch_struct(batch))

    # --------------------------------------------------------------- scan
    def scan(self, batches, K: int):
        net = self.net

        def dispatch(group, etl_ms):
            structs = [net._batch_struct(b) for b in group]
            bs = int(np.shape(flatten(structs[0])[0])[0])
            if len(group) < K:
                # a ragged tail or a shape change: per-call steps, as the
                # reference runs its compiled per-call step there
                losses = [net._step_struct(s, self.gen) for s in structs]
                return torch.stack(losses), bs, etl_ms, None, False, \
                    self._mark(), None
            key = ("scan", signature(structs[0]), net._affine_key())
            fresh = self._fresh(key)
            program = ("scan_step", bs * K, K)
            self._check_group(group)
            buf = None
            for i, s in enumerate(structs):
                loss = self._run_step(
                    key, s, lambda st: net._step_struct(st, self.gen),
                    program=program)
                if buf is None:
                    buf = torch.empty(len(group), dtype=loss.dtype,
                                      device=loss.device)
                buf[i].copy_(loss)
            return buf, bs, etl_ms, key, fresh, self._mark(), None

        run_scan_pipeline(batches, self._sig, dispatch, self._process, K)

    # --------------------------------------------------------- accumulate
    def accumulate(self, batches, K: int, defer: bool):
        net = self.net
        shapes = net._grad_shapes()
        acc = net._accum_buffers
        if acc is None or len(acc["gsum"]) != len(shapes) or not all(
                g.shape == shape and g.dtype == dtype
                for g, (shape, dtype) in zip(acc["gsum"], shapes)):
            score_dtype = torch.promote_types(torch.float32, torch.promote_types(
                net._compute_dtype, net._param_dtype))
            acc = net._accum_buffers = {
                "gsum": [torch.zeros(shape, dtype=dtype, device=net.device)
                         for shape, dtype in shapes],
                "lsum": torch.zeros((), dtype=score_dtype, device=net.device),
                "n": torch.zeros((), dtype=torch.float32, device=net.device)}
        extra = acc["gsum"] + [acc["lsum"], acc["n"]]

        def micro(struct):
            loss, grads, new_state, _ = net._grad_struct(struct, self.gen)
            torch._foreach_add_(acc["gsum"], tree_tensors(grads))
            net._commit_state(new_state)
            acc["lsum"].add_(loss)
            return acc["lsum"]

        def update():
            from deeplearning4j_tpu_torch.nn.updaters import tree_map
            it = iter(acc["gsum"])
            n = acc["n"]
            grads = tree_map(lambda p: next(it) / n.to(p.dtype), net.params)
            loss = net._apply_grads(grads,
                                    acc["lsum"] / n.to(acc["lsum"].dtype))
            torch._foreach_zero_(acc["gsum"])
            acc["lsum"].zero_()
            return loss

        def dispatch(group, etl_ms):
            structs = [net._batch_struct(b) for b in group]
            self._check_group(group)
            key = ("micro", signature(structs[0]), net._affine_key())
            fresh = self._fresh(key)
            bs = int(np.shape(flatten(structs[0])[0])[0]) * len(group)
            # the ledger counts one micro-step (the update is not counted)
            # and scales it by the group's length, as the reference's
            # accumulation program does
            program = ("accum_step", bs, len(group))
            for s in structs:
                self._run_step(("micro", signature(s), net._affine_key()),
                               s, micro, extra, program=program)
            acc["n"].fill_(float(len(group)))
            # gradient listeners force lockstep (`defer=False`), so the
            # iteration count here is the step being reported; a capture
            # step runs its update eagerly, outside the captured graph
            capture = net._gradient_capture()
            captured = None
            if capture:
                loss, grads, updates = net._capturing(update)
                captured = (capture, grads, updates)
            else:
                loss = self._run_step(("update",), (), lambda _: update(),
                                      extra)
            return loss.reshape(1).clone(), bs, etl_ms, key, fresh, \
                self._mark(), captured

        run_scan_pipeline(batches, self._sig, dispatch, self._process, K,
                          defer=defer)
