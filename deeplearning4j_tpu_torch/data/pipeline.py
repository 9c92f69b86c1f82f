"""Multi-process ETL over shared-memory ring buffers: the host half of
the data plane.

A copy of the JAX package's `data/pipeline.py` (numpy and the standard
library only: spawned workers import this module, so it never imports
torch and never touches CUDA), under the port's names and knobs.

N worker processes decode batches into ``multiprocessing.shared_memory``
ring-buffer slots sized to the batch shape; batches cross the process
boundary by BUFFER HANDOFF (a slot index over a queue), never by
pickling the arrays. The consumer side is an ordinary DataSetIterator,
so fit's default prefetch (`data/async_iterator.AsyncDataSetIterator`:
a pinned host copy and an asynchronous device copy on a stream of its
own) consumes the ring directly: worker decode, the device copy and the
train step all overlap.

Roles:

- ``MultiProcessDataSetIterator``: the ring, the worker pool and
  in-order delivery. Takes a picklable *batch loader* (below) that fills
  preallocated slot arrays in place inside the worker.
- ``ShardBatchLoader``: reads `data/shards.py` shard directories (each
  worker holds its own memmaps).
- ``ImageFileBatchLoader``: PIL decode of image files, the
  multi-process replacement for the per-sample loop of
  ``records.RecordReaderDataSetIterator`` (which delegates here for
  large datasets; see ``etl_workers``).

Delivery is strictly in submission order (an out-of-order completion is
parked until its turn), so the batch stream is bitwise the in-process
path's.

Lifetime contract: by default (``copy=True``) each yielded batch is
copied out of its ring slot and is safe to hold indefinitely.
``copy=False`` yields VIEWS into the slot's shared memory, valid only
until the next batch is requested. The fits that hold a batch past the
next pull flip view-batch sources into copy mode for their duration
(``mark_copy_for_stacking``). Call ``close()`` (or use as a context
manager) to stop the workers and unlink the shared memory; a weakref
finalizer covers dropped instances and interpreter exit.

Counters: ``stats`` holds the batches and decode seconds by worker
(``"inproc"`` in the 0-worker mode) and the consumer's fetch waits (how
many, and their seconds): the time the consumer spent blocked on the
ring for its next batch. A fit is ETL-bound when the fetch wait is large
while the workers' decode seconds stay busy. The same counts feed the
reference's families: ``etl_worker_batches_total{worker}``,
``etl_worker_decode_seconds{worker}``, ``etl_ring_ready_depth`` and
``etl_ring_inflight`` (`monitor/`, torch-free like this module).

Env knobs (`util/env.py`, ``=="0"``-disables):

- ``DL4J_CUDA_ETL_WORKERS``: worker count; ``0`` disables (in-process
  mode), default ``auto`` = min(4, cpus) for datasets of at least
  ``DL4J_CUDA_ETL_MIN_RECORDS`` (default 512) records.
- ``DL4J_CUDA_ETL_RING_SLOTS``: ring depth (default workers + 2).
- ``DL4J_CUDA_ETL_MP_START``: multiprocessing start method (default
  ``spawn``: a forked child of a process that has initialised CUDA
  cannot use it, and fork-safety around torch's thread pools beats the
  per-worker import cost, which is paid once per pipeline).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import time
import traceback
import weakref
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.data.shards import (
    EpochPositionMixin, ShardSet, decode_labels, epoch_batches,
    epoch_order,
)
from deeplearning4j_tpu_torch.util.env import env_int, env_str


def etl_workers(n_records: Optional[int] = None) -> int:
    """Resolve the ETL worker count: DL4J_CUDA_ETL_WORKERS (0 disables).
    ``auto`` (default) engages min(4, cpus) workers only for datasets big
    enough to amortize worker startup (DL4J_CUDA_ETL_MIN_RECORDS, default
    512), so tiny datasets stay in-process."""
    v = env_str("DL4J_CUDA_ETL_WORKERS", "auto")
    if v != "auto":
        return max(0, int(v))
    floor = env_int("DL4J_CUDA_ETL_MIN_RECORDS", 512)
    if n_records is None or n_records < floor:
        return 0
    return min(4, os.cpu_count() or 1)


def _mp_context():
    method = env_str("DL4J_CUDA_ETL_MP_START", "spawn")
    return mp.get_context(method)


def mark_copy_for_stacking(source) -> list:
    """Ring batches are VIEWS into shared-memory slots recycled on the
    next pull: safe for a consumer that is done with each batch before it
    pulls the next, UNSAFE for a fit that holds batches across pulls (a
    chunk of K batches, a prefetch queue of host batches). Such fits call
    this to flip every view-batch iterator in the wrapper chain (walked
    via `_source`) into copy mode for the fit's duration; it returns the
    flipped iterators so the caller can restore them in a finally
    block."""
    changed = []
    seen = set()
    it = source
    while it is not None and id(it) not in seen:
        seen.add(id(it))
        if getattr(it, "view_batches", False) \
                and not getattr(it, "_copy", False):
            it._copy = True
            changed.append(it)
        it = getattr(it, "_source", None)
    return changed


def restore_view_batches(changed) -> None:
    """Undo `mark_copy_for_stacking`."""
    for it in changed:
        it._copy = False


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach WITHOUT registering with the resource tracker: the parent
    owns the segments (it registered at create time); a second
    registration from the child would make the shared tracker process
    double-unlink and log KeyErrors at exit."""
    try:
        from multiprocessing import resource_tracker
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig
    except ImportError:
        return shared_memory.SharedMemory(name=name)


def _create_segment(size: int, ring_bytes: int) -> shared_memory.SharedMemory:
    """One ring segment, its pages reserved up front: a sparse tmpfs
    segment would fault (SIGBUS) on a later write when /dev/shm fills,
    so a shortfall raises here, naming the ring's bytes."""
    try:
        shm = shared_memory.SharedMemory(create=True, size=max(size, 1))
    except OSError as e:
        # graftlint: disable=resource-pairing -- this raise is on the path where SharedMemory() itself failed: no segment exists to release
        raise MemoryError(
            f"ETL ring: cannot create a {size}-byte shared-memory segment "
            f"({e}); the ring needs {ring_bytes} bytes in /dev/shm. Lower "
            f"DL4J_CUDA_ETL_RING_SLOTS or the batch size") from e
    try:
        fd = getattr(shm, "_fd", -1)
        if fd >= 0 and hasattr(os, "posix_fallocate"):
            os.posix_fallocate(fd, 0, max(size, 1))
    except OSError as e:
        shm.close()
        shm.unlink()
        raise MemoryError(
            f"ETL ring: /dev/shm cannot back a {size}-byte segment ({e}); "
            f"the ring needs {ring_bytes} bytes there. Lower "
            f"DL4J_CUDA_ETL_RING_SLOTS or the batch size") from e
    return shm


def _release_resources(procs, shms, task_q):
    """Stop workers and unlink the shared-memory ring. A module-level
    function taking the raw resources (NOT a bound method): it backs the
    weakref.finalize hook, which must not hold a strong reference to the
    iterator."""
    for _ in procs:
        try:
            task_q.put(None)
        except (OSError, ValueError):
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
    try:
        task_q.close()
        task_q.cancel_join_thread()
    except (OSError, ValueError):
        pass
    for shm in shms:
        try:
            shm.close()
            shm.unlink()
        except OSError:
            pass


def _worker_main(wid: int, loader, spec: dict, slot_names: List[dict],
                 task_q, free_q, ready_q, cur_gen):
    """Worker loop: pull a task, grab a free slot, fill it in place via
    the loader, hand the slot index back. Runs until the None sentinel.
    Only numpy and the loader run here: the worker never initializes a
    device."""
    shms, views = [], []
    try:
        fshape, fdt = spec["features"]
        for names in slot_names:
            fshm = _attach(names["features"])
            feats = np.ndarray(fshape, dtype=np.dtype(fdt),
                               buffer=fshm.buf)
            lshm = labels = None
            if spec.get("labels") is not None:
                lshape, ldt = spec["labels"]
                lshm = _attach(names["labels"])
                labels = np.ndarray(lshape, dtype=np.dtype(ldt),
                                    buffer=lshm.buf)
            shms += [s for s in (fshm, lshm) if s is not None]
            views.append((feats, labels))
        while True:
            task = task_q.get()
            if task is None:
                break
            gen, seq, payload = task
            if gen < cur_gen.value:
                # abandoned epoch: don't burn a slot (or the decode) on a
                # batch nobody will consume; ack it so the parent's
                # inflight accounting still drains
                ready_q.put(("skip", gen, seq))
                continue
            slot = free_q.get()
            feats, labels = views[slot]
            try:
                t0 = time.perf_counter()
                n = loader.load(payload, feats, labels)
                dt = time.perf_counter() - t0
                ready_q.put(("ok", gen, seq, slot, wid, dt,
                             feats.shape[0] if n is None else int(n)))
            except BaseException:
                free_q.put(slot)
                ready_q.put(("err", gen, seq, wid,
                             traceback.format_exc()))
    except (KeyboardInterrupt, EOFError, OSError):
        pass
    finally:
        views = None
        for s in shms:
            try:
                s.close()
            except (OSError, BufferError):
                pass
        # skip interpreter teardown (inherited atexit hooks from the
        # parent must not run twice)
        os._exit(0)


class MultiProcessDataSetIterator(EpochPositionMixin, DataSetIterator):
    """DataSetIterator over a worker pool and a shared-memory ring (module
    docstring has the architecture). ``loader`` must be picklable and
    provide::

        spec()        -> {"features": (batch_shape, dtype_str),
                          "labels":   (batch_shape, dtype_str) | None,
                          "n_batches": int, "batch_size": int}
        tasks(epoch)  -> sequence of picklable payloads, one per batch,
                         in delivery order
        load(payload, feats_out, labels_out) -> n_valid | None
                         (fills the slot arrays IN PLACE, in the worker)

    Position semantics are ShardDataSetIterator's exactly (the SAME
    implementation, shards.EpochPositionMixin), in BOTH the worker and
    the 0-worker mode: ``seek``/``tell``/``stream_state``, epoch
    auto-advance on an exhausted re-``__iter__``, resume-at-position for
    a partially-consumed pass.
    """

    @property
    def view_batches(self):
        """True only in copy=False mode: batches are slot views with a
        bounded lifetime (see mark_copy_for_stacking)."""
        return not self._copy

    def __init__(self, loader, num_workers: Optional[int] = None,
                 slots: Optional[int] = None, copy: bool = True,
                 name: str = "etl"):
        self._loader = loader
        self._spec = loader.spec()
        self.n_batches = int(self._spec["n_batches"])
        self._batch = int(self._spec["batch_size"])
        self._copy = copy
        self._name = name
        # 0 workers (explicit, or DL4J_CUDA_ETL_WORKERS=0 / the auto rule
        # via env) = synchronous in-process mode: the loader runs in the
        # parent, no processes or shared memory
        self._workers_n = max(0, int(
            num_workers if num_workers is not None
            else etl_workers(self.n_batches * self._batch)))
        self._slots_n = int(slots if slots is not None else env_int(
            "DL4J_CUDA_ETL_RING_SLOTS", self._workers_n + 2))
        self._slots_n = max(2, self._slots_n)
        self._init_position()
        self._gen = 0
        self._inflight = 0          # tasks submitted, slot not yet reaped
        self._started = False
        self._closed = False
        self._procs: List = []
        self._shms: List[shared_memory.SharedMemory] = []
        self._views: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        self._slot_names: List[dict] = []
        self.stats = {"batches": {}, "decode_s": {},
                      "fetch_wait_count": 0, "fetch_wait_s": 0.0}

    @property
    def num_workers(self) -> int:
        return self._workers_n

    @property
    def ring_bytes(self) -> int:
        """Shared memory the ring holds: slots x (features + labels) of
        one batch (0 in the in-process mode)."""
        if self._workers_n == 0:
            return 0
        total = 0
        for part in ("features", "labels"):
            spec = self._spec.get(part)
            if spec is not None:
                shape, dt = spec
                total += int(np.dtype(dt).itemsize
                             * int(np.prod(shape, dtype=np.int64)))
        return self._slots_n * total

    def _count(self, wid, dt: float):
        """Count one delivered batch in `stats` and in the reference's
        `etl_worker_*` families (worker id, or "inproc")."""
        key = str(wid)
        self.stats["batches"][key] = self.stats["batches"].get(key, 0) + 1
        self.stats["decode_s"][key] = \
            self.stats["decode_s"].get(key, 0.0) + dt
        monitor.counter(
            "etl_worker_batches_total",
            "Batches decoded by multi-process ETL workers",
            ("worker",)).inc(worker=key)
        monitor.histogram(
            "etl_worker_decode_seconds",
            "Worker-side batch decode/fill time",
            ("worker",)).observe(dt, worker=key)

    # ------------------------------------------------------------ lifecycle
    def _ensure_started(self):
        # closed beats started: a closed pipeline's queues and views are
        # gone even if it ran before, so iterating it again must fail
        # loudly here, not with an obscure mp.Queue error downstream
        if self._closed:
            raise RuntimeError("pipeline is closed")
        if self._started:
            return
        if self._workers_n == 0:        # sync mode: nothing to start
            self._started = True
            return
        ctx = _mp_context()
        ring = self.ring_bytes
        fshape, fdt = self._spec["features"]
        fbytes = int(np.dtype(fdt).itemsize
                     * int(np.prod(fshape, dtype=np.int64)))
        lspec = self._spec.get("labels")
        # the finalizer is registered before the first segment exists, so
        # a failure part way through creation still unlinks what exists
        self._task_q = ctx.Queue()
        self._finalizer = weakref.finalize(
            self, _release_resources, self._procs, self._shms,
            self._task_q)
        try:
            for _ in range(self._slots_n):
                fshm = _create_segment(fbytes, ring)
                self._shms.append(fshm)
                names = {"features": fshm.name}
                feats = np.ndarray(fshape, dtype=np.dtype(fdt),
                                   buffer=fshm.buf)
                labels = None
                if lspec is not None:
                    lshape, ldt = lspec
                    lbytes = int(np.dtype(ldt).itemsize
                                 * int(np.prod(lshape, dtype=np.int64)))
                    lshm = _create_segment(lbytes, ring)
                    self._shms.append(lshm)
                    names["labels"] = lshm.name
                    labels = np.ndarray(lshape, dtype=np.dtype(ldt),
                                        buffer=lshm.buf)
                self._views.append((feats, labels))
                self._slot_names.append(names)
        except BaseException:
            self._views = []
            self._closed = True
            self._finalizer()
            raise
        self._free_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        self._gen_val = ctx.Value("l", self._gen)
        for i in range(self._slots_n):
            self._free_q.put(i)
        for wid in range(self._workers_n):
            p = ctx.Process(
                target=_worker_main,
                args=(wid, self._loader, self._spec, self._slot_names,
                      self._task_q, self._free_q, self._ready_q,
                      self._gen_val),
                daemon=True, name=f"{self._name}-worker-{wid}")
            p.start()
            self._procs.append(p)
        self._started = True

    def close(self):
        """Stop the workers and unlink the shared memory (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._started and self._workers_n > 0:
            try:
                # everything still queued is stale now: workers skip-ack
                self._gen_val.value = self._gen + 1
                self._drain_inflight()
            # graftlint: disable=bare-except-swallow -- best-effort drain while closing a possibly-dead pool; the finalizer (sentinels+join+unlink) still runs and close() must never raise over the original failure
            except Exception:
                pass
            self._finalizer()       # sentinels + join + unlink, once
            for q in (self._free_q, self._ready_q):
                try:
                    q.close()
                    q.cancel_join_thread()
                except (OSError, ValueError):
                    pass
        self._views = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ contract
    def batch_size(self):
        return self._batch

    # ------------------------------------------------------------ position
    def stream_state(self) -> dict:
        """Exact resume position (epoch + next batch ordinal; the
        loader's tasks(epoch) order is deterministic, so this names the
        next payload unambiguously)."""
        return {"epoch": self._epoch, "next_batch": self._pos}

    # ------------------------------------------------------------- plumbing
    def _get_ready(self, timeout: Optional[float] = None):
        """ready_q.get that cannot hang on a dead pool: polls in 1 s
        slices and raises if every worker exited while work is pending
        (a spawn-time import crash would otherwise block forever), or if
        SOME worker died and nothing arrives for a grace period: a worker
        killed mid-task (OOM, segfault) takes its batch's sequence number
        with it, and waiting on that seq with the survivors idle would
        otherwise hang the fit forever."""
        deadline = None if timeout is None else time.monotonic() + timeout
        stuck = 0.0     # seconds of empty polls within THIS call
        while True:
            try:
                return self._ready_q.get(timeout=1.0)
            except _queue.Empty:
                stuck += 1.0
                dead = [(p.name, p.exitcode) for p in self._procs
                        if not p.is_alive()]
                if dead and len(dead) < len(self._procs) and stuck >= 30.0:
                    raise RuntimeError(
                        f"ETL worker(s) {dead} died mid-stream with "
                        f"{self._inflight} task(s) in flight and no "
                        f"completion for {int(stuck)}s — a batch held by "
                        f"a dead worker can never be delivered (in-order "
                        f"contract). Likely an OOM kill or a crash in "
                        f"the loader; rerun with DL4J_CUDA_ETL_WORKERS=0 "
                        f"to decode in-process and surface the error")
                if all(not p.is_alive() for p in self._procs):
                    codes = [p.exitcode for p in self._procs]
                    raise RuntimeError(
                        f"all ETL workers exited (exit codes {codes}) "
                        f"with {self._inflight} task(s) in flight. If "
                        f"this happened at startup from a script, the "
                        f"usual cause is an unguarded entry point: "
                        f"multiprocessing 'spawn' re-imports the main "
                        f"module, so wrap the script body in "
                        f"`if __name__ == '__main__':` (or set "
                        f"DL4J_CUDA_ETL_MP_START=fork on Linux before "
                        f"CUDA is initialised, or DL4J_CUDA_ETL_WORKERS=0 "
                        f"to stay in-process)")
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ETL ring drain timed out after {timeout:.0f}s "
                        f"with {self._inflight} task(s) in flight and "
                        f"{len(self._procs) - len(dead)} live worker(s) "
                        f"— a stale-batch decode is stuck or its ack "
                        f"was lost")

    def _drain_inflight(self):
        """Reap every submitted-but-unconsumed completion (abandoned
        epoch / teardown), returning slots to the free ring. Workers see
        the bumped generation and "skip"-ack stale tasks without decoding
        them, so this drains at queue speed, not decode speed."""
        while self._inflight > 0:
            item = self._get_ready(timeout=60)
            if item[0] == "ok":
                self._free_q.put(item[3])
            self._inflight -= 1

    def _reap(self, want_gen: int):
        """Block for one completion of `want_gen`; park nothing: stale
        generations get their slot back immediately, errors raise."""
        while True:
            item = self._get_ready()
            if item[0] == "skip":       # stale task, never decoded
                self._inflight -= 1
                continue
            if item[0] == "err":
                _, gen, seq, wid, tb = item
                self._inflight -= 1
                if gen != want_gen:
                    continue
                raise RuntimeError(
                    f"ETL worker {wid} failed on batch {seq}:\n{tb}")
            _, gen, seq, slot, wid, dt, n = item
            if gen != want_gen:         # abandoned epoch: recycle
                self._free_q.put(slot)
                self._inflight -= 1
                continue
            return seq, slot, wid, dt, n

    def _iter_sync(self):
        """0-worker mode: run the loader in the parent process: identical
        stream (same tasks/epoch_order/decode rules), no processes or
        shared memory. This is what DL4J_CUDA_ETL_WORKERS=0 means for
        pipelines constructed with num_workers=None."""
        fshape, fdt = self._spec["features"]
        feats = np.empty(fshape, dtype=np.dtype(fdt))
        labels = None
        if self._spec.get("labels") is not None:
            lshape, ldt = self._spec["labels"]
            labels = np.empty(lshape, dtype=np.dtype(ldt))
        tasks = list(self._loader.tasks(self._epoch))
        # resume at _pos, exactly as the worker path does: the =0 kill
        # switch must not change what the stream delivers
        for payload in tasks[self._pos:]:
            t0 = time.perf_counter()
            n = self._loader.load(payload, feats, labels)
            n = feats.shape[0] if n is None else int(n)
            self._count("inproc", time.perf_counter() - t0)
            ds = DataSet(feats[:n], None if labels is None else labels[:n])
            if self._copy:      # the buffers are reused next iteration
                ds = DataSet(np.array(ds.features, copy=True),
                             None if ds.labels is None
                             else np.array(ds.labels, copy=True))
            self._pos += 1
            yield self._pp(ds)

    def __iter__(self):
        self._ensure_started()
        self._begin_pass()
        if self._workers_n == 0:
            yield from self._iter_sync()
            return
        self._gen += 1
        gen = self._gen
        self._gen_val.value = gen   # workers skip-ack older generations
        self._drain_inflight()
        tasks = list(self._loader.tasks(self._epoch))
        # bounded submission window: enough outstanding tasks to keep
        # every slot and worker busy, topped up one per consumed batch
        window = self._slots_n + self._workers_n
        submitted = self._pos
        while submitted < min(self._pos + window, len(tasks)):
            self._task_q.put((gen, submitted, tasks[submitted]))
            self._inflight += 1
            submitted += 1
        pending = {}
        prev_slot = None
        stats = self.stats
        m_ready = monitor.gauge(
            "etl_ring_ready_depth",
            "Completed ring slots waiting for the consumer")
        m_inflight = monitor.gauge(
            "etl_ring_inflight", "Submitted ETL tasks not yet consumed")
        try:
            for want in range(self._pos, len(tasks)):
                # the consumer re-entered the generator: the previous
                # batch's validity window is over; free its slot BEFORE
                # blocking, so the ring can't starve while we wait
                if prev_slot is not None:
                    self._free_q.put(prev_slot)
                    prev_slot = None
                t_wait = time.perf_counter()
                while want not in pending:
                    seq, slot, wid, dt, n = self._reap(gen)
                    if seq == want:
                        pending[seq] = ("slot", slot, wid, dt, n)
                    else:
                        # out-of-order completion: COPY it out and free
                        # the slot immediately. Parked entries must never
                        # sequester slots, or the worker holding the
                        # wanted batch could never acquire one and the
                        # ring would deadlock.
                        feats, labels = self._views[slot]
                        arrs = (np.array(feats[:n], copy=True),
                                None if labels is None
                                else np.array(labels[:n], copy=True))
                        self._free_q.put(slot)
                        pending[seq] = ("copy", arrs, wid, dt, n)
                    m_ready.set(len(pending))
                stats["fetch_wait_count"] += 1
                stats["fetch_wait_s"] += time.perf_counter() - t_wait
                kind, payload, wid, dt, n = pending.pop(want)
                if submitted < len(tasks):    # top up the window
                    self._task_q.put((gen, submitted, tasks[submitted]))
                    self._inflight += 1
                    submitted += 1
                self._count(wid, dt)
                m_ready.set(len(pending))
                m_inflight.set(self._inflight - 1)
                if kind == "slot":
                    feats, labels = self._views[payload]
                    ds = DataSet(
                        feats[:n], None if labels is None else labels[:n])
                    if self._copy:
                        # the batch is owned now: recycle the slot at once
                        ds = DataSet(np.array(ds.features, copy=True),
                                     None if ds.labels is None
                                     else np.array(ds.labels, copy=True))
                        self._free_q.put(payload)
                    else:
                        prev_slot = payload
                else:
                    ds = DataSet(payload[0], payload[1])
                self._inflight -= 1
                self._pos += 1
                yield self._pp(ds)
        finally:
            if prev_slot is not None:
                self._free_q.put(prev_slot)
            for kind, payload, *_ in pending.values():
                if kind == "slot":
                    self._free_q.put(payload)
                self._inflight -= 1


# ------------------------------------------------------------------ loaders
class ShardBatchLoader:
    """Batch loader over a `data/shards.py` shard directory. Each worker
    opens its OWN memmaps (lazily, on first load): read parallelism
    without sharing file handles. Uses the same epoch_order /
    decode_labels rules as ShardDataSetIterator, so the delivered stream
    is bitwise the in-process path's."""

    def __init__(self, shard_dir: str, batch_size: int,
                 num_classes: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.shard_dir = shard_dir
        self.batch = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        sset = ShardSet(shard_dir)      # parent-side: schema only
        self.n_records = sset.n_records
        self.num_classes = num_classes if num_classes is not None \
            else sset.num_classes
        self._feat_schema = sset.feat_schema
        self._label_schema = sset.label_schema
        self.n_batches = epoch_batches(self.n_records, self.batch,
                                       drop_last)
        self._set: Optional[ShardSet] = None    # worker-side, lazy

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_set"] = None            # memmaps never cross the boundary
        return state

    def spec(self) -> dict:
        fshape = (self.batch, *self._feat_schema["shape"])
        lspec = None
        if self._label_schema is not None:
            if (self.num_classes
                    and np.issubdtype(np.dtype(self._label_schema["dtype"]),
                                      np.integer)
                    and not self._label_schema["shape"]):
                lspec = ((self.batch, int(self.num_classes)), "<f4")
            else:
                lspec = ((self.batch, *self._label_schema["shape"]),
                         self._label_schema["dtype"])
        return {"features": (fshape, self._feat_schema["dtype"]),
                "labels": lspec, "n_batches": self.n_batches,
                "batch_size": self.batch}

    def tasks(self, epoch: int):
        order = epoch_order(self.n_batches, self.shuffle, self.seed, epoch)
        return [(int(bi) * self.batch,
                 min(int(bi) * self.batch + self.batch, self.n_records))
                for bi in order]

    def load(self, payload, feats_out, labels_out):
        if self._set is None:
            self._set = ShardSet(self.shard_dir)
        lo, hi = payload
        feats, raw = self._set.read(lo, hi)
        n = hi - lo
        feats_out[:n] = feats
        if labels_out is not None:
            labels_out[:n] = decode_labels(raw, self.num_classes)
        return n


class ImageFileBatchLoader:
    """Decode image FILES in worker processes: the multi-process
    replacement for the per-sample PIL loop of
    records.RecordReaderDataSetIterator. Workers receive the full
    (path, label_idx) list once at spawn; per-batch payloads are just
    (lo, hi) index ranges into it. Output batches are bitwise the
    in-process path's (same load_image and one-hot rules)."""

    def __init__(self, files, height: int, width: int, channels: int,
                 batch_size: int, num_classes: Optional[int] = None,
                 regression: bool = False, normalize: bool = False):
        self.files = list(files)        # [(path, label_idx)]
        self.h, self.w, self.c = int(height), int(width), int(channels)
        self.batch = int(batch_size)
        self.num_classes = num_classes
        self.regression = regression
        self.normalize = normalize
        self.n_batches = (len(self.files) + self.batch - 1) // self.batch

    def spec(self) -> dict:
        fdt = "<f4" if self.normalize else "|u1"
        if self.num_classes is not None:
            lspec = ((self.batch, int(self.num_classes)), "<f4")
        elif self.regression:
            lspec = ((self.batch, 1), "<f4")
        else:
            lspec = None
        return {"features": ((self.batch, self.h, self.w, self.c), fdt),
                "labels": lspec, "n_batches": self.n_batches,
                "batch_size": self.batch}

    def tasks(self, epoch: int):
        return [(i, min(i + self.batch, len(self.files)))
                for i in range(0, len(self.files), self.batch)]

    def load(self, payload, feats_out, labels_out):
        from deeplearning4j_tpu_torch.data.records import load_image
        from deeplearning4j_tpu_torch.data.shards import one_hot_labels
        lo, hi = payload
        n = hi - lo
        labs = np.empty((n,), np.int64)
        for i, (path, lab) in enumerate(self.files[lo:hi]):
            feats_out[i] = load_image(path, self.h, self.w, self.c,
                                      self.normalize)
            labs[i] = lab
        if labels_out is not None:
            if self.regression:
                labels_out[:n] = labs.astype("float32")[:, None]
            else:
                labels_out[:n] = one_hot_labels(labs, self.num_classes)
        return n
