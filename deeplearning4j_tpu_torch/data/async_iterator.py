"""Asynchronous prefetching iterator.

Counterpart of the JAX package's `data/async_iterator.py` (DL4J's
AsyncDataSetIterator, which every fit wraps by default): a background
thread pulls batches from the source into a bounded queue, so host ETL
overlaps device compute. On CUDA the worker also starts the host->device
copy: it stages each array in pinned host memory and copies it with
``non_blocking=True`` on a stream of its own, then records an event that
the consumer's stream waits on before the batch is used. The default
depth of 2 is double buffering: batch i+1 is staged while batch i
computes.

Arrays keep their source dtype (uint8 pixels stay uint8); the network
casts on the device. (The reference host-casts f32 to bf16 before the
copy, with ml_dtypes; both round to nearest even, so the values agree.)

Environment knobs, each under the ``=="0"``-disables contract of
`util/env.py`:

- ``DL4J_CUDA_PREFETCH_DEPTH``: queue depth of fit's wrap and of
  `prefetch_iterable` (default 2); ``0`` stages each batch synchronously
  on the consumer's thread.
- ``DL4J_CUDA_FIT_PREFETCH``: ``0`` skips fit's wrap altogether.

Telemetry (monitor/), the reference's families: `etl_queue_depth` tracks
the prefetch buffer fill, `etl_fetch_wait_seconds` how long the consumer
(the train loop) blocked on it, `etl_batches_prefetched_total` and
`etl_stage_seconds` the worker's batches and staging time, which also
shows as `etl/stage` spans on the prefetch thread's trace track.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.util.env import env_flag, env_int

_SENTINEL = object()


def prefetch_depth(default: int = 2) -> int:
    """DL4J_CUDA_PREFETCH_DEPTH (default 2: double buffered); 0 disables
    the prefetch thread."""
    return max(0, env_int("DL4J_CUDA_PREFETCH_DEPTH", default))


def fit_prefetch_enabled() -> bool:
    """DL4J_CUDA_FIT_PREFETCH: ONLY ``"0"`` disables fit's async wrap."""
    return env_flag("DL4J_CUDA_FIT_PREFETCH")


def prefetch_iterable(source, transform: Optional[Callable] = None,
                      queue_size: Optional[int] = None):
    """Pull items from `source` on a background thread, apply `transform`
    there, and yield them in order. An exception in the worker is raised
    in the consumer. `queue_size` defaults to DL4J_CUDA_PREFETCH_DEPTH; 0
    gives a synchronous generator that still applies `transform`."""
    if queue_size is None:
        queue_size = prefetch_depth()
    if int(queue_size) <= 0:
        return (item if transform is None else transform(item)
                for item in source)
    return _prefetch_pump(source, transform, int(queue_size))


def _prefetch_pump(source, transform, queue_size: int):
    q: "queue.Queue" = queue.Queue(maxsize=queue_size)
    stop = threading.Event()
    m_depth = monitor.gauge("etl_queue_depth",
                            "Prefetch queue fill (async ETL)")
    m_wait = monitor.histogram("etl_fetch_wait_seconds",
                               "Consumer wait on the prefetch queue")
    m_batches = monitor.counter("etl_batches_prefetched_total",
                                "Batches staged by prefetch workers")
    m_stage = monitor.histogram("etl_stage_seconds",
                                "Worker-side batch staging (cast + "
                                "device_put + callback)")

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                m_depth.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if stop.is_set():
                    return
                if transform is not None:
                    t0 = time.perf_counter()
                    with monitor.span("etl/stage"):
                        item = transform(item)
                    m_stage.observe(time.perf_counter() - t0)
                m_batches.inc()
                if not put(item):
                    return
        except BaseException as e:   # handed to the consumer, which raises
            put(e)
            return
        put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="etl-prefetch")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            m_wait.observe(time.perf_counter() - t0)
            m_depth.set(q.qsize())
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)


def dtype_of(a) -> torch.dtype:
    """The torch dtype of a tensor or of a host array."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def pinned(a) -> torch.Tensor:
    """A host array as a tensor in pinned memory (one copy)."""
    if isinstance(a, torch.Tensor):
        return a.pin_memory()
    a = np.asarray(a)
    t = torch.empty(a.shape, dtype=dtype_of(a), pin_memory=True)
    t.numpy()[...] = a
    return t


class DeviceStager:
    """Copies tuples of host arrays to one device. On CUDA the copies run
    on the stager's own stream from pinned memory and end in an event;
    `ready` makes the consumer's stream wait on it. Arrays already on the
    device pass through; on the CPU nothing is copied."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def stage(self, arrays: Sequence):
        if self.stream is None:
            return tuple(arrays), None
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for a in arrays:
                if a is None or (isinstance(a, torch.Tensor)
                                 and a.device == self.device):
                    out.append(a)
                else:
                    out.append(pinned(a).to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return tuple(out), event

    def ready(self, staged) -> tuple:
        arrays, event = staged
        if event is None:
            return arrays
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in arrays:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        return arrays


def prefetch_to_device(source, device, to_arrays: Callable,
                       from_arrays: Callable, check: Optional[Callable] = None,
                       queue_size: Optional[int] = None):
    """Yield `source`'s items with their arrays on `device`, staged by a
    prefetch thread: the worker runs `check(item)` (a host-side input
    check), copies `to_arrays(item)`, and the consumer gets
    `from_arrays(item, device_arrays)` once the copies are ordered before
    its stream's next work, marked `_host_checked` when `check` ran."""
    stager = DeviceStager(device)

    def transform(item):
        if check is not None:
            check(item)
        return item, stager.stage(to_arrays(item))

    for item, staged in prefetch_iterable(source, transform, queue_size):
        out = from_arrays(item, stager.ready(staged))
        if check is not None:
            out._host_checked = True
        yield out


def dataset_arrays(ds: DataSet) -> tuple:
    return (ds.features, ds.labels, ds.features_mask, ds.labels_mask)


class AsyncDataSetIterator(DataSetIterator):
    """Prefetching wrapper of a DataSetIterator (DL4J
    AsyncDataSetIterator). Each batch reaches the consumer with its
    arrays on `device` (default the CPU: no copy; `prefetch_to_device`);
    `check` runs on the worker on the host batch first. A source with
    ``async_supported = False`` passes through unwrapped. `queue_size`
    defaults to DL4J_CUDA_PREFETCH_DEPTH; 0 stages synchronously."""

    def __init__(self, source: DataSetIterator,
                 queue_size: Optional[int] = None, device=None,
                 check: Optional[Callable] = None):
        self._source = source
        self._queue_size = prefetch_depth() if queue_size is None \
            else int(queue_size)
        self._device = torch.device("cpu" if device is None else device)
        self._check = check
        self._passthrough = getattr(source, "async_supported", True) is False

    def reset(self):
        self._source.reset()

    def batch_size(self):
        return self._source.batch_size()

    def set_pre_processor(self, pre_processor):
        # DL4J's AsyncDataSetIterator delegates to the backing iterator
        self._source.set_pre_processor(pre_processor)
        return self

    def __iter__(self):
        if self._passthrough:
            return iter(self._source)
        return prefetch_to_device(
            self._source, self._device, dataset_arrays,
            lambda ds, arrays: DataSet(*arrays), self._check,
            self._queue_size)
