"""Utility DataSet iterators.

A copy of the JAX package's `data/utility_iterators.py` (numpy only; the
two device callbacks import torch when called), under the port's names.
Parity: DL4J `deeplearning4j-utility-iterators/`:
`EarlyTerminationDataSetIterator`, `MultipleEpochsIterator`,
`DataSetIteratorSplitter` (train/test views over one source),
`SamplingDataSetIterator`, `IteratorDataSetIterator` (wrap a plain
iterable), the async MULTI-dataset shield (`AsyncMultiDataSetIterator`),
`ReconstructionDataSetIterator`, `AsyncShieldDataSetIterator`,
`BenchmarkDataSetIterator`, `SingletonMultiDataSetIterator`,
`IteratorMultiDataSetIterator`, `EarlyTerminationMultiDataSetIterator`,
`MultiDataSetWrapperIterator`, `MultiDataSetIteratorSplitter`,
`AbstractDataSetIterator` with the typed
`Floats/Doubles/INDArrayDataSetIterator` variants, `ListDataSetIterator`,
`FileSplitDataSetIterator` (+ save_dataset/load_dataset, .npz files
either package reads), `Dummy/Combined[MultiDataSet]PreProcessor`,
`WorkspacesShieldDataSetIterator` (detached host copies),
`MovingWindowBaseDataSetIterator`, the `DataSetCallback` family
(Default/Interleaved per-device placement), and
`JointParallelDataSetIterator` with PASS/STOP/RESET inequality handling.

Not reproduced (internal plumbing their Java ancestors needed but numpy/
JSON make moot): `BaseFileIterator`'s temp-file shuffling,
`DataSetDeserializer` (binary serde — .npz here), `MultiBoolean` (bitset
helper), `FileSplitParallelDataSetIterator` (compose
`FileSplitDataSetIterator` + `JointParallelDataSetIterator`).
"""
from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import (   # noqa: F401 — re-export:
    BenchmarkDataSetIterator, DataSetIterator,   # Benchmark* belongs to the
)                                                # utility-iterator surface


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches per epoch
    (EarlyTerminationDataSetIterator)."""

    def __init__(self, source: DataSetIterator, max_batches: int):
        if max_batches <= 0:
            raise ValueError("max_batches must be positive")
        self.source = source
        self.max_batches = max_batches

    def __iter__(self) -> Iterator[DataSet]:
        for i, ds in enumerate(self.source):
            if i >= self.max_batches:
                break
            yield self._pp(ds)

    def reset(self):
        self.source.reset()


class MultipleEpochsIterator(DataSetIterator):
    """Replays the source n_epochs times as ONE epoch
    (MultipleEpochsIterator — DL4J's pre-`fit(iter, epochs)` idiom)."""

    def __init__(self, source: DataSetIterator, n_epochs: int):
        self.source = source
        self.n_epochs = max(1, n_epochs)

    def __iter__(self) -> Iterator[DataSet]:
        for _ in range(self.n_epochs):
            for ds in self.source:
                yield self._pp(ds)
            self.source.reset()

    def reset(self):
        self.source.reset()


class _SplitView(DataSetIterator):
    def __init__(self, parent: "DataSetIteratorSplitter", train: bool):
        self.parent = parent
        self.train = train

    def __iter__(self) -> Iterator[DataSet]:
        boundary = self.parent.n_train
        # always leave the shared source rewound, even on early break or
        # an exception mid-epoch — otherwise the sibling view would start
        # mid-stream and the partitions would shift
        try:
            for i, ds in enumerate(self.parent.source):
                if self.train:
                    if i >= boundary:
                        break          # train view never drains the tail
                    yield self._pp(ds)
                elif i >= boundary:
                    yield self._pp(ds)
        finally:
            self.parent.source.reset()

    def reset(self):
        self.parent.source.reset()


class DataSetIteratorSplitter:
    """Splits one iterator's epoch into train/test partitions by batch
    count (DataSetIteratorSplitter: totalBatches * ratio go to train)."""

    def __init__(self, source: DataSetIterator, total_batches: int,
                 ratio: float):
        if not 0.0 < ratio < 1.0:
            raise ValueError("ratio must be in (0, 1)")
        self.source = source
        self.total_batches = total_batches
        self.n_train = int(total_batches * ratio)

    @property
    def train_iterator(self) -> DataSetIterator:
        return _SplitView(self, True)

    @property
    def test_iterator(self) -> DataSetIterator:
        return _SplitView(self, False)


class SamplingDataSetIterator(DataSetIterator):
    """Random-with-replacement minibatches from one DataSet
    (SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch_size: int,
                 total_batches: int, seed: int = 123):
        self.dataset = dataset
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[DataSet]:
        rs = np.random.RandomState(self.seed + self._epoch)
        n = len(self.dataset.features)
        for _ in range(self.total_batches):
            sel = rs.randint(0, n, self.batch_size)
            yield self._pp(DataSet(
                np.asarray(self.dataset.features)[sel],
                np.asarray(self.dataset.labels)[sel],
                None if self.dataset.features_mask is None
                else np.asarray(self.dataset.features_mask)[sel],
                None if self.dataset.labels_mask is None
                else np.asarray(self.dataset.labels_mask)[sel]))
        self._epoch += 1

    def reset(self):
        pass


class IteratorDataSetIterator(DataSetIterator):
    """Wraps any (re-iterable) python iterable of DataSets
    (IteratorDataSetIterator)."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._items: List[DataSet] = list(iterable)

    def __iter__(self) -> Iterator[DataSet]:
        return (self._pp(ds) for ds in self._items)

    def reset(self):
        pass


class AsyncMultiDataSetIterator:
    """Background-thread prefetch over MultiDataSets — the multi-input twin
    of AsyncDataSetIterator (AsyncMultiDataSetIterator). Rides the shared
    thread pump (`data/async_iterator.prefetch_iterable`) — bounded queue,
    worker-error smuggling, drain-and-join teardown all live there."""

    def __init__(self, source, queue_size: int = 4):
        self.source = source
        self.queue_size = max(1, queue_size)

    def __iter__(self):
        from deeplearning4j_tpu_torch.data.async_iterator import prefetch_iterable
        return prefetch_iterable(self.source, None, self.queue_size)

    def reset(self):
        if hasattr(self.source, "reset"):
            self.source.reset()


class ReconstructionDataSetIterator(DataSetIterator):
    """Features become the labels (DL4J ReconstructionDataSetIterator):
    the autoencoder-training adapter."""

    def __init__(self, source: DataSetIterator):
        self.source = source

    def reset(self):
        self.source.reset()

    def batch_size(self):
        return self.source.batch_size()

    def __iter__(self):
        for ds in self.source:
            yield self._pp(DataSet(ds.features, ds.features,
                                   ds.features_mask, ds.features_mask))


class AsyncShieldDataSetIterator(DataSetIterator):
    """Marks a source as must-NOT-be-async-prefetched (DL4J
    AsyncShieldDataSetIterator): AsyncDataSetIterator passes it through
    untouched via `async_supported`. Use for sources whose batches alias
    shared mutable buffers."""

    async_supported = False

    def __init__(self, source: DataSetIterator):
        self.source = source

    def reset(self):
        self.source.reset()

    def batch_size(self):
        return self.source.batch_size()

    def set_pre_processor(self, pre_processor):
        self.source.set_pre_processor(pre_processor)   # DL4J delegation
        return self

    def __iter__(self):
        return iter(self.source)


class SingletonMultiDataSetIterator:
    """Yields one MultiDataSet per epoch (DL4J
    impl/SingletonMultiDataSetIterator.java)."""

    def __init__(self, mds: MultiDataSet):
        self.mds = mds

    def reset(self):
        pass

    def __iter__(self):
        yield self.mds


class IteratorMultiDataSetIterator:
    """Wrap a plain iterable of MultiDataSet (DL4J
    IteratorMultiDataSetIterator). Materialized at construction (like
    IteratorDataSetIterator above) so a one-shot generator source still
    supports multi-epoch reset instead of silently yielding nothing."""

    def __init__(self, source: Iterable):
        self.source = list(source)

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.source)


class EarlyTerminationMultiDataSetIterator(EarlyTerminationDataSetIterator):
    """Cap the number of MultiDataSet batches per epoch (DL4J
    EarlyTerminationMultiDataSetIterator). The capping logic is
    source-type agnostic — this is the MultiDataSet-typed name for it."""


class MultiDataSetWrapperIterator(DataSetIterator):
    """Adapt a single-input/single-output MultiDataSet iterator to the
    DataSetIterator contract (DL4J MultiDataSetWrapperIterator)."""

    def __init__(self, source):
        self.source = source

    def reset(self):
        if hasattr(self.source, "reset"):
            self.source.reset()

    def __iter__(self):
        for mds in self.source:
            if len(mds.features) != 1 or len(mds.labels) != 1:
                raise ValueError(
                    "MultiDataSetWrapperIterator requires single-input/"
                    f"single-output data, got {len(mds.features)} inputs / "
                    f"{len(mds.labels)} outputs")
            fm = mds.features_masks[0] if mds.features_masks else None
            lm = mds.labels_masks[0] if mds.labels_masks else None
            yield self._pp(DataSet(mds.features[0], mds.labels[0], fm, lm))


class MultiDataSetIteratorSplitter(DataSetIteratorSplitter):
    """Train/test views over one MultiDataSet source (DL4J
    MultiDataSetIteratorSplitter). _SplitView never inspects the yielded
    items, so the whole split/rewind machinery (including the
    rewind-on-early-break invariant) is shared with the DataSet
    variant."""


# ---------------------------------------------------------------------------
# round-5 tail: typed pair-backed iterators, list re-batching, file splits,
# pre-processor combinators, detach shield, moving windows, per-device
# callbacks, joint parallel iteration — the remainder of the reference's
# deeplearning4j-utility-iterators inventory.
# ---------------------------------------------------------------------------

class AbstractDataSetIterator(DataSetIterator):
    """Batch an iterable of (features, labels) pairs
    (reference AbstractDataSetIterator.java — the backing for the typed
    Floats/Doubles/INDArray variants)."""
    _dtype = None               # None = keep the pairs' own dtype

    def __init__(self, iterable: Iterable, batch_size: int = 8):
        # a one-shot generator would silently yield ZERO batches from the
        # second epoch on (reset() can't rewind it) — materialize anything
        # that can't rewind itself so multi-epoch fit() keeps training
        if not (hasattr(iterable, "reset")
                or isinstance(iterable, (list, tuple))):
            iterable = list(iterable)
        self._iterable = iterable
        self._batch = int(batch_size)

    def batch_size(self):
        return self._batch

    def reset(self):
        if hasattr(self._iterable, "reset"):
            self._iterable.reset()

    def __iter__(self):
        feats, labs = [], []

        def flush():
            ds = DataSet(np.stack(feats), np.stack(labs))
            feats.clear()
            labs.clear()
            return self._pp(ds)

        for f, lab in self._iterable:
            feats.append(np.asarray(f, self._dtype))
            labs.append(np.asarray(lab, self._dtype))
            if len(feats) == self._batch:
                yield flush()
        if feats:
            yield flush()


class FloatsDataSetIterator(AbstractDataSetIterator):
    """float32 pair iterator (reference FloatsDataSetIterator.java)."""
    _dtype = np.float32


class DoublesDataSetIterator(AbstractDataSetIterator):
    """float64 pair iterator (reference DoublesDataSetIterator.java)."""
    _dtype = np.float64


class INDArrayDataSetIterator(AbstractDataSetIterator):
    """Array-pair iterator keeping the source dtype
    (reference INDArrayDataSetIterator.java; ndarray == numpy here)."""
    _dtype = None


class ListDataSetIterator(DataSetIterator):
    """Re-batch a collection of (often single-example) DataSets
    (reference ListDataSetIterator.java)."""

    def __init__(self, datasets: List[DataSet], batch: int = 32):
        self._datasets = list(datasets)
        self._batch = int(batch)

    def batch_size(self):
        return self._batch

    def reset(self):
        pass

    def __iter__(self):
        def cat(arrs):
            if any(a is None for a in arrs):
                return None
            return np.concatenate([np.asarray(a) for a in arrs])

        pend: List[DataSet] = []
        n = 0
        for ds in self._datasets:
            pend.append(ds)
            n += ds.num_examples()
            while n >= self._batch:
                take, rest, acc = [], [], 0
                for d in pend:
                    if acc < self._batch:
                        room = self._batch - acc
                        if d.num_examples() <= room:
                            take.append(d)
                            acc += d.num_examples()
                        else:
                            head, tail = d.split_test_and_train(room)
                            take.append(head)
                            rest.append(tail)
                            acc += room
                    else:
                        rest.append(d)
                yield self._pp(DataSet(
                    cat([d.features for d in take]),
                    cat([d.labels for d in take]),
                    cat([d.features_mask for d in take]),
                    cat([d.labels_mask for d in take])))
                pend, n = rest, sum(d.num_examples() for d in rest)
        if pend:
            yield self._pp(DataSet(
                *(cat([getattr(d, a) for d in pend])
                  for a in ("features", "labels", "features_mask",
                            "labels_mask"))))


class DummyPreProcessor:
    """No-op pre-processor (reference DummyPreProcessor.java). Implements
    the same `preprocess` contract as data/normalization.py so it attaches
    via iterator.set_pre_processor."""

    def preprocess(self, ds):
        return ds


class CombinedPreProcessor:
    """Chain pre-processors in order (reference CombinedPreProcessor.java,
    minus the Jackson builder). Members follow the codebase-wide
    `preprocess(ds) -> ds` contract (DataSetPreProcessor,
    data/normalization.py), so existing normalizers compose directly."""

    def __init__(self, *pre_processors):
        self._pps = pre_processors

    def preprocess(self, ds):
        for pp in self._pps:
            out = pp.preprocess(ds)
            ds = ds if out is None else out
        return ds


class CombinedMultiDataSetPreProcessor(CombinedPreProcessor):
    """MultiDataSet variant (reference CombinedMultiDataSetPreProcessor)."""


class WorkspacesShieldDataSetIterator(DataSetIterator):
    """Detach every yielded DataSet into fresh host arrays
    (reference WorkspacesShieldDataSetIterator.java detaches workspace
    buffers; here the hazard is holding views into buffers the source
    reuses, such as the ring slots of `data/pipeline.py` — np.array
    copies make the batch safe to retain)."""

    def __init__(self, source: DataSetIterator):
        self._source = source

    def batch_size(self):
        return self._source.batch_size()

    def reset(self):
        self._source.reset()

    def __iter__(self):
        for ds in self._source:
            yield self._pp(DataSet(*(
                None if a is None else np.array(a)
                for a in (ds.features, ds.labels, ds.features_mask,
                          ds.labels_mask))))


class MovingWindowBaseDataSetIterator(DataSetIterator):
    """Sliding example windows over one DataSet
    (reference MovingWindowBaseDataSetIterator + MovingWindowDataSetFetcher:
    every window of `window` consecutive examples, advancing by `stride`)."""

    def __init__(self, dataset: DataSet, window: int, stride: int = None):
        self._ds = dataset
        self._window = int(window)
        self._stride = int(stride) if stride else self._window

    def batch_size(self):
        return self._window

    def reset(self):
        pass

    def __iter__(self):
        n = self._ds.num_examples()

        def cut(a, lo, hi):
            return None if a is None else np.asarray(a)[lo:hi]

        for lo in range(0, max(n - self._window, 0) + 1, self._stride):
            hi = lo + self._window
            if hi > n:
                break
            yield self._pp(DataSet(
                cut(self._ds.features, lo, hi),
                cut(self._ds.labels, lo, hi),
                cut(self._ds.features_mask, lo, hi),
                cut(self._ds.labels_mask, lo, hi)))


def save_dataset(ds: DataSet, path: str) -> None:
    """Persist one DataSet as an .npz (the file currency of
    FileSplitDataSetIterator; reference DataSets serialize via
    DataSet.save)."""
    arrays = {}
    for key in ("features", "labels", "features_mask", "labels_mask"):
        a = getattr(ds, key)
        if a is not None:
            arrays[key] = np.asarray(a)
    np.savez(path, **arrays)


def load_dataset(path: str) -> DataSet:
    with np.load(path) as z:
        return DataSet(*(z[k] if k in z else None
                         for k in ("features", "labels", "features_mask",
                                   "labels_mask")))


class FileSplitDataSetIterator(DataSetIterator):
    """One DataSet per file (reference FileSplitDataSetIterator.java:
    list of files + a FileCallback that turns each file into a DataSet;
    default callback loads the .npz written by save_dataset)."""

    def __init__(self, files: List[str], callback=None):
        self._files = list(files)
        self._callback = callback or load_dataset

    def batch_size(self):
        return None

    def reset(self):
        pass

    def __iter__(self):
        for path in self._files:
            yield self._pp(self._callback(path))


# ------------------------------------------------------- device callbacks

class DataSetCallback:
    """Hook applied to every prefetched batch inside AsyncDataSetIterator
    (reference callback/DataSetCallback.java)."""

    def call(self, ds):
        return ds


def _place(ds, device):
    import torch
    return DataSet(*(None if a is None else torch.as_tensor(a).to(device)
                     for a in (ds.features, ds.labels,
                               ds.features_mask, ds.labels_mask)))


def _cuda_devices():
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the devices explicitly "
                           "(e.g. [\"cpu\"])")
    return [torch.device("cuda", i) for i in range(n)]


class DefaultCallback(DataSetCallback):
    """Place each batch on one device (reference DefaultCallback.java
    does the workspace/device touch): its arrays become tensors there
    (default the first CUDA device)."""

    def __init__(self, device=None):
        self._device = device

    def call(self, ds):
        return _place(ds, self._device or _cuda_devices()[0])


class InterleavedDataSetCallback(DataSetCallback):
    """Round-robin consecutive batches across devices (reference
    callback/InterleavedDataSetCallback.java): per-device placement for
    multi-replica consumers without a sharded iterator (default every
    CUDA device)."""

    def __init__(self, devices=None):
        self._devices = devices
        self._i = 0

    def call(self, ds):
        devs = self._devices or _cuda_devices()
        dev = devs[self._i % len(devs)]
        self._i += 1
        return _place(ds, dev)


# --------------------------------------------------- joint parallel source

class InequalityHandling:
    """What JointParallelDataSetIterator does when one attached source
    runs dry before the others (reference
    parallel/JointParallelDataSetIterator.java + InequalityHandling)."""
    PASS = "pass"               # skip the empty source, keep the rest
    STOP_EVERYONE = "stop"      # end the whole joint stream
    RESET = "reset"             # rewind the empty source and keep going


class JointParallelDataSetIterator(DataSetIterator):
    """Interleave several iterators round-robin — the per-device feed shape
    ParallelWrapper consumes (reference JointParallelDataSetIterator).
    `inequality` picks the semantics when sources are unequal length; RESET
    loops short sources for one full pass of the longest."""

    def __init__(self, *sources: DataSetIterator,
                 inequality: str = InequalityHandling.PASS):
        if not sources:
            raise ValueError("need at least one source iterator")
        self._sources = list(sources)
        self._inequality = inequality

    def batch_size(self):
        return self._sources[0].batch_size()

    def reset(self):
        for s in self._sources:
            s.reset()

    def __iter__(self):
        iters = [iter(s) for s in self._sources]
        done = [False] * len(iters)          # exhausted at least once
        if self._inequality != InequalityHandling.RESET:
            while not all(done):
                for i, it in enumerate(iters):
                    if done[i]:
                        continue
                    try:
                        yield self._pp(next(it))
                    except StopIteration:
                        if (self._inequality
                                == InequalityHandling.STOP_EVERYONE):
                            return
                        done[i] = True
            return
        # RESET: loop short sources for exactly one full pass of the
        # longest. Rounds are assembled before yielding so the round in
        # which the LAST live source ends is discarded entirely — equal
        # length sources never produce a spurious reset batch.
        while not all(done):
            slots = [None] * len(iters)
            fresh = [False] * len(iters)
            for i, it in enumerate(iters):
                if done[i]:
                    continue
                try:
                    slots[i] = next(it)
                    fresh[i] = True
                except StopIteration:
                    done[i] = True
            if all(done) and not any(fresh):
                return               # the round where everything ended
            if not all(done):
                # refill the slots of already-finished sources by looping:
                # keep pulling from the CURRENT rewound iterator (so the
                # short source cycles through all its batches), resetting
                # only when it runs out again
                for i in range(len(iters)):
                    if fresh[i]:
                        continue
                    try:
                        slots[i] = next(iters[i])
                        fresh[i] = True
                    except StopIteration:
                        self._sources[i].reset()
                        iters[i] = iter(self._sources[i])
                        try:
                            slots[i] = next(iters[i])
                            fresh[i] = True
                        except StopIteration:
                            pass
            for i, s in enumerate(slots):
                if fresh[i]:
                    yield self._pp(s)
