"""DataSet iterators.

A copy of the first part of the JAX package's `data/iterator.py` (numpy
only): DL4J's DataSetIterator contract (reset, iteration with batching)
as Python iterables with an explicit reset(), and the two in-memory
iterators. The asynchronous prefetching wrapper comes with the data
slice; `fit` moves each batch to the device itself.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base: iterable of DataSet with reset().

    `set_pre_processor` attaches a DataSetPreProcessor (normalizer) the
    DL4J way — source iterators route every yielded batch through
    `self._pp(ds)` (DataSetIterator.setPreProcessor contract)."""

    pre_processor = None

    def reset(self):
        pass

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def batch_size(self) -> Optional[int]:
        return None

    def set_pre_processor(self, pre_processor) -> "DataSetIterator":
        self.pre_processor = pre_processor
        return self

    def _pp(self, ds: DataSet) -> DataSet:
        return self.pre_processor.preprocess(ds) \
            if self.pre_processor is not None else ds


class ArrayDataSetIterator(DataSetIterator):
    """Batches in-memory arrays (analog of ND4J's ExistingDataSetIterator +
    ListDataSetIterator). Drops the trailing partial batch by default, as
    the reference does (it keeps batch shapes static), unless the partial
    batch is all there is."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 features_mask=None, labels_mask=None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last

    def batch_size(self):
        return self._batch

    def reset(self):
        self._epoch += 1

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(idx)
        if self._drop_last and n >= self._batch:
            stop = n - self._batch + 1
        else:
            stop = n   # keep the partial batch when it's all we have
        for i in range(0, max(stop, 0), self._batch):
            sel = idx[i:i + self._batch]
            yield self._pp(DataSet(
                self.features[sel],
                None if self.labels is None else self.labels[sel],
                None if self.features_mask is None else self.features_mask[sel],
                None if self.labels_mask is None else self.labels_mask[sel],
            ))


class ExistingDataSetIterator(DataSetIterator):
    """Wraps a list of pre-batched DataSets."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return (self._pp(ds) for ds in self._datasets)

    def batch_size(self):
        return self._datasets[0].num_examples() if self._datasets else None
