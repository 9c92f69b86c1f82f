"""The DataSet container.

A copy of the JAX package's `data/dataset.py` (numpy only): ND4J's
DataSet, consumed by `MultiLayerNetwork.fit` (MultiDataSet comes with the
ComputationGraph slice). Arrays are
host numpy arrays; `fit` moves each batch to the network's device. Masks
follow DL4J semantics ((B, T) 0/1 arrays for time series).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: "np.ndarray"
    labels: Optional["np.ndarray"] = None
    features_mask: Optional["np.ndarray"] = None
    labels_mask: Optional["np.ndarray"] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]
        n = self.num_examples()
        return (DataSet(*(cut(a, 0, n_train) for a in self._arrays())),
                DataSet(*(cut(a, n_train, n) for a in self._arrays())))

    def _arrays(self):
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    def shuffle(self, seed: int = 0) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        def take(a):
            return None if a is None else a[idx]
        return DataSet(*(take(a) for a in self._arrays()))

    def batch_by(self, batch_size: int):
        n = self.num_examples()
        for i in range(0, n - batch_size + 1, batch_size):
            yield DataSet(*(None if a is None else a[i:i + batch_size]
                            for a in self._arrays()))
