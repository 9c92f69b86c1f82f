"""Bundled dataset fetchers.

Counterpart of the JAX package's `data/fetchers.py`, for now the one set
that needs no download: the Fisher iris data, bundled inline
(`data/_iris.py`, as DL4J bundles iris.dat). The MNIST, EMNIST and
CIFAR-10 fetchers, which read a download cache, come with the data slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator


def _iris_arrays():
    """(X (150, 4) float32, one-hot Y (150, 3) float32)."""
    from deeplearning4j_tpu_torch.data._iris import IRIS_ROWS
    arr = np.asarray(IRIS_ROWS, "float32")
    return arr[:, :4], np.eye(3, dtype="float32")[arr[:, 4].astype(int)]


class IrisDataSetIterator(ArrayDataSetIterator):
    """DL4J IrisDataSetIterator (fetchers/IrisDataFetcher.java): the rows
    in the reference's seeded shuffle order."""

    def __init__(self, batch_size: int = 150,
                 shuffle_seed: Optional[int] = 42):
        X, Y = _iris_arrays()
        if shuffle_seed is not None:
            idx = np.random.RandomState(shuffle_seed).permutation(len(X))
            X, Y = X[idx], Y[idx]
        super().__init__(X, Y, batch_size=batch_size)

