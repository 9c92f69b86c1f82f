"""Gaussian random projection (DL4J `clustering/randomprojection/RandomProjection.java`):
Johnson-Lindenstrauss dimensionality reduction."""
from __future__ import annotations

import numpy as np


def jl_target_dim(n_samples: int, eps: float = 0.1) -> int:
    """Johnson-Lindenstrauss minimum dimension (DL4J johnsonLindenstraussMinDim)."""
    return int(4 * np.log(n_samples) / (eps ** 2 / 2 - eps ** 3 / 3))


class RandomProjection:
    def __init__(self, target_dim: int, seed: int = 0):
        self.target_dim = target_dim
        self.seed = seed
        self._proj = None

    def fit(self, X) -> "RandomProjection":
        d = np.asarray(X).shape[1]
        rs = np.random.RandomState(self.seed)
        self._proj = (rs.randn(d, self.target_dim) /
                      np.sqrt(self.target_dim)).astype(np.float32)
        return self

    def transform(self, X) -> np.ndarray:
        if self._proj is None:
            self.fit(X)
        return np.asarray(X, np.float32) @ self._proj
