"""Locality-sensitive hashing (DL4J `clustering/lsh/RandomProjectionLSH.java`).

Sign-of-random-projection signatures with multi-table lookup; candidate
re-ranking uses exact distances (vectorized numpy).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

import numpy as np


class RandomProjectionLSH:
    def __init__(self, hash_length: int = 16, num_tables: int = 4,
                 seed: int = 0):
        self.hash_length = hash_length
        self.num_tables = num_tables
        self.seed = seed
        self._planes = None
        self._tables = None
        self.points = None

    def _signatures(self, X) -> np.ndarray:
        """(T, N) int signatures from sign patterns."""
        bits = (np.einsum("tfd,nd->tnf", self._planes, X) > 0)
        weights = 1 << np.arange(self.hash_length)
        return (bits * weights).sum(-1)

    def fit(self, points) -> "RandomProjectionLSH":
        self.points = np.asarray(points, np.float32)
        d = self.points.shape[1]
        rs = np.random.RandomState(self.seed)
        self._planes = rs.randn(self.num_tables, self.hash_length,
                                d).astype(np.float32)
        sigs = self._signatures(self.points)
        self._tables = [defaultdict(list) for _ in range(self.num_tables)]
        for t in range(self.num_tables):
            for i, s in enumerate(sigs[t]):
                self._tables[t][int(s)].append(i)
        return self

    def query(self, x, k: int = 5) -> Tuple[List[int], List[float]]:
        x = np.asarray(x, np.float32)
        sigs = self._signatures(x[None])[:, 0]
        cands = set()
        for t in range(self.num_tables):
            cands.update(self._tables[t].get(int(sigs[t]), ()))
        if not cands:
            cands = set(range(len(self.points)))   # degenerate fallback
        cand = np.asarray(sorted(cands))
        dists = np.linalg.norm(self.points[cand] - x, axis=1)
        order = np.argsort(dists)[:k]
        return [int(cand[i]) for i in order], [float(dists[i]) for i in order]
