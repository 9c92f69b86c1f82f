"""K-means (DL4J `clustering/kmeans/KMeansClustering.java` + the
clustering/algorithm framework it instantiates).

Lloyd's algorithm with k-means++ seeding. The assignment step (the
distance expansion and argmin over every point) runs on the estimator's
device; the points go there once per `fit`. Seeding (the native host
`pairwise_sqdist` and a RandomState) and the center update (each center
the host mean of its members) stay on the host, as in the JAX package,
so the same assignments give bitwise the same centers on every device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.platform import (
    resolve_device, set_f32_matmul_exact,
)


def _assign(points: torch.Tensor, centers: torch.Tensor):
    """(N, D) x (K, D) -> (N,) nearest-center ids and distances, on the
    tensors' device."""
    d2 = ((points ** 2).sum(1)[:, None]
          - 2.0 * points @ centers.T
          + (centers ** 2).sum(1)[None, :])
    idx = torch.argmin(d2, dim=1)
    return idx, torch.sqrt(torch.clamp(
        d2.gather(1, idx[:, None])[:, 0], min=0.0))


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100,
                 tolerance: float = 1e-4, seed: int = 0,
                 distance: str = "euclidean", device=None):
        if distance not in ("euclidean",):
            raise ValueError("only euclidean distance is supported")
        self.k = k
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_matmul_exact()      # TF32 would move assignments
        self.centers: Optional[np.ndarray] = None
        self.iterations_done = 0

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _init_centers(self, X, rs):
        """k-means++ seeding (pairwise distances via the native host
        kernel when built — O(N·K) memory instead of numpy's N×K×D
        broadcast temporary)."""
        from deeplearning4j_tpu_torch.native.ndarray import pairwise_sqdist
        n = len(X)
        centers = [X[rs.randint(n)]]
        for _ in range(1, self.k):
            d2 = pairwise_sqdist(X, np.asarray(centers)).min(axis=1)
            d2 = d2.astype(np.float64)   # rs.choice needs probs Σ=1 to 1e-8
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(X[rs.choice(n, p=probs)])
        return np.asarray(centers, np.float32)

    def fit(self, X) -> "KMeansClustering":
        X = np.asarray(X, np.float32)
        rs = np.random.RandomState(self.seed)
        centers = self._init_centers(X, rs)
        Xd = self._on_device(X)
        for it in range(self.max_iterations):
            idx, _ = _assign(Xd, self._on_device(centers))
            idx = idx.cpu().numpy()
            new_centers = centers.copy()
            for c in range(self.k):
                members = X[idx == c]
                if len(members):
                    new_centers[c] = members.mean(0)
            shift = float(np.linalg.norm(new_centers - centers))
            centers = new_centers
            self.iterations_done = it + 1
            if shift < self.tolerance:
                break
        self.centers = centers
        return self

    def predict(self, X) -> np.ndarray:
        idx, _ = _assign(self._on_device(X), self._on_device(self.centers))
        return idx.cpu().numpy()

    def inertia(self, X) -> float:
        _, d = _assign(self._on_device(X), self._on_device(self.centers))
        return float(torch.sum(d ** 2))
