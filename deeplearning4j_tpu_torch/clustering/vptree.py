"""Vantage-point tree (DL4J `clustering/vptree/VPTree.java`).

Exact metric-space nearest neighbors: build picks a vantage point and
splits at the median distance; search prunes with the triangle inequality.
A host-side recursive structure, as in the JAX package: numpy vectorizes
the distance evaluations.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index, threshold, inside, outside):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside


def _dist(a, b, metric):
    if metric == "euclidean":
        return float(np.linalg.norm(a - b))
    if metric == "cosine":
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 1.0
        return float(1.0 - a @ b / (na * nb))
    raise ValueError(metric)


class VPTree:
    def __init__(self, points, metric: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float32)
        self.metric = metric
        rs = np.random.RandomState(seed)
        self.root = self._build(list(range(len(self.points))), rs)

    def _build(self, idxs: List[int], rs) -> Optional[_Node]:
        if not idxs:
            return None
        vp = idxs[rs.randint(len(idxs))]
        rest = [i for i in idxs if i != vp]
        if not rest:
            return _Node(vp, 0.0, None, None)
        dists = np.linalg.norm(self.points[rest] - self.points[vp], axis=1) \
            if self.metric == "euclidean" else np.asarray(
                [_dist(self.points[i], self.points[vp], self.metric)
                 for i in rest])
        thr = float(np.median(dists))
        inside = [rest[i] for i in range(len(rest)) if dists[i] <= thr]
        outside = [rest[i] for i in range(len(rest)) if dists[i] > thr]
        return _Node(vp, thr, self._build(inside, rs),
                     self._build(outside, rs))

    def knn(self, query, k: int = 1) -> Tuple[List[int], List[float]]:
        """k nearest neighbors (DL4J VPTree.search)."""
        query = np.asarray(query, np.float32)
        heap: List[Tuple[float, int]] = []    # max-heap via negated dist
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = _dist(query, self.points[node.index], self.metric)
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]
