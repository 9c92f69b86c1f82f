"""KD-tree (DL4J `clustering/kdtree/KDTree.java`)."""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index, axis, left, right):
        self.index = index
        self.axis = axis
        self.left = left
        self.right = right


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float32)
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_KDNode]:
        if not idxs:
            return None
        axis = depth % self.points.shape[1]
        idxs.sort(key=lambda i: self.points[i, axis])
        mid = len(idxs) // 2
        return _KDNode(idxs[mid], axis,
                       self._build(idxs[:mid], depth + 1),
                       self._build(idxs[mid + 1:], depth + 1))

    def nn(self, query) -> Tuple[int, float]:
        idxs, dists = self.knn(query, 1)
        return idxs[0], dists[0]

    def knn(self, query, k: int = 1) -> Tuple[List[int], List[float]]:
        query = np.asarray(query, np.float32)
        heap: List[Tuple[float, int]] = []

        def visit(node):
            if node is None:
                return
            d = float(np.linalg.norm(query - self.points[node.index]))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - self.points[node.index, node.axis]
            near, far = (node.left, node.right) if diff <= 0 \
                else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]
