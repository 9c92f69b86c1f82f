"""Space-partitioning tree + Barnes-Hut repulsion (host side).

Parity target: `deeplearning4j-nearestneighbors-parent/nearestneighbor-core/
src/main/java/org/deeplearning4j/clustering/sptree/SpTree.java` (the
center-of-mass quad/oct tree) and `BarnesHutTsne.java` computeNonEdgeForces.
The hot path is the C++ arena tree in `native/src/sptree.cpp` (OpenMP over
points); `PySpTree` is the same algorithm in pure numpy/Python — the
no-compiler fallback and the structural reference the tests inspect
(counts, centers of mass, theta-visit statistics).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import native


class PySpTree:
    """Pure-Python SpTree (SpTree.java structure): 2^dim-ary subdivision,
    cumulative center of mass per cell, duplicate merging."""

    __slots__ = ("dim", "fanout", "center", "hw", "com", "count",
                 "child_base", "point", "y")

    def __init__(self, Y: np.ndarray):
        Y = np.asarray(Y, np.float32)
        self.y = Y
        n, self.dim = Y.shape
        self.fanout = 1 << self.dim
        lo, hi = Y.min(0), Y.max(0)
        c = np.float32(0.5) * (lo + hi)
        # keep formula bitwise in sync with sptree.cpp bh_repulsion_f32
        h = float(np.float32(max(np.float32(0.5) * (hi - lo).max(),
                                 np.float32(1e-5))) * np.float32(1.0001))
        self.center = [c.astype(np.float32)]
        self.hw = [h]
        self.com = [np.zeros(self.dim, np.float32)]
        self.count = [0]
        self.child_base = [-1]
        self.point = [-1]
        for i in range(n):
            self._insert(0, Y[i], i)

    def _alloc(self, c, h):
        self.center.append(np.asarray(c, np.float32))
        self.hw.append(h)
        self.com.append(np.zeros(self.dim, np.float32))
        self.count.append(0)
        self.child_base.append(-1)
        self.point.append(-1)
        return len(self.hw) - 1

    def _slot(self, node, y):
        return int(sum((1 << k) for k in range(self.dim)
                       if y[k] > self.center[node][k]))

    def _insert(self, node, y, idx):
        while True:
            cnt = self.count[node]
            self.com[node] = (self.com[node] * cnt + y) / (cnt + 1)
            self.count[node] = cnt + 1
            if self.child_base[node] < 0 and self.point[node] < 0:
                self.point[node] = idx
                return
            if self.hw[node] < 1e-9:
                return                      # depth cap: merge
            if self.child_base[node] < 0:
                old = self.point[node]
                oy = self.y[old]
                if np.array_equal(oy, y):
                    return                  # duplicate: multiplicity only
                h = self.hw[node] * 0.5
                base = len(self.hw)
                for s in range(self.fanout):
                    off = np.array([h if (s >> k) & 1 else -h
                                    for k in range(self.dim)], np.float32)
                    self._alloc(self.center[node] + off, h)
                self.child_base[node] = base
                tgt = base + self._slot(node, oy)
                # occupant keeps its merged-duplicate multiplicity:
                # count[node] was already incremented for the new point
                self.com[tgt] = oy.copy()
                self.count[tgt] = self.count[node] - 1
                self.point[tgt] = old
                self.point[node] = -1
            node = self.child_base[node] + self._slot(node, y)

    def repulsion(self, theta: float) -> Tuple[np.ndarray, float, int]:
        """(neg_forces (N,dim), Z, cells_visited) — BarnesHutTsne.java
        computeNonEdgeForces over every point."""
        Y = self.y
        n = len(Y)
        neg = np.zeros_like(Y)
        z = 0.0
        visits = 0
        theta2 = theta * theta
        for i in range(n):
            yi = Y[i]
            stack = [0]
            while stack:
                node = stack.pop()
                visits += 1
                cnt = self.count[node]
                if cnt == 0:
                    continue
                diff = yi - self.com[node]
                d2 = float(diff @ diff)
                leaf = self.child_base[node] < 0
                self_leaf = leaf and self.point[node] == i
                w = 2.0 * self.hw[node]
                if leaf or w * w < theta2 * d2:
                    if self_leaf and cnt == 1:
                        continue
                    mult = cnt - (1 if self_leaf else 0)
                    q = 1.0 / (1.0 + d2)
                    z += mult * q
                    neg[i] += mult * q * q * diff
                else:
                    base = self.child_base[node]
                    stack.extend(base + s for s in range(self.fanout)
                                 if self.count[base + s] > 0)
        return neg, z, visits


def bh_repulsion(Y: np.ndarray, theta: float) \
        -> Tuple[np.ndarray, float, Optional[int]]:
    """Barnes-Hut repulsive numerator + partition function Z.

    Native C++ sp-tree when the toolchain is available, PySpTree
    otherwise. Returns (neg_forces, Z, cells_visited)."""
    Y = np.ascontiguousarray(Y, np.float32)
    n, dim = Y.shape
    if native.available() and dim <= 3:
        lib = native.get_lib()
        neg = np.zeros_like(Y)
        stats = (ctypes.c_int64 * 1)()
        z = lib.bh_repulsion_f32(
            Y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, dim,
            ctypes.c_float(theta),
            neg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), stats)
        return neg, float(z), int(stats[0])
    tree = PySpTree(Y)
    neg, z, visits = tree.repulsion(theta)
    return neg, z, visits
