"""Graph structure (DL4J `graph/api/IGraph` + `graph/graph/Graph.java`):
adjacency-list graph with optional edge weights, vertex labels, and
random-walk generation (`graph/iterator/RandomWalkIterator` +
WeightedRandomWalkIterator)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Graph:
    def __init__(self, n_vertices: int, directed: bool = False):
        self.n_vertices = n_vertices
        self.directed = directed
        self._adj: List[List[Tuple[int, float]]] = \
            [[] for _ in range(n_vertices)]
        self.labels: Dict[int, str] = {}

    @staticmethod
    def from_edges(edges: Iterable[Sequence], n_vertices: Optional[int] = None,
                   directed: bool = False) -> "Graph":
        edges = [tuple(e) for e in edges]
        if n_vertices is None:
            n_vertices = 1 + max(max(e[0], e[1]) for e in edges)
        g = Graph(n_vertices, directed)
        for e in edges:
            w = float(e[2]) if len(e) > 2 else 1.0
            g.add_edge(int(e[0]), int(e[1]), w)
        return g

    def add_edge(self, a: int, b: int, weight: float = 1.0):
        self._adj[a].append((b, weight))
        if not self.directed:
            self._adj[b].append((a, weight))

    def neighbors(self, v: int) -> List[int]:
        return [n for n, _ in self._adj[v]]

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def num_edges(self) -> int:
        total = sum(len(a) for a in self._adj)
        return total if self.directed else total // 2

    # ---------------------------------------------------------- random walks
    def random_walks(self, walk_length: int = 40, walks_per_vertex: int = 10,
                     weighted: bool = False, seed: int = 0,
                     p: float = 1.0, q: float = 1.0):
        """Uniform / weighted / node2vec-biased walks.

        p, q are node2vec's return/in-out parameters (p=q=1 reduces to
        DeepWalk's uniform walk; DL4J's node2vec module exposes the same
        bias). Yields lists of vertex ids."""
        rs = np.random.RandomState(seed)
        order = np.arange(self.n_vertices)
        biased = p != 1.0 or q != 1.0
        # an unbiased step's CDF depends on its vertex only: made at the
        # vertex's first visit
        cdfs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for _ in range(walks_per_vertex):
            rs.shuffle(order)
            for start in order:
                if not self._adj[start]:
                    continue
                walk = [int(start)]
                prev = None
                while len(walk) < walk_length:
                    cur = walk[-1]
                    if not self._adj[cur]:
                        break
                    if biased and prev is not None:
                        ids, cdf = self._step_cdf(cur, weighted, prev, p, q)
                    else:
                        if cur not in cdfs:
                            cdfs[cur] = self._step_cdf(cur, weighted)
                        ids, cdf = cdfs[cur]
                    prev = cur
                    walk.append(int(ids[cdf.searchsorted(
                        rs.random_sample(), side="right")]))
                yield walk

    def _step_cdf(self, cur: int, weighted: bool, prev: Optional[int] = None,
                  p: float = 1.0, q: float = 1.0):
        """(neighbour ids, CDF) of a step from `cur`: what
        `RandomState.choice(ids, p=w)` draws with (the cumsum of the
        normalised weights over its last entry; one `random_sample`, then
        `searchsorted(side="right")`), node2vec's bias applied when `prev`
        is given."""
        nbrs = self._adj[cur]
        ids = np.asarray([n for n, _ in nbrs])
        w = np.asarray([wt for _, wt in nbrs], np.float64) \
            if weighted else np.ones(len(nbrs))
        if prev is not None:
            bias = np.ones(len(nbrs))
            prev_nbrs = set(self.neighbors(prev))
            for i, nxt in enumerate(ids):
                if nxt == prev:
                    bias[i] = 1.0 / p
                elif int(nxt) not in prev_nbrs:
                    bias[i] = 1.0 / q
            w = w * bias
        if not (np.all(w >= 0) and w.sum() > 0):
            raise ValueError(f"vertex {cur}: edge weights must be "
                             f"non-negative with a positive sum")
        cdf = (w / w.sum()).cumsum()
        cdf /= cdf[-1]
        return ids, cdf
