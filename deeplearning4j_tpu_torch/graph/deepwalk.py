"""DeepWalk / GraphVectors (DL4J `graph/models/deepwalk/DeepWalk.java`,
`graph/models/GraphVectors.java`).

DeepWalk = random walks + skip-gram: the walk corpus feeds the same
batched SequenceVectors trainer Word2Vec uses, on the fit's device (the
reference builds its own hierarchical-softmax `GraphHuffman`; here
use_hierarchic_softmax=True reuses the shared Huffman machinery). node2vec's p/q biased walks come from
Graph.random_walks.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.embeddings.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.graph.graph import Graph


class GraphVectors(SequenceVectors):
    """Vertex embeddings with similarity/nearest queries by vertex id."""

    def _sequences(self, source) -> Iterable[List[str]]:
        for walk in source:
            yield [str(v) for v in walk]

    # --------------------------------------------------- id-based queries
    def vertex_vector(self, v: int) -> Optional[np.ndarray]:
        return self.get_word_vector(str(v))

    def vertex_similarity(self, a: int, b: int) -> float:
        return self.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 5) -> List[int]:
        return [int(w) for w in self.words_nearest(str(v), top_n)]


class DeepWalk(GraphVectors):
    """DL4J DeepWalk builder: windowSize, vectorSize, walkLength,
    walksPerVertex + node2vec p/q extension."""

    def __init__(self, layer_size: int = 64, window: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 weighted: bool = False, p: float = 1.0, q: float = 1.0,
                 **kwargs):
        kwargs.setdefault("min_count", 1)
        kwargs.setdefault("negative", 5)
        super().__init__(layer_size=layer_size, window=window, **kwargs)
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.weighted = weighted
        self.p = p
        self.q = q

    def fit_graph(self, graph: Graph, device=None) -> "DeepWalk":
        walks = list(graph.random_walks(
            walk_length=self.walk_length,
            walks_per_vertex=self.walks_per_vertex,
            weighted=self.weighted, seed=self.seed, p=self.p, q=self.q))
        return self.fit(walks, device=device)
