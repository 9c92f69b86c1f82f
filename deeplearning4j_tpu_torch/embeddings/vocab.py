"""Vocabulary cache + Huffman coding.

Parity: DL4J `models/word2vec/wordstore/inmemory/AbstractCache` (vocab with
frequencies, min-count pruning, special tokens) and
`models/embeddings/loader/` Huffman tree construction used by hierarchical
softmax (codes/points per word).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class VocabWord:
    word: str
    count: int = 0
    index: int = -1
    codes: Optional[List[int]] = None      # Huffman code (0/1 per level)
    points: Optional[List[int]] = None     # inner-node indices on the path


class VocabCache:
    """Frequency-ordered vocabulary (DL4J AbstractCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._ordered: List[VocabWord] = []

    # ------------------------------------------------------------ building
    def add_token(self, word: str, count: int = 1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word)
            self._words[word] = vw
        vw.count += count

    def build(self, min_count: int = 1):
        """Prune by min_count, assign frequency-descending indices."""
        kept = [w for w in self._words.values() if w.count >= min_count]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._ordered = kept
        self._words = {w.word: w for w in kept}
        for i, w in enumerate(kept):
            w.index = i
        return self

    # ------------------------------------------------------------- queries
    def __len__(self):
        return len(self._ordered)

    def __contains__(self, word):
        return word in self._words

    def word_for(self, index: int) -> str:
        return self._ordered[index].word

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def count_of(self, word: str) -> int:
        vw = self._words.get(word)
        return 0 if vw is None else vw.count

    def words(self) -> List[str]:
        return [w.word for w in self._ordered]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._ordered)

    def total_count(self) -> int:
        return sum(w.count for w in self._ordered)

    # ---------------------------------------------------- sampling support
    def unigram_table(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution (word2vec's f^0.75 table)."""
        freqs = np.asarray([w.count for w in self._ordered], np.float64)
        probs = freqs ** power
        return (probs / probs.sum()).astype(np.float32)

    # ------------------------------------------------------------- huffman
    def build_huffman(self):
        """Assign Huffman codes/points (DL4J Huffman.java): path from root
        to leaf through inner nodes, used by hierarchical softmax."""
        n = len(self._ordered)
        if n == 0:
            return self
        heap = [(w.count, i, i) for i, w in enumerate(self._ordered)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_id
            parent[n2] = next_id
            binary[n1] = 0
            binary[n2] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2] if heap else None
        for i, w in enumerate(self._ordered):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(binary[node])
                node = parent[node]
                points.append(node - n)    # inner-node index (0-based)
            w.codes = list(reversed(codes))
            w.points = list(reversed(points))
        return self

    def max_code_length(self) -> int:
        return max((len(w.codes or []) for w in self._ordered), default=0)
