"""WordVectors — lookup + similarity + serde.

Parity: DL4J `models/embeddings/wordvectors/WordVectorsImpl` (getWordVector,
similarity, wordsNearest) and `models/embeddings/loader/
WordVectorSerializer` (word2vec text format write/read).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.embeddings.vocab import VocabCache


class WordVectors:
    def __init__(self, vocab: VocabCache, vectors: np.ndarray):
        self.vocab = vocab
        self.vectors = np.asarray(vectors, np.float32)   # (V, D)
        self.layer_size = int(self.vectors.shape[1])

    def has_word(self, word: str) -> bool:
        return word in self.vocab

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.vectors[i]

    def get_word_vectors(self, words: Sequence[str]) -> np.ndarray:
        return np.stack([self.get_word_vector(w) for w in words])

    # ---------------------------------------------------------- similarity
    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom > 0 else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """Cosine nearest neighbors (DL4J wordsNearest)."""
        if isinstance(word_or_vec, str):
            v = self.get_word_vector(word_or_vec)
            if v is None:
                return []
            exclude = {self.vocab.index_of(word_or_vec)}
        else:
            v = np.asarray(word_or_vec, np.float32)
            exclude = set()
        norms = np.linalg.norm(self.vectors, axis=1) + 1e-9
        sims = (self.vectors @ v) / (norms * (np.linalg.norm(v) + 1e-9))
        order = np.argsort(-sims)
        out = []
        for i in order:
            if int(i) in exclude:
                continue
            out.append(self.vocab.word_for(int(i)))
            if len(out) == top_n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str] = (),
                          top_n: int = 10) -> List[str]:
        """king - man + woman style queries (DL4J wordsNearest(pos, neg, n))."""
        v = np.zeros(self.layer_size, np.float32)
        for w in positive:
            vec = self.get_word_vector(w)
            if vec is not None:
                v += vec
        for w in negative:
            vec = self.get_word_vector(w)
            if vec is not None:
                v -= vec
        out = self.words_nearest(v, top_n + len(positive) + len(negative))
        skip = set(positive) | set(negative)
        return [w for w in out if w not in skip][:top_n]

    # --------------------------------------------------------------- serde
    def save_text(self, path: str):
        """word2vec text format (WordVectorSerializer.writeWordVectors)."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(self.vocab)} {self.layer_size}\n")
            for i, w in enumerate(self.vocab.words()):
                vals = " ".join(f"{x:.6f}" for x in self.vectors[i])
                f.write(f"{w} {vals}\n")

    @staticmethod
    def load_text(path: str) -> "WordVectors":
        with open(path, encoding="utf-8") as f:
            header = f.readline().split()
            n, d = int(header[0]), int(header[1])
            vocab = VocabCache()
            vectors = np.zeros((n, d), np.float32)
            for i in range(n):
                parts = f.readline().rstrip("\n").split(" ")
                vocab.add_token(parts[0], count=max(1, n - i))
                vectors[i] = [float(x) for x in parts[1:d + 1]]
        vocab.build(min_count=1)
        # rebuild may reorder ties alphabetically; remap vector rows
        remap = np.zeros((n, d), np.float32)
        with open(path, encoding="utf-8") as f:
            f.readline()
            for _ in range(n):
                parts = f.readline().rstrip("\n").split(" ")
                idx = vocab.index_of(parts[0])
                remap[idx] = [float(x) for x in parts[1:d + 1]]
        return WordVectors(vocab, remap)
