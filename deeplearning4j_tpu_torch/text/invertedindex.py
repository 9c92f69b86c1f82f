"""In-memory inverted index.

Parity: DL4J `text/invertedindex/InvertedIndex` + its in-memory
implementation — term -> postings used by the text vectorizers for document
frequencies and by retrieval-style lookups. Host-side structure, plain
Python by design.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Set


class InMemoryInvertedIndex:
    """term -> sorted list of (doc_id, positions); also tracks per-document
    token lists so vectorizers can re-iterate the corpus."""

    def __init__(self):
        self._postings: Dict[str, Dict[int, List[int]]] = defaultdict(dict)
        self._docs: Dict[int, List[str]] = {}

    # -------------------------------------------------------------- build
    def add_doc(self, doc_id: int, tokens: Sequence[str]):
        if doc_id in self._docs:
            raise ValueError(f"doc {doc_id} already indexed")
        self._docs[doc_id] = list(tokens)
        for pos, tok in enumerate(tokens):
            self._postings[tok].setdefault(doc_id, []).append(pos)

    # -------------------------------------------------------------- stats
    def num_documents(self) -> int:
        return len(self._docs)

    def document(self, doc_id: int) -> List[str]:
        return self._docs[doc_id]

    def documents(self) -> Iterable[int]:
        return self._docs.keys()

    def doc_appeared_in(self, word: str) -> int:
        """Document frequency (DL4J VocabCache.docAppearedIn)."""
        return len(self._postings.get(word, ()))

    def term_frequency(self, word: str, doc_id: int) -> int:
        return len(self._postings.get(word, {}).get(doc_id, ()))

    def total_term_frequency(self, word: str) -> int:
        return sum(len(p) for p in self._postings.get(word, {}).values())

    def vocabulary(self) -> List[str]:
        return list(self._postings.keys())

    # ------------------------------------------------------------- search
    def docs_containing(self, word: str) -> Set[int]:
        return set(self._postings.get(word, ()))

    def search(self, *words: str) -> List[int]:
        """Conjunctive search: sorted doc ids containing ALL words."""
        if not words:
            return []
        acc = self.docs_containing(words[0])
        for w in words[1:]:
            acc &= self.docs_containing(w)
        return sorted(acc)
