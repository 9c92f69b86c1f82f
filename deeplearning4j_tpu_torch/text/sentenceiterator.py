"""Sentence iterators (DL4J `text/sentenceiterator/` parity)."""
from __future__ import annotations

import os
from typing import Iterable, Iterator


class SentenceIterator:
    def sentences(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass

    def __iter__(self):
        return self.sentences()


class CollectionSentenceIterator(SentenceIterator):
    """In-memory sentences (DL4J CollectionSentenceIterator)."""

    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)

    def sentences(self):
        return iter(self._sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (DL4J BasicLineIterator)."""

    def __init__(self, path: str):
        self.path = path

    def sentences(self):
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, one sentence per line (DL4J
    FileSentenceIterator)."""

    def __init__(self, directory: str):
        self.directory = directory

    def sentences(self):
        for root, _, names in os.walk(self.directory):
            for n in sorted(names):
                with open(os.path.join(root, n), encoding="utf-8",
                          errors="ignore") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


class LabelAwareIterator(SentenceIterator):
    """(label, sentence) pairs for ParagraphVectors (DL4J LabelAware
    iterators)."""

    def __init__(self, documents: Iterable):
        """documents: iterable of (label, text)."""
        self._docs = list(documents)

    def documents(self):
        return iter(self._docs)

    def sentences(self):
        return iter(text for _, text in self._docs)
