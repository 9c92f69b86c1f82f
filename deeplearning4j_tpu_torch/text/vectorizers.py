"""Bag-of-words and TF-IDF text vectorizers.

Parity: DL4J `bagofwords/vectorizer/{BaseTextVectorizer, BagOfWordsVectorizer,
TfidfVectorizer}.java` with the exact reference weighting
(`clustering/util/MathUtils.java:258-286`):
    tf(word, doc)  = count / doc_length
    idf(word)      = log10(total_docs / docs_containing_word)
    tfidf          = tf * idf
BagOfWords emits raw counts. Vocabulary building honors min_word_frequency
and stop words like BaseTextVectorizer.buildVocab.

The vectorizers are the text-classification on-ramp: fit() over a
LabelAwareIterator, then `vectorize()` yields a DataSet whose rows feed an
OutputLayer classifier directly. Matrix assembly is host-side numpy; the
classifier consumes it on the device (the port's `data.dataset.DataSet`
holds host numpy arrays; `fit` moves each batch to the network's device).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.text.documentiterator import (
    LabelAwareIterator, LabelsSource, SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.text.invertedindex import InMemoryInvertedIndex
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory


class BaseTextVectorizer:
    """Vocab construction + corpus scan shared by BoW/TF-IDF
    (DL4J BaseTextVectorizer.buildVocab)."""

    def __init__(self, iterator=None, tokenizer_factory=None,
                 min_word_frequency: int = 1,
                 stop_words: Optional[Iterable[str]] = None,
                 index: Optional[InMemoryInvertedIndex] = None):
        if iterator is not None and not isinstance(iterator,
                                                   LabelAwareIterator):
            iterator = SimpleLabelAwareIterator(iterator)
        self.iterator = iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = max(1, min_word_frequency)
        self.stop_words = set(stop_words or ())
        self.index = index if index is not None else InMemoryInvertedIndex()
        self.labels_source: LabelsSource = (
            iterator.labels_source if iterator is not None else LabelsSource())
        self.vocab: List[str] = []
        self._vocab_index = {}
        self._doc_freq = {}
        self._doc_labels: List[str] = []
        self._fitted = False

    # ---------------------------------------------------------------- fit
    def fit(self):
        """Scan the corpus: tokenize, build the inverted index, then keep
        words with frequency >= min_word_frequency that are not stop words
        (BaseTextVectorizer.buildVocab). Re-runnable: each fit() rebuilds
        the index and per-document bookkeeping from scratch."""
        if self.iterator is None:
            raise ValueError("vectorizer needs a document iterator to fit")
        self.index = InMemoryInvertedIndex()
        self._doc_labels = []
        counts = Counter()
        doc_id = 0
        self.iterator.reset()
        for doc in self.iterator:
            tokens = [t for t in self.tokenizer_factory.tokenize(doc.content)
                      if t not in self.stop_words]
            self.index.add_doc(doc_id, tokens)
            counts.update(tokens)
            self._doc_labels.append(doc.label)
            doc_id += 1
        self.vocab = sorted(w for w, c in counts.items()
                            if c >= self.min_word_frequency)
        self._vocab_index = {w: i for i, w in enumerate(self.vocab)}
        self._doc_freq = {w: self.index.doc_appeared_in(w)
                          for w in self.vocab}
        self._fitted = True
        return self

    def _require_fit(self):
        if not self._fitted:
            raise RuntimeError("call fit() first")

    def num_words(self) -> int:
        self._require_fit()
        return len(self.vocab)

    def index_of(self, word: str) -> int:
        return self._vocab_index.get(word, -1)

    # ---------------------------------------------------------- transform
    def _weights(self, tokens: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def transform(self, text_or_tokens) -> np.ndarray:
        """(1, V) weight row for one document (TextVectorizer.transform).
        Stop words are filtered exactly as in fit(), so the same document
        gets the same weights at inference time as it had in the corpus."""
        self._require_fit()
        tokens = (self.tokenizer_factory.tokenize(text_or_tokens)
                  if isinstance(text_or_tokens, str) else list(text_or_tokens))
        tokens = [t for t in tokens if t not in self.stop_words]
        return self._weights(tokens)[None, :]

    def vectorize(self, text: Optional[str] = None,
                  label: Optional[str] = None) -> DataSet:
        """One labelled document -> DataSet row, or (with no args) the whole
        fitted corpus -> (N, V) features + one-hot labels
        (TfidfVectorizer.vectorize)."""
        self._require_fit()
        n_labels = max(1, self.labels_source.size())
        if text is not None:
            x = self.transform(text)
            y = np.zeros((1, n_labels), np.float32)
            li = self.labels_source.index_of(label)
            if li >= 0:
                y[0, li] = 1.0
            return DataSet(x.astype(np.float32), y)
        rows = []
        labels = np.zeros((self.index.num_documents(), n_labels), np.float32)
        for doc_id in sorted(self.index.documents()):
            rows.append(self._weights(self.index.document(doc_id)))
            li = self.labels_source.index_of(self._doc_labels[doc_id])
            if li >= 0:
                labels[doc_id, li] = 1.0
        return DataSet(np.stack(rows).astype(np.float32), labels)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw in-document word counts (DL4J BagOfWordsVectorizer)."""

    def _weights(self, tokens: Sequence[str]) -> np.ndarray:
        row = np.zeros((len(self.vocab),), np.float32)
        for tok, c in Counter(tokens).items():
            i = self._vocab_index.get(tok, -1)
            if i >= 0:
                row[i] = float(c)
        return row


class TfidfVectorizer(BaseTextVectorizer):
    """tf * idf weights with the reference formulas
    (TfidfVectorizer.tfidfWord, MathUtils.idf/tf)."""

    def idf(self, word: str) -> float:
        self._require_fit()
        total = self.index.num_documents()
        df = self._doc_freq.get(word, 0)
        if total == 0 or df == 0:
            return 0.0
        return math.log10(total / df)

    def _weights(self, tokens: Sequence[str]) -> np.ndarray:
        row = np.zeros((len(self.vocab),), np.float32)
        if not tokens:
            return row
        n = len(tokens)
        for tok, c in Counter(tokens).items():
            i = self._vocab_index.get(tok, -1)
            if i >= 0:
                row[i] = (c / n) * self.idf(tok)
        return row
