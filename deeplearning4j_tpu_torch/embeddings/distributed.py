"""Distributed Word2Vec — partitioned corpus, averaged tables.

Parity: DL4J `spark/dl4j-spark-nlp/.../word2vec/Word2Vec.java:61` — the
Spark driver broadcasts the vocab, each executor trains skip-gram on its
corpus partition (Word2VecPerformer over a SentenceBatch), and the driver
folds the per-partition table updates back together (Word2VecChange /
Word2VecParam parameter-averaging flow).

As in the reference: the vocab is built once over the full corpus (the
driver role), the corpus splits into `n_workers` partitions, each logical
worker trains its partition with the C++ HogWild kernel (or the device
backend, on the fit's device) from the shared starting tables, and after
every epoch the tables are averaged on the host, exactly
ParameterAveragingTrainingMaster semantics applied to embedding tables.
In-process workers mirror the reference's local[N] test topology.
"""
from __future__ import annotations

import logging
from typing import List

import numpy as np

from deeplearning4j_tpu_torch.embeddings.word2vec import Word2Vec
from deeplearning4j_tpu_torch.util.platform import resolve_device

log = logging.getLogger("deeplearning4j_tpu_torch")


class SparkWord2Vec(Word2Vec):
    """Partition-parallel Word2Vec with per-epoch table averaging.

    Usage:
        w2v = SparkWord2Vec(n_workers=4, layer_size=64, epochs=5)
        w2v.fit(sentence_iterator)
    """

    def __init__(self, n_workers: int = 2, average_every_epoch: bool = True,
                 **kwargs):
        kwargs.setdefault("backend", "device")
        super().__init__(**kwargs)
        self.n_workers = max(1, n_workers)
        self.average_every_epoch = average_every_epoch

    def fit(self, source, device=None):
        if self.backend != "native":
            self.device = resolve_device(device)
        if len(self.vocab) == 0:
            self.build_vocab(source)     # driver-side vocab broadcast
        sentences = [list(s) for s in self._sequences(source)]
        if not sentences:
            raise ValueError("empty corpus")
        parts: List[List[List[str]]] = [
            sentences[w::self.n_workers] for w in range(self.n_workers)]
        parts = [p for p in parts if p]

        V, D = len(self.vocab), self.layer_size
        rs = np.random.RandomState(self.seed)
        syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
        syn1 = np.zeros((V, D), np.float32)

        total_epochs = self.epochs
        for epoch in range(total_epochs):
            w_in_parts, w_out_parts = [], []
            for w, part in enumerate(parts):
                worker = Word2Vec(
                    tokenizer=self.tokenizer, stop_words=self.stop_words,
                    layer_size=D, window=self.window, min_count=1,
                    negative=self.negative, use_hierarchic_softmax=False,
                    subsampling=self.subsampling,
                    learning_rate=self.learning_rate * (1 - epoch /
                                                        total_epochs),
                    min_learning_rate=self.min_learning_rate,
                    epochs=1, batch_size=self.batch_size,
                    backend=self.backend, n_threads=self.n_threads,
                    seed=self.seed + 1000 * epoch + w)
                # broadcast: shared vocab + current tables
                worker.vocab = self.vocab
                worker.fit(part, initial_syn0=syn0.copy(),
                           initial_syn1neg=syn1.copy(), device=device)
                w_in_parts.append(worker.vectors)
                w_out_parts.append(worker.w_out)
            # fold: average the partition results (Word2VecChange)
            weights = np.asarray([sum(len(s) for s in p) for p in parts],
                                 np.float64)
            weights /= weights.sum()
            syn0 = np.einsum("w,wvd->vd", weights,
                             np.stack(w_in_parts)).astype(np.float32)
            syn1 = np.einsum("w,wvd->vd", weights,
                             np.stack(w_out_parts)).astype(np.float32)
        self.vectors = syn0
        self.w_out = syn1
        return self
