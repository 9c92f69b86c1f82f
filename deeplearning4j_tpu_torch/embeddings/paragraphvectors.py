"""ParagraphVectors / doc2vec (DL4J `models/paragraphvectors/ParagraphVectors.java`).

PV-DBOW ("DBOW" sequence learning algorithm in DL4J): each document label
gets a vector that predicts the document's words via the same
negative-sampling machinery as skip-gram — the label vector plays the
center role. PV-DM ("DM"): the label vector joins the context-window mean
(CBOW with an extra label column). Inference of unseen documents runs
gradient steps on a fresh label vector with frozen word tables
(DL4J inferVector).

The port's label steps are the skip-gram step of `sequencevectors.py` on
the fit's device; the host draws the same negatives as the reference.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from deeplearning4j_tpu_torch.embeddings import sequencevectors as sv
from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    SequenceVectors, _f32, _f32_lr, _ids, _table_on,
)


class ParagraphVectors(SequenceVectors):
    def __init__(self, tokenizer=None, sequence_learning_algorithm="dbow",
                 **kwargs):
        super().__init__(**kwargs)
        if tokenizer is None:
            from deeplearning4j_tpu_torch.text.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer = DefaultTokenizerFactory()
        self.tokenizer = tokenizer
        self.sequence_algorithm = sequence_learning_algorithm
        self.labels: List[str] = []
        self.label_vectors: np.ndarray = np.zeros((0, self.layer_size),
                                                  np.float32)

    # documents: iterable of (label, text)
    def _docs(self, source) -> Iterable[Tuple[str, List[str]]]:
        docs = source.documents() if hasattr(source, "documents") else source
        for label, text in docs:
            toks = self.tokenizer.tokenize(text) if isinstance(text, str) \
                else list(text)
            if toks:
                yield label, toks

    def _sequences(self, source):
        for _, toks in self._docs(source):
            yield toks

    def fit(self, source, device=None):
        # 1. word tables via the standard element training
        super().fit(source, device=device)
        # 2. label vectors: DBOW — label predicts each word of its doc
        self.labels = []
        label_idx = {}
        pairs_c, pairs_t = [], []
        docs = list(self._docs(source))
        for label, toks in docs:
            if label not in label_idx:
                label_idx[label] = len(self.labels)
                self.labels.append(label)
        rs = self._rs
        L, D = len(self.labels), self.layer_size
        V = len(self.vocab)
        dev = self.device
        lab_vecs = _table_on((rs.rand(L, D).astype(np.float32) - 0.5) / D,
                            dev)
        w_out = _table_on(self.w_out, dev)
        table = self.vocab.unigram_table()
        lr = _f32_lr(self.learning_rate)
        for _ in range(self.epochs):
            for label, toks in docs:
                ids = [self.vocab.index_of(t) for t in toks]
                ids = [i for i in ids if i >= 0]
                if not ids:
                    continue
                li = label_idx[label]
                centers = np.full(len(ids), li, np.int32)
                negs = rs.choice(V, (len(ids), self.negative), p=table)
                targets = np.concatenate(
                    [np.asarray(ids, np.int32)[:, None], negs], axis=1)
                labels_arr = np.zeros_like(targets, np.float32)
                labels_arr[:, 0] = 1.0
                sv._sg_ns_step(lab_vecs, w_out, _ids(centers, dev),
                               _ids(targets, dev), _f32(labels_arr, dev),
                               lr)
        self.label_vectors = lab_vecs.cpu().numpy()
        return self

    # ------------------------------------------------------------- queries
    def get_label_vector(self, label: str):
        try:
            i = self.labels.index(label)
        except ValueError:
            return None
        return self.label_vectors[i]

    def infer_vector(self, text: str, steps: int = 50,
                     learning_rate: float = 0.5) -> np.ndarray:
        """Gradient-fit a fresh doc vector with frozen tables
        (DL4J inferVector), on the device of the last fit."""
        toks = self.tokenizer.tokenize(text)
        ids = [self.vocab.index_of(t) for t in toks]
        ids = [i for i in ids if i >= 0]
        rs = self._rs
        D = self.layer_size
        V = len(self.vocab)
        if not ids:
            return np.zeros(D, np.float32)
        dev = self.device
        vec = _table_on((rs.rand(1, D).astype(np.float32) - 0.5) / D, dev)
        w_out = _table_on(self.w_out, dev)
        table = self.vocab.unigram_table()
        lr = _f32_lr(learning_rate)
        for _ in range(steps):
            negs = rs.choice(V, (len(ids), self.negative), p=table)
            targets = np.concatenate(
                [np.asarray(ids, np.int32)[:, None], negs], axis=1)
            labels_arr = np.zeros_like(targets, np.float32)
            labels_arr[:, 0] = 1.0
            centers = np.zeros(len(ids), np.int32)
            # the word table stays frozen: only the doc vector moves
            centers_t = _ids(centers, dev)
            grad_vc, _, _ = sv._sg_ns_grads(vec, w_out, centers_t,
                                            _ids(targets, dev),
                                            _f32(labels_arr, dev))
            vec.index_add_(0, centers_t, -lr * grad_vc)
        return vec.cpu().numpy()[0]

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        if lv is None:
            return float("nan")
        denom = np.linalg.norm(v) * np.linalg.norm(lv) + 1e-9
        return float(v @ lv / denom)

    def nearest_labels(self, text: str, top_n: int = 5) -> List[str]:
        v = self.infer_vector(text)
        norms = np.linalg.norm(self.label_vectors, axis=1) + 1e-9
        sims = (self.label_vectors @ v) / (norms * (np.linalg.norm(v) + 1e-9))
        order = np.argsort(-sims)[:top_n]
        return [self.labels[int(i)] for i in order]
