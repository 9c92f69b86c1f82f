"""Classification evaluation.

A copy of the JAX package's `eval/evaluation.py`: numpy over host arrays of
the network's outputs, so the two packages' metrics agree exactly.

Parity target: DL4J eval/Evaluation.java:88 (confusion matrix, accuracy,
precision/recall/F1 incl. macro/micro averaging, top-N accuracy) and
eval/EvaluationBinary.java (per-output binary metrics for multi-label).
Accumulation is streaming (eval() per batch), matching DL4J's
iterator-driven evaluation; masks follow DL4J time-series semantics.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class ConfusionMatrix:
    """Dense integer confusion matrix (DL4J eval/ConfusionMatrix.java)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 label_names: Optional[List[str]] = None, top_n: int = 1):
        self._num_classes = num_classes
        self.label_names = label_names
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self._top_n_correct = 0
        self._count = 0

    def _flatten(self, labels, predictions, mask):
        """Collapse (B,T,C)+mask time series to (N,C) rows (DL4J
        evalTimeSeries semantics)."""
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(b * t) > 0
                labels, predictions = labels[keep], predictions[keep]
        return labels, predictions

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions = self._flatten(labels, predictions, mask)
        if labels.ndim == 1 or labels.shape[-1] == 1:
            actual = labels.astype(np.int64).reshape(-1)
            nc = self._num_classes or predictions.shape[-1]
        else:
            actual = np.argmax(labels, axis=-1)
            nc = self._num_classes or labels.shape[-1]
        pred = np.argmax(predictions, axis=-1)
        if self.confusion is None:
            self.confusion = ConfusionMatrix(nc)
        self.confusion.add(actual, pred)
        self._count += len(actual)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self._top_n_correct += int(np.sum(top == actual[:, None]))

    # ------------------------------------------------------------- metrics
    def _tp(self):
        return np.diag(self.confusion.matrix).astype(np.float64)

    def _row(self):
        return self.confusion.matrix.sum(axis=1).astype(np.float64)  # actual counts

    def _col(self):
        return self.confusion.matrix.sum(axis=0).astype(np.float64)  # predicted counts

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.diag(m).sum() / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        return self._top_n_correct / self._count if self._count else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        tp, col = self._tp(), self._col()
        if cls is not None:
            return float(tp[cls] / col[cls]) if col[cls] else 0.0
        valid = col > 0
        return float(np.mean(tp[valid] / col[valid])) if valid.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        tp, row = self._tp(), self._row()
        if cls is not None:
            return float(tp[cls] / row[cls]) if row[cls] else 0.0
        valid = row > 0
        return float(np.mean(tp[valid] / row[valid])) if valid.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        fp = m[:, cls].sum() - m[cls, cls]
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        m = self.confusion.matrix
        tp = m[cls, cls]
        fp = m[:, cls].sum() - tp
        fn = m[cls, :].sum() - tp
        tn = m.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.confusion.num_classes}",
            f" Examples:        {self._count}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} accuracy: {self.top_n_accuracy():.4f}")
        lines.append("=================Confusion Matrix=================")
        lines.append(str(self.confusion))
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics for multi-label sigmoid outputs
    (DL4J eval/EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        pred = (np.asarray(predictions) >= self.threshold).astype(np.int64)
        lab = (labels >= 0.5).astype(np.int64)
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        w = np.ones(labels.shape) if mask is None else np.asarray(mask)
        if w.ndim < labels.ndim:
            w = w[..., None]
        axes = tuple(range(labels.ndim - 1))
        self.tp += np.sum((pred == 1) & (lab == 1) * (w > 0), axis=axes).astype(np.int64)
        self.fp += np.sum((pred == 1) & (lab == 0) * (w > 0), axis=axes).astype(np.int64)
        self.tn += np.sum((pred == 0) & (lab == 0) * (w > 0), axis=axes).astype(np.int64)
        self.fn += np.sum((pred == 0) & (lab == 1) * (w > 0), axis=axes).astype(np.int64)

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0
