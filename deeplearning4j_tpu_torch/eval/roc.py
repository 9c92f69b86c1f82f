"""ROC / AUC and probability-calibration evaluation.

A copy of the JAX package's `eval/roc.py`: numpy over host arrays of
the network's outputs, so the two packages' metrics agree exactly.

Parity targets: DL4J eval/ROC.java:58 (binary ROC/AUC + PR curve),
eval/ROCMultiClass.java (one-vs-all per class), and
eval/EvaluationCalibration.java (reliability diagram + histograms).
Exact (threshold-free) AUC via rank statistics — equivalent to DL4J's
`thresholdSteps=0` exact mode.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _auc_exact(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC by the rank-sum (Mann-Whitney U) method."""
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), np.float64)
    combined = np.concatenate([pos, neg])[order]
    # average ranks for ties
    i = 0
    while i < len(combined):
        j = i
        while j + 1 < len(combined) and combined[j + 1] == combined[i]:
            j += 1
        ranks[i:j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    pos_ranks = ranks[inv[:len(pos)]]
    u = pos_ranks.sum() - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


class ROC:
    """Binary ROC (DL4J eval/ROC.java). Accumulates scores; curves/AUC exact."""

    def __init__(self):
        self._labels: List[np.ndarray] = []
        self._scores: List[np.ndarray] = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        self._labels.append(labels.reshape(-1).astype(np.float64))
        self._scores.append(predictions.reshape(-1).astype(np.float64))

    def _all(self):
        return np.concatenate(self._labels), np.concatenate(self._scores)

    def calculate_auc(self) -> float:
        labels, scores = self._all()
        return _auc_exact(labels, scores)

    def calculate_aucpr(self) -> float:
        """Area under precision-recall curve (trapezoidal on exact curve)."""
        labels, scores = self._all()
        order = np.argsort(-scores, kind="mergesort")
        labels = labels[order]
        tp = np.cumsum(labels)
        fp = np.cumsum(1 - labels)
        total_pos = labels.sum()
        if total_pos == 0:
            return 0.0
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / total_pos
        return float(np.trapezoid(precision, recall))

    def roc_curve(self, steps: int = 100):
        labels, scores = self._all()
        thresholds = np.linspace(0, 1, steps + 1)
        total_pos = max(labels.sum(), 1)
        total_neg = max((1 - labels).sum(), 1)
        tpr = [(scores >= t)[labels > 0.5].sum() / total_pos for t in thresholds]
        fpr = [(scores >= t)[labels <= 0.5].sum() / total_neg for t in thresholds]
        return np.array(fpr), np.array(tpr), thresholds


class ROCMultiClass:
    """One-vs-all ROC per class (DL4J eval/ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        nc = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(nc)]
        for c in range(nc):
            self._rocs[c].eval(labels[..., c], predictions[..., c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class EvaluationCalibration:
    """Reliability diagram + label/prediction histograms
    (DL4J eval/EvaluationCalibration.java)."""

    def __init__(self, reliability_bins: int = 10):
        self.bins = reliability_bins
        self._bin_counts = np.zeros(reliability_bins, np.int64)
        self._bin_pos = np.zeros(reliability_bins, np.int64)
        self._bin_prob_sum = np.zeros(reliability_bins, np.float64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = np.asarray(labels).reshape(-1)
        probs = np.asarray(predictions).reshape(-1)
        idx = np.clip((probs * self.bins).astype(int), 0, self.bins - 1)
        np.add.at(self._bin_counts, idx, 1)
        np.add.at(self._bin_pos, idx, (labels > 0.5).astype(np.int64))
        np.add.at(self._bin_prob_sum, idx, probs)

    def reliability_diagram(self):
        """Returns (mean predicted prob, empirical frequency) per bin."""
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_prob = self._bin_prob_sum / np.maximum(self._bin_counts, 1)
            freq = self._bin_pos / np.maximum(self._bin_counts, 1)
        return mean_prob, freq

    def expected_calibration_error(self) -> float:
        mean_prob, freq = self.reliability_diagram()
        total = max(self._bin_counts.sum(), 1)
        w = self._bin_counts / total
        return float(np.sum(w * np.abs(mean_prob - freq)))
