"""Regression evaluation.

A copy of the JAX package's `eval/regression.py`: numpy over host arrays of
the network's outputs, so the two packages' metrics agree exactly.

Parity target: DL4J eval/RegressionEvaluation.java:33 — per-column MSE, MAE,
RMSE, RSE, PC (Pearson correlation), R^2, streamed over batches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self._n = 0
        self._sum_err_sq = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if self._sum_err_sq is None:
            c = labels.shape[-1]
            z = lambda: np.zeros(c, np.float64)
            self._sum_err_sq, self._sum_abs_err = z(), z()
            self._sum_label, self._sum_label_sq = z(), z()
            self._sum_pred, self._sum_pred_sq = z(), z()
            self._sum_label_pred = z()
        err = predictions - labels
        self._n += labels.shape[0]
        self._sum_err_sq += np.sum(err ** 2, axis=0)
        self._sum_abs_err += np.sum(np.abs(err), axis=0)
        self._sum_label += np.sum(labels, axis=0)
        self._sum_label_sq += np.sum(labels ** 2, axis=0)
        self._sum_pred += np.sum(predictions, axis=0)
        self._sum_pred_sq += np.sum(predictions ** 2, axis=0)
        self._sum_label_pred += np.sum(labels * predictions, axis=0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_err_sq[col] / self._n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / self._n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self._sum_err_sq[col] / self._n))

    def relative_squared_error(self, col: int = 0) -> float:
        mean_label = self._sum_label[col] / self._n
        ss_tot = self._sum_label_sq[col] - self._n * mean_label ** 2
        return float(self._sum_err_sq[col] / ss_tot) if ss_tot else float("inf")

    def pearson_correlation(self, col: int = 0) -> float:
        n = self._n
        num = n * self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col]
        d1 = n * self._sum_label_sq[col] - self._sum_label[col] ** 2
        d2 = n * self._sum_pred_sq[col] - self._sum_pred[col] ** 2
        denom = np.sqrt(d1 * d2)
        return float(num / denom) if denom else 0.0

    def r_squared(self, col: int = 0) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_err_sq / self._n))

    def stats(self) -> str:
        cols = len(self._sum_err_sq)
        lines = ["Column    MSE            MAE            RMSE           RSE            PC             R^2"]
        for c in range(cols):
            lines.append(
                f"col_{c}   {self.mean_squared_error(c):.6e}  "
                f"{self.mean_absolute_error(c):.6e}  "
                f"{self.root_mean_squared_error(c):.6e}  "
                f"{self.relative_squared_error(c):.6e}  "
                f"{self.pearson_correlation(c):.6e}  {self.r_squared(c):.6e}")
        return "\n".join(lines)
