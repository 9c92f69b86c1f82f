"""The port's evaluation accumulators (`eval/*`, numpy copies) against
the JAX package's on the same labels and predictions: every metric of
Evaluation (top-N, per class and averaged, the confusion matrix, masked
time series), EvaluationBinary, ROC and ROCMultiClass (AUC, AUCPR, the
curve), EvaluationCalibration and RegressionEvaluation, fed in several
batches. The same numpy on the same inputs: results equal to rtol
1e-12.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu_torch import eval as peval

EXACT = dict(rtol=1e-12, atol=0)


def _probs(rs, shape):
    z = rs.randn(*shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _feed(make, batches):
    p, j = make(peval), make(jeval)
    for args in batches:
        p.eval(*args)
        j.eval(*args)
    return p, j


def test_evaluation_multiclass_top_n_and_masked_time_series():
    rs = np.random.RandomState(0)
    flat = [(np.eye(4)[rs.randint(0, 4, 32)], _probs(rs, (32, 4)))
            for _ in range(3)]
    p, j = _feed(lambda m: m.Evaluation(top_n=2), flat)
    assert p.accuracy() == j.accuracy()
    assert p.top_n_accuracy() == j.top_n_accuracy()
    np.testing.assert_array_equal(p.confusion.matrix, j.confusion.matrix)
    for c in (None, 0, 3):
        for m in ("precision", "recall", "f1"):
            np.testing.assert_allclose(getattr(p, m)(c), getattr(j, m)(c),
                                       **EXACT)
    for c in range(4):
        np.testing.assert_allclose(p.false_positive_rate(c),
                                   j.false_positive_rate(c), **EXACT)
        np.testing.assert_allclose(p.matthews_correlation(c),
                                   j.matthews_correlation(c), **EXACT)
    assert p.stats() == j.stats()
    mask = (rs.rand(4, 6) > 0.3).astype(np.float32)
    seq = [(np.eye(3)[rs.randint(0, 3, (4, 6))], _probs(rs, (4, 6, 3)),
            mask)]
    p, j = _feed(lambda m: m.Evaluation(), seq)
    np.testing.assert_array_equal(p.confusion.matrix, j.confusion.matrix)
    assert p.confusion.matrix.sum() == int(mask.sum())
    assert p.confusion.get_count(1, 1) == j.confusion.get_count(1, 1)


def test_evaluation_binary():
    rs = np.random.RandomState(1)
    batches = [((rs.rand(20, 3) > 0.5).astype(np.float32),
                rs.rand(20, 3).astype(np.float32)) for _ in range(2)]
    p, j = _feed(lambda m: m.EvaluationBinary(threshold=0.4), batches)
    for i in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            np.testing.assert_allclose(getattr(p, m)(i), getattr(j, m)(i),
                                       **EXACT)


@pytest.mark.parametrize("kind", ["roc", "roc_multi", "calibration"])
def test_roc_and_calibration(kind):
    rs = np.random.RandomState(2)
    if kind == "roc":
        batches = [((rs.rand(30, 1) > 0.5).astype(np.float32),
                    rs.rand(30, 1).astype(np.float32)) for _ in range(3)]
        p, j = _feed(lambda m: m.ROC(), batches)
        np.testing.assert_allclose(p.calculate_auc(), j.calculate_auc(),
                                   **EXACT)
        np.testing.assert_allclose(p.calculate_aucpr(), j.calculate_aucpr(),
                                   **EXACT)
        for a, b in zip(p.roc_curve(20), j.roc_curve(20)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **EXACT)
    elif kind == "roc_multi":
        batches = [(np.eye(3)[rs.randint(0, 3, 25)], _probs(rs, (25, 3)))
                   for _ in range(2)]
        p, j = _feed(lambda m: m.ROCMultiClass(), batches)
        for c in range(3):
            np.testing.assert_allclose(p.calculate_auc(c),
                                       j.calculate_auc(c), **EXACT)
        np.testing.assert_allclose(p.calculate_average_auc(),
                                   j.calculate_average_auc(), **EXACT)
    else:
        batches = [((rs.rand(40) > 0.5).astype(np.float32),
                    rs.rand(40).astype(np.float32)) for _ in range(2)]
        p, j = _feed(lambda m: m.EvaluationCalibration(), batches)
        for a, b in zip(p.reliability_diagram(), j.reliability_diagram()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **EXACT)
        np.testing.assert_allclose(p.expected_calibration_error(),
                                   j.expected_calibration_error(), **EXACT)


def test_regression_evaluation():
    rs = np.random.RandomState(3)
    batches = [(rs.randn(16, 2), rs.randn(16, 2)) for _ in range(3)]
    p, j = _feed(lambda m: m.RegressionEvaluation(), batches)
    for col in (0, 1):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "pearson_correlation", "r_squared"):
            np.testing.assert_allclose(getattr(p, m)(col),
                                       getattr(j, m)(col), **EXACT)
    np.testing.assert_allclose(p.average_mean_squared_error(),
                               j.average_mean_squared_error(), **EXACT)
    assert p.stats() == j.stats()
