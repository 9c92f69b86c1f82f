"""Evaluation accumulators (numpy copies of the JAX package's `eval/`)."""
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, ConfusionMatrix, EvaluationBinary
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass, EvaluationCalibration

__all__ = ["Evaluation", "ConfusionMatrix", "EvaluationBinary",
           "RegressionEvaluation", "ROC", "ROCMultiClass",
           "EvaluationCalibration"]
