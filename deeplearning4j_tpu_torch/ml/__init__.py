"""sklearn-style estimators over the port's networks (the JAX package's
`ml/`, the dl4j-spark-ml analog). Exports resolve lazily
(`util/lazy.py`)."""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = dict.fromkeys(("AutoEncoderTransformer", "DL4JClassifier",
                          "DL4JRegressor"), "estimators")
__all__ = ["DL4JClassifier", "DL4JRegressor", "AutoEncoderTransformer"]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
