"""sklearn-style estimator wrappers — the `dl4j-spark-ml` analog.

Parity target: `deeplearning4j-scaleout/spark/dl4j-spark-ml/src/main/
spark-2/scala/org/deeplearning4j/spark/ml/impl/SparkDl4jNetwork.scala`
(a Spark ML Estimator producing a Model with transform/predict) and
`AutoEncoder.scala` (unsupervised feature transformer). The reference
plugs DL4J training into Spark's ML-pipeline contract; the honest modern
analog on this stack is scikit-learn's estimator contract — fit/predict/
predict_proba/transform/get_params — so a network drops into
sklearn.pipeline.Pipeline, GridSearchCV, cross_val_score, etc.

Estimators subclass sklearn's BaseEstimator when sklearn is importable
(get_params/set_params/clone support); otherwise a minimal stand-in keeps
the same duck-typed surface, so sklearn is an optional integration, not a
dependency.

The port's counterpart of the JAX package's `ml/estimators.py`. Each
estimator takes `device` (default None: CUDA, raising without it;
``"cpu"`` for the CPU), where its network is built, trained, predicts and
is restored after unpickling. Outputs come back as numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.nn.multilayer import host_array
from deeplearning4j_tpu_torch.util.platform import DeviceLike

try:                                    # optional integration
    from sklearn.base import (
        BaseEstimator, ClassifierMixin, RegressorMixin, TransformerMixin,
    )
except ImportError:                     # pragma: no cover
    class BaseEstimator:                # minimal get/set_params stand-in
        def get_params(self, deep=True):
            return {k: v for k, v in self.__dict__.items()
                    if not k.startswith("_") and not k.endswith("_")}

        def set_params(self, **params):
            for k, v in params.items():
                setattr(self, k, v)
            return self

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass

    class TransformerMixin:
        def fit_transform(self, X, y=None, **kw):
            return self.fit(X, y, **kw).transform(X)


def _default_conf(n_features: int, n_out: int, hidden: tuple, lr: float,
                  seed: int, activation: str, loss: str):
    """ReLU MLP scaffold with a configurable head (softmax/mcxent for the
    classifier, identity/mse for the regressor)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(lr))
         .list())
    for h in hidden:
        b.layer(DenseLayer(n_out=int(h), activation="relu"))
    b.layer(OutputLayer(n_out=n_out, activation=activation, loss=loss))
    return b.set_input_type(InputType.feed_forward(n_features)).build()


class _NetworkEstimator(BaseEstimator):
    """Shared fit plumbing: builds (or accepts) a MultiLayerConfiguration,
    trains a MultiLayerNetwork, exposes the fitted net as `network_`."""

    def _fit_network(self, conf, X, Y):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        net = MultiLayerNetwork(conf, device=self.device).init()
        net.fit((np.asarray(X, np.float32), np.asarray(Y, np.float32)),
                epochs=self.epochs, batch_size=self.batch_size,
                scan_steps=self.scan_steps)
        self.network_ = net
        return self

    def _check_fitted(self):
        if not hasattr(self, "network_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet — call fit first")

    # ------------------------------------------------- pickle / joblib
    # the fitted network holds device tensors and updater closures; route
    # persistence through the checkpoint-zip format instead so
    # pickle/joblib.dump of a fitted estimator Just Works
    def __getstate__(self):
        state = self.__dict__.copy()
        net = state.pop("network_", None)
        if net is not None:
            import io

            from deeplearning4j_tpu_torch.util.serialization import save_model
            buf = io.BytesIO()
            save_model(net, buf)
            state["_network_blob_"] = buf.getvalue()
        return state

    def __setstate__(self, state):
        blob = state.pop("_network_blob_", None)
        self.__dict__.update(state)
        if blob is not None:
            import io

            from deeplearning4j_tpu_torch.util.serialization import load_model
            self.network_ = load_model(io.BytesIO(blob),
                                       device=self.device)


class DL4JClassifier(ClassifierMixin, _NetworkEstimator):
    """Classifier estimator (SparkDl4jNetwork.scala's Estimator role).

    `conf` may be a ready MultiLayerConfiguration (its output head defines
    the classes) or None — then a ReLU MLP softmax head is built from
    `hidden`/`learning_rate` at fit time, sized to the data.

    >>> clf = DL4JClassifier(hidden=(32,), epochs=20)
    >>> clf.fit(X, y).predict(X)          # y: int class labels
    >>> Pipeline([("scale", StandardScaler()), ("net", clf)]).fit(X, y)
    """

    def __init__(self, conf=None, hidden=(64,), learning_rate=1e-2,
                 epochs: int = 10, batch_size: int = 32,
                 scan_steps: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.conf = conf
        self.hidden = hidden
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.scan_steps = scan_steps
        self.seed = seed
        self.device = device

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        idx = {c: i for i, c in enumerate(self.classes_)}
        Y = np.eye(len(self.classes_), dtype=np.float32)[
            np.vectorize(idx.get)(y)]
        conf = self.conf or _default_conf(
            X.shape[1], len(self.classes_), tuple(self.hidden),
            self.learning_rate, self.seed, "softmax", "mcxent")
        return self._fit_network(conf, X, Y)

    def predict_proba(self, X):
        self._check_fitted()
        return host_array(self.network_.output(np.asarray(X, np.float32)))

    def predict(self, X):
        proba = self.predict_proba(X)   # raises first when unfitted
        return self.classes_[proba.argmax(axis=1)]


class DL4JRegressor(RegressorMixin, _NetworkEstimator):
    """Regressor estimator: identity/MSE head counterpart."""

    def __init__(self, conf=None, hidden=(64,), learning_rate=1e-2,
                 epochs: int = 10, batch_size: int = 32,
                 scan_steps: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.conf = conf
        self.hidden = hidden
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.scan_steps = scan_steps
        self.seed = seed
        self.device = device

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        Y = np.asarray(y, np.float32)
        if Y.ndim == 1:
            Y = Y[:, None]
        self.n_outputs_ = Y.shape[1]
        conf = self.conf or _default_conf(
            X.shape[1], self.n_outputs_, tuple(self.hidden),
            self.learning_rate, self.seed, "identity", "mse")
        return self._fit_network(conf, X, Y)

    def predict(self, X):
        self._check_fitted()
        out = host_array(self.network_.output(np.asarray(X, np.float32)))
        return out[:, 0] if self.n_outputs_ == 1 else out


class AutoEncoderTransformer(TransformerMixin, _NetworkEstimator):
    """Unsupervised feature transformer (AutoEncoder.scala /
    AutoEncoderWrapper.scala): fit trains a dense autoencoder on X via
    layerwise pretraining; transform returns the bottleneck encoding."""

    def __init__(self, n_components: int = 16, learning_rate: float = 1e-2,
                 epochs: int = 10, batch_size: int = 32,
                 scan_steps: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.n_components = n_components
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.scan_steps = scan_steps
        self.seed = seed
        self.device = device

    def fit(self, X, y=None):
        from deeplearning4j_tpu_torch.nn.conf import (
            InputType, NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.layers import AutoEncoder, OutputLayer
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn.updaters import Adam
        X = np.asarray(X, np.float32)
        conf = (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Adam(self.learning_rate)).list()
                .layer(AutoEncoder(n_out=int(self.n_components),
                                   activation="tanh"))
                .layer(OutputLayer(n_out=X.shape[1], activation="identity",
                                   loss="mse"))
                .set_input_type(InputType.feed_forward(X.shape[1]))
                .build())
        net = MultiLayerNetwork(conf, device=self.device).init()
        net.fit_pretrain((X, X), epochs=self.epochs,
                         batch_size=self.batch_size)
        self.network_ = net
        return self

    def transform(self, X):
        self._check_fitted()
        acts = self.network_.feed_forward(np.asarray(X, np.float32))
        return host_array(acts[0])      # bottleneck (AutoEncoder) output
