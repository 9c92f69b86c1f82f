"""Hyperparameter optimization via the sklearn estimator contract
(tutorial 11's Arbiter role — GridSearchCV over DL4JClassifier). Needs
scikit-learn. Run: python -m
deeplearning4j_tpu_torch.examples.10_hyperparameter_search [--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.examples._common import cli, device_of


def main(device=None):
    dev = device_of(device)
    try:
        from sklearn.model_selection import GridSearchCV
    except ImportError as e:
        raise RuntimeError("example 10 needs scikit-learn (GridSearchCV), "
                           "which this Python does not have") from e

    from deeplearning4j_tpu_torch.ml import DL4JClassifier
    rs = np.random.RandomState(9)
    centers = rs.randn(3, 6) * 3
    X = np.concatenate([centers[i] + rs.randn(60, 6)
                        for i in range(3)]).astype("float32")
    y = np.repeat(np.arange(3), 60)
    gs = GridSearchCV(
        DL4JClassifier(epochs=12, batch_size=45, device=dev),
        {"hidden": [(8,), (24,)], "learning_rate": [1e-2, 1e-3]},
        cv=2, n_jobs=1)
    gs.fit(X, y)
    print("best params:", gs.best_params_,
          "cv accuracy:", round(gs.best_score_, 3))
    return gs


if __name__ == "__main__":
    cli(main)
