"""The port's sklearn-style estimators (`ml/estimators.py`) against the JAX
package's.

- Every case of `tests/test_ml_estimators.py` runs against the port
  (`_torch_reference_cases.port_cases`), each estimator on the CPU.
- From the same initial weights (the reference's init copied into the
  port's network) on the same data, the fitted classifier's and
  regressor's predictions agree within 1e-5; the autoencoder's transform
  of the same weights agrees within 1e-5.
- A pickled estimator restores bitwise on its device; without CUDA the
  default device raises.
"""
import io
import pickle

import numpy as np
import pytest
import torch

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu import ml as rml
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RMLN
from deeplearning4j_tpu.util.serialization import (
    load_model as r_load, save_model as r_save,
)
from deeplearning4j_tpu_torch import ml as pml
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import (
    load_model as p_load, save_model as p_save,
)

_SUBS = tuple((f"{name}(", f"{name}(device='cpu', ") for name in (
    "DL4JClassifier", "DL4JRegressor", "AutoEncoderTransformer"))
_REF = port_cases("tests/test_ml_estimators.py", extra_subs=_SUBS)
REFERENCE_CASES = sorted(n for n in vars(_REF) if n.startswith("test_"))


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case(name, request):
    run_case(_REF, name, request)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture
def same_init(monkeypatch):
    """The port's networks start from the weights the reference's last
    init drew (through the checkpoint zip)."""
    seen = {}
    r_init, p_init = RMLN.init, MultiLayerNetwork.init

    def ref_init(self, *a, **kw):
        out = r_init(self, *a, **kw)
        buf = io.BytesIO()
        r_save(self, buf)
        seen["zip"] = buf.getvalue()
        return out

    def port_init(self, *a, **kw):
        out = p_init(self, *a, **kw)
        if seen.get("loading"):
            return out
        seen["loading"] = True
        try:
            src = p_load(io.BytesIO(seen["zip"]), device=self.device)
        finally:
            seen["loading"] = False
        with torch.no_grad():
            for tree, from_tree in ((self.params, src.params),
                                    (self.state, src.state)):
                for key in tree:
                    for name, t in tree[key].items():
                        t.copy_(from_tree[key][name])
        return out
    monkeypatch.setattr(RMLN, "init", ref_init)
    monkeypatch.setattr(MultiLayerNetwork, "init", port_init)


def _cls_data(n=96, seed=0):
    return _REF._cls_data(n=n, seed=seed)


def test_classifier_predictions_match_the_reference(same_init):
    X, y = _cls_data()
    kw = dict(hidden=(16, 8), epochs=3, batch_size=32, seed=3)
    ref = rml.DL4JClassifier(**kw).fit(X, y)
    port = pml.DL4JClassifier(device="cpu", **kw).fit(X, y)
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_allclose(port.predict_proba(X),
                               np.asarray(ref.predict_proba(X)),
                               rtol=1e-5, atol=1e-5)
    assert (port.predict(X) == ref.predict(X)).all()


def test_regressor_predictions_match_the_reference(same_init):
    rs = np.random.RandomState(1)
    X = rs.randn(64, 5).astype("float32")
    y = X @ rs.randn(5)
    kw = dict(hidden=(12,), epochs=3, batch_size=16, seed=2)
    ref = rml.DL4JRegressor(**kw).fit(X, y)
    port = pml.DL4JRegressor(device="cpu", **kw).fit(X, y)
    np.testing.assert_allclose(port.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-5, atol=1e-5)


def test_autoencoder_transform_matches_the_reference():
    X, _ = _cls_data(n=60)
    port = pml.AutoEncoderTransformer(n_components=3, epochs=2,
                                      batch_size=20, device="cpu").fit(X)
    buf = io.BytesIO()
    p_save(port.network_, buf)
    buf.seek(0)
    ref = rml.AutoEncoderTransformer(n_components=3)
    ref.network_ = r_load(buf)
    Z = port.transform(X)
    assert isinstance(Z, np.ndarray) and Z.shape == (60, 3)
    np.testing.assert_allclose(Z, np.asarray(ref.transform(X)),
                               rtol=1e-5, atol=1e-5)


def test_pickle_round_trip_is_bitwise_on_the_device():
    X, y = _cls_data(n=60)
    clf = pml.DL4JClassifier(hidden=(8,), epochs=2, batch_size=30,
                             device="cpu").fit(X, y)
    back = pickle.loads(pickle.dumps(clf))
    assert back.network_.device == clf.network_.device
    for key in clf.network_.params:
        for name, t in clf.network_.params[key].items():
            assert torch.equal(back.network_.params[key][name], t)
    np.testing.assert_array_equal(back.predict_proba(X),
                                  clf.predict_proba(X))
    assert back.get_params()["device"] == "cpu"


def test_estimators_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _cls_data(n=30)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pml.DL4JClassifier(epochs=1).fit(X, y)
