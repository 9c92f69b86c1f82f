"""The port's examples (`deeplearning4j_tpu_torch/examples/`), each run
on the CPU at `tests/test_examples.py`'s reduced settings and held to the
same result the JAX example is held to there (01's accuracy > 0.9, ...).
Where an example saves a model (01, 15), the JAX package reads the
port's zip and its predictions agree with the port's within 1e-5 on the
same inputs. The parallel examples 08, 16 and 18 run as two gloo ranks
(`tests/_torch_dist.py`): every rank reaches the threshold with the same
result. Example 09 needs keras and h5py (installed here, not on the card
machine): without h5py it raises saying so.
"""
import builtins
import importlib
import os

import numpy as np
import pytest
import torch

from _torch_dist import RankPool


def _example(name):
    return importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The examples' steps are tiny: at the default thread count each op
    enters an OpenMP region, slow when the test workers share the host's
    cores. One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


# (example, main's reduced settings, the check of its result)
CASES = [
    ("01_quickstart_mlp", dict(epochs=15), lambda r: r > 0.9),
    ("02_computation_graph", dict(epochs=15), lambda r: r > 0.85),
    ("03_cnn_digits", dict(epochs=2), lambda r: r > 0.7),
    ("04_char_lstm", dict(epochs=30, units=32), lambda r: len(r) == 41),
    ("05_autoencoder_anomaly", dict(epochs=40), lambda r: r > 0.8),
    ("06_early_stopping", dict(max_epochs=40),
     lambda r: r.best_model is not None),
    ("07_word2vec", dict(epochs=4),
     lambda r: "queen" in r.words_nearest("king", top_n=3)),
    ("09_keras_import", dict(), lambda r: r.score() is not None),
    ("10_hyperparameter_search", dict(), lambda r: r.best_score_ > 0.8),
    ("11_transfer_learning", dict(), lambda r: r > 0.8),
    ("12_tsne_visualization", dict(n=300, max_iter=250),
     lambda r: r > 0.75),
    ("13_custom_layer", dict(epochs=30), lambda r: r > 0.9),
    ("14_long_context_ring", dict(epochs=4), lambda r: np.isfinite(r)),
    ("15_dl4j_artifact_migration", dict(), lambda r: r > 0.9),
    ("17_device_norm_image_pipeline", dict(epochs=10), lambda r: r > 0.9),
]


@pytest.mark.parametrize("name,kwargs,check", CASES,
                         ids=[c[0] for c in CASES])
def test_example_reaches_the_reference_result(name, kwargs, check,
                                              tmp_path):
    if name == "09_keras_import":
        pytest.importorskip("keras")
    if "tmpdir" in _example(name).main.__code__.co_varnames:
        kwargs = dict(kwargs, tmpdir=str(tmp_path))
    result = _example(name).main(device="cpu", **kwargs)
    assert check(result), result


@pytest.mark.parametrize("name", ["08_parallel_training",
                                  "16_zero_fsdp_training",
                                  "18_gspmd_sharding_plan"])
def test_parallel_example_on_two_ranks(pool, name):
    accs = pool.run("run_example", 2, name=name, kwargs=dict(epochs=8))
    assert accs[0] == accs[1] and accs[0] > 0.9, accs


def test_quickstart_zip_reads_in_the_reference(tmp_path):
    """01 saves its network; the JAX package loads the zip and predicts
    what the port's reload predicts."""
    from deeplearning4j_tpu.util.serialization import load_model as jload
    from deeplearning4j_tpu_torch.util.serialization import load_model
    ex = _example("01_quickstart_mlp")
    assert ex.main(epochs=15, tmpdir=str(tmp_path), device="cpu") > 0.9
    path = str(tmp_path / "quickstart_mlp.zip")
    X, _ = ex.make_data()
    ours = load_model(path, device="cpu").output(X).numpy()
    theirs = np.asarray(jload(path).output(X))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_migrated_dl4j_zip_reads_in_the_reference(tmp_path):
    """15 writes a DL4J-format zip with its normalizer; the JAX package's
    importer restores both and predicts what the port's does."""
    from deeplearning4j_tpu.modelimport import (
        restore_multilayer_network as jrestore,
        restore_normalizer as jnorm,
    )
    from deeplearning4j_tpu_torch.modelimport import (
        restore_multilayer_network, restore_normalizer,
    )
    ex = _example("15_dl4j_artifact_migration")
    assert ex.main(tmpdir=str(tmp_path), device="cpu") > 0.9
    path = str(tmp_path / "migrated_model.zip")
    X, _ = ex.make_data()
    ours = restore_multilayer_network(path, device="cpu").output(
        restore_normalizer(path).transform(X)).numpy()
    theirs = np.asarray(jrestore(path).output(jnorm(path).transform(X)))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_keras_example_says_it_needs_h5py(monkeypatch, tmp_path):
    """Where h5py is missing (the card machine) example 09 raises a
    RuntimeError naming it, before any work."""
    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(RuntimeError, match="h5py"):
        _example("09_keras_import").main(tmpdir=str(tmp_path),
                                         device="cpu")


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))),
        "deeplearning4j_tpu_torch", "examples"))
    if f[:2].isdigit()))
def test_example_raises_without_cuda(name, monkeypatch):
    """Every example runs on CUDA by default: without CUDA it raises
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main()
