"""The port's dataset fetchers and the train CLI's built-in datasets
against the JAX package, on the CPU.

- Every fetcher's synthetic substitute (an empty cache) is bitwise the
  reference's: features, labels and the split.
- Cache files the test writes itself (IDX, gzipped and plain; CIFAR-10
  binary batches; the UCI text file; an SVHN .mat; TinyImageNet and LFW
  image trees) read into the same arrays in both packages. Nothing is
  downloaded.
- The u8 -> [0, 1] scaling equals the reference's native-backed
  `scale_u8` output bit for bit, over all 256 byte values and over an
  array large enough for its threaded path.
- With `synthetic=False` a missing cache raises FileNotFoundError.
- `python -m deeplearning4j_tpu_torch.train --dataset mnist
  --synthetic-data --device cpu` on a LeNet zip gives the reference
  CLI's result line (iterations, epochs, final score within rtol 1e-4);
  without the flag both CLIs fail on the missing cache.
"""
import gzip
import json
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.data import fetchers as jf
from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
from deeplearning4j_tpu.train import cli as jax_cli
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.data import fetchers as pf
from deeplearning4j_tpu_torch.train import cli


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """One cache directory for both packages."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_CUDA_DATA_DIR", str(tmp_path))
    return tmp_path


def _same(port_it, ref_it):
    assert port_it.features.dtype == ref_it.features.dtype
    np.testing.assert_array_equal(port_it.features, ref_it.features)
    np.testing.assert_array_equal(port_it.labels, ref_it.labels)
    assert port_it.batch_size() == ref_it.batch_size()


SYNTHETIC = {
    "mnist": lambda m: m.MnistDataSetIterator(batch_size=16, n_synthetic=64),
    "mnist_test_flat": lambda m: m.MnistDataSetIterator(
        train=False, n_synthetic=32, seed=5, flatten=True),
    "emnist_letters": lambda m: m.EmnistDataSetIterator(
        split="letters", n_synthetic=64),
    "emnist_byclass": lambda m: m.EmnistDataSetIterator(
        split="byclass", n_synthetic=64, seed=3),
    "cifar10": lambda m: m.Cifar10DataSetIterator(n_synthetic=48),
    "uci_train": lambda m: m.UciSequenceDataSetIterator(),
    "uci_test": lambda m: m.UciSequenceDataSetIterator(train=False, seed=4),
    "svhn": lambda m: m.SvhnDataSetIterator(n_synthetic=40),
    "tinyimagenet": lambda m: m.TinyImageNetDataSetIterator(n_synthetic=24),
    "lfw": lambda m: m.LfwDataSetIterator(n_synthetic=20, image_size=24),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_data_is_the_references(cache, name):
    _same(SYNTHETIC[name](pf), SYNTHETIC[name](jf))
    if name == "lfw":
        assert SYNTHETIC[name](pf).label_names == \
            SYNTHETIC[name](jf).label_names


MISSING = {
    "mnist": lambda m: m.MnistDataSetIterator(synthetic=False),
    "emnist": lambda m: m.EmnistDataSetIterator(synthetic=False),
    "cifar10": lambda m: m.Cifar10DataSetIterator(synthetic=False),
    "uci": lambda m: m.UciSequenceDataSetIterator(synthetic=False),
    "svhn": lambda m: m.SvhnDataSetIterator(synthetic=False),
    "tinyimagenet": lambda m: m.TinyImageNetDataSetIterator(
        synthetic=False),
    "lfw": lambda m: m.LfwDataSetIterator(synthetic=False),
}


@pytest.mark.parametrize("name", sorted(MISSING))
def test_a_missing_cache_raises(cache, name):
    with pytest.raises(FileNotFoundError, match="not cached"):
        MISSING[name](pf)
    with pytest.raises(FileNotFoundError):
        MISSING[name](jf)


def test_the_default_cache_is_the_references(monkeypatch):
    monkeypatch.delenv("DL4J_CUDA_DATA_DIR", raising=False)
    monkeypatch.delenv("DL4J_TPU_DATA_DIR", raising=False)
    assert pf.data_dir() == jf.data_dir() == os.path.expanduser(
        "~/.deeplearning4j_tpu/datasets")
    monkeypatch.setenv("DL4J_CUDA_DATA_DIR", "")       # "" is unset
    assert pf.data_dir() == jf.data_dir()


def test_u8_scaling_is_the_native_kernels_bit_for_bit():
    every = np.arange(256, dtype=np.uint8)
    big = np.random.RandomState(0).randint(0, 256, (3, 200, 211),
                                           dtype=np.uint8)   # > 2^16
    for a in (every, big):
        got, ref = pf._u8_to_unit(a), jf._u8_to_unit(a)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    floats = every.astype(np.float64)
    np.testing.assert_array_equal(pf._u8_to_unit(floats),
                                  jf._u8_to_unit(floats))


# ---------------------------------------------------------- cache files
def _write_idx(path, arr, gz=False):
    codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int32): 0x0C,
             np.dtype(np.float32): 0x0D}
    head = bytes([0, 0, codes[arr.dtype], arr.ndim]) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    data = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_equal(cache, gz):
    rs = np.random.RandomState(1)
    (cache / "mnist").mkdir()
    imgs = rs.randint(0, 256, (12, 28, 28), dtype=np.uint8)
    labs = rs.randint(0, 10, 12).astype(np.uint8)
    _write_idx(cache / "mnist" / "train-images-idx3-ubyte", imgs, gz)
    _write_idx(cache / "mnist" / "train-labels-idx1-ubyte", labs, gz)
    port = pf.MnistDataSetIterator(batch_size=4, synthetic=False)
    _same(port, jf.MnistDataSetIterator(batch_size=4, synthetic=False))
    assert port.features.shape == (12, 28, 28, 1)
    np.testing.assert_array_equal(port.labels.argmax(-1), labs)
    # read_idx on other element types
    ints = rs.randint(-5, 5, (3, 4)).astype(np.int32)
    _write_idx(cache / "ints", ints, gz)
    got = pf.read_idx(str(cache / "ints") + (".gz" if gz else ""))
    np.testing.assert_array_equal(got, ints)
    assert got.dtype == np.int32
    # EMNIST letters: labels are 1-indexed on disk
    (cache / "emnist").mkdir()
    _write_idx(cache / "emnist" / "emnist-letters-test-images-idx3-ubyte",
               imgs, gz)
    _write_idx(cache / "emnist" / "emnist-letters-test-labels-idx1-ubyte",
               (labs + 1).astype(np.uint8), gz)
    kw = dict(split="letters", train=False, synthetic=False)
    _same(pf.EmnistDataSetIterator(**kw), jf.EmnistDataSetIterator(**kw))


def test_bad_idx_magic_raises(tmp_path):
    path = tmp_path / "bad"
    path.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="magic"):
        pf.read_idx(str(path))


def test_cifar_binary_batches_read_equal(cache):
    rs = np.random.RandomState(2)
    d = cache / "cifar10"
    d.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rows = np.concatenate(
            [rs.randint(0, 10, (3, 1)), rs.randint(0, 256, (3, 3072))],
            axis=1).astype(np.uint8)
        (d / name).write_bytes(rows.tobytes())
    for train in (True, False):
        port = pf.Cifar10DataSetIterator(train=train, synthetic=False)
        _same(port, jf.Cifar10DataSetIterator(train=train, synthetic=False))
    assert port.features.shape == (3, 32, 32, 3)
    raw = np.frombuffer((d / "test_batch.bin").read_bytes(), np.uint8)
    # planar CHW on disk: the red plane of image 0 is its channel 0
    np.testing.assert_array_equal(
        port.features[0, :, :, 0],
        raw[1:1025].reshape(32, 32).astype(np.float32) * np.float32(1 / 255))


def test_uci_and_svhn_files_read_equal(cache):
    from scipy.io import savemat
    rs = np.random.RandomState(3)
    (cache / "uci").mkdir()
    np.savetxt(cache / "uci" / "synthetic_control.data",
               rs.rand(600, 60) * 50)
    for train in (True, False):
        _same(pf.UciSequenceDataSetIterator(train=train, synthetic=False),
              jf.UciSequenceDataSetIterator(train=train, synthetic=False))
    (cache / "svhn").mkdir()
    savemat(str(cache / "svhn" / "test_32x32.mat"),
            {"X": rs.randint(0, 256, (32, 32, 3, 5), dtype=np.uint8),
             "y": np.asarray([[10], [1], [2], [10], [9]], np.uint8)})
    port = pf.SvhnDataSetIterator(train=False, synthetic=False)
    _same(port, jf.SvhnDataSetIterator(train=False, synthetic=False))
    np.testing.assert_array_equal(port.labels.argmax(-1), [0, 1, 2, 0, 9])


def test_image_trees_read_equal(cache):
    from PIL import Image
    rs = np.random.RandomState(4)

    def png(path, hw):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (hw, hw, 3), dtype=np.uint8)) \
            .save(str(path))

    root = cache / "tiny-imagenet-200"
    for w in ("n01", "n02"):
        for i in range(2):
            png(root / "train" / w / "images" / f"{w}_{i}.JPEG", 64)
    png(root / "val" / "images" / "val_0.JPEG", 64)
    (root / "val" / "val_annotations.txt").write_text(    # the real format
        "val_0.JPEG\tn02\t0\t32\t44\t62\n")
    for train in (True, False):
        _same(pf.TinyImageNetDataSetIterator(train=train, synthetic=False),
              jf.TinyImageNetDataSetIterator(train=train, synthetic=False))
    for person, n in (("Ann_A", 3), ("Bob_B", 1), ("Cid_C", 2)):
        for i in range(n):
            png(cache / "lfw" / person / f"{person}_{i}.jpg", 40)
    kw = dict(min_faces_per_person=2, image_size=16, synthetic=False)
    port, ref = pf.LfwDataSetIterator(**kw), jf.LfwDataSetIterator(**kw)
    _same(port, ref)
    assert port.label_names == ref.label_names == ["Ann_A", "Cid_C"]


# ------------------------------------------------------------- the CLI
def test_cli_mnist_synthetic_gives_the_references_result(cache, capsys):
    model = str(cache / "lenet.zip")
    jax_save(JLeNet().init(), model)
    common = ["--model", model, "--dataset", "mnist", "--mode", "single",
              "--batch-size", "512", "--score-every", "1"]
    for main in (cli.main, jax_cli.main):
        extra = ["--device", "cpu"] if main is cli.main else []
        with pytest.raises(FileNotFoundError, match="MNIST not cached"):
            main(common + ["--output", str(cache / "x.zip")] + extra)
    assert not (cache / "x.zip").exists()
    assert cli.main(common + ["--synthetic-data", "--output",
                              str(cache / "p.zip"), "--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(common + ["--synthetic-data", "--output",
                                  str(cache / "j.zip")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port) == set(ref) == {"output", "final_score", "iterations",
                                     "epochs"}
    assert (port["iterations"], port["epochs"]) == \
        (ref["iterations"], ref["epochs"]) == (4, 1)
    np.testing.assert_allclose(port["final_score"], ref["final_score"],
                               rtol=1e-4)


def test_iris_dataset_is_the_references():
    """`iris_dataset()`: the whole set in the file's order, one DataSet,
    bitwise the reference's, and a copy (mutating it leaves the next call
    untouched)."""
    mine, ref = pf.iris_dataset(), jf.iris_dataset()
    assert mine.features.shape == (150, 4) and mine.labels.shape == (150, 3)
    for a, b in ((mine.features, ref.features), (mine.labels, ref.labels)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    mine.features[0, 0] = -1.0
    assert pf.iris_dataset().features[0, 0] == np.asarray(ref.features)[0, 0]
