"""Built-in dataset fetchers: MNIST, EMNIST, CIFAR-10, IRIS, UCI, SVHN,
TinyImageNet and LFW.

Counterpart of the JAX package's `data/fetchers.py` (DL4J's
`MnistDataFetcher`, `EmnistDataFetcher`, `Cifar10Fetcher`,
`IrisDataFetcher`, `SvhnDataFetcher`, `TinyImageNetFetcher`,
`LFWDataFetcher` and their `*DataSetIterator` wrappers), in numpy:
parsers for the standard on-disk formats (IDX, CIFAR-10 binary batches,
the UCI text file) against a local cache directory, ``data_dir()``:
``$DL4J_CUDA_DATA_DIR``, by default the reference's
``~/.deeplearning4j_tpu/datasets``, so both packages read one cache.

Nothing is downloaded. A missing cache raises FileNotFoundError with
`synthetic=False`; otherwise (the default, None, or True) the fetcher
substitutes the reference's seeded synthetic data, array for array the
same, with the right shapes. IRIS ships inline (`data/_iris.py`), as DL4J
bundles iris.dat. Bytes become [0, 1] floats through the port's native
`scale_u8` (its numpy twin, ``u8 * f32(1/255)``, without the library),
bit for bit the reference's.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.util.env import env_str


def _u8_to_unit(a: np.ndarray) -> np.ndarray:
    """u8 image bytes -> f32 in [0,1] via the native ETL kernel when
    built (ndarray_ops.cpp scale_u8_f32), else its numpy twin."""
    if a.dtype == np.uint8:
        from deeplearning4j_tpu_torch.native.ndarray import scale_u8
        return scale_u8(a, 1.0 / 255.0)
    return a.astype("float32") / 255.0


def data_dir() -> str:
    return env_str("DL4J_CUDA_DATA_DIR",
                   os.path.expanduser("~/.deeplearning4j_tpu/datasets"))


def _find(directory: str, stem: str) -> Optional[str]:
    for cand in (os.path.join(directory, stem),
                 os.path.join(directory, stem + ".gz")):
        if os.path.exists(cand):
            return cand
    return None


# ------------------------------------------------------------------ IDX/MNIST
def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file, gzipped or not (DL4J MnistManager's loader)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if data[0] != 0 or data[1] != 0:
        raise ValueError(f"{path}: bad IDX magic")
    dtype_code, ndim = data[2], data[3]
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
              0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
    dt = dtypes[dtype_code]
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=np.dtype(dt).newbyteorder(">"),
                        offset=4 + 4 * ndim)
    return arr.reshape(dims).astype(dt)


def _synthetic_images(n, h, w, c, n_classes, seed):
    """Seeded class-dependent images: each class its own frequency
    pattern, so a model can learn from them (the reference's data)."""
    rs = np.random.RandomState(seed)
    ys = rs.randint(0, n_classes, n)
    xx, yy = np.meshgrid(np.linspace(0, np.pi * 2, w),
                         np.linspace(0, np.pi * 2, h))
    base = np.stack([np.sin(xx * (k % 4 + 1)) * np.cos(yy * (k // 4 + 1))
                     for k in range(n_classes)])      # (K, h, w)
    X = base[ys][..., None] * 0.5 + 0.5
    if c > 1:
        X = np.repeat(X, c, axis=-1)
    X = X + rs.rand(n, h, w, c) * 0.3
    Y = np.eye(n_classes, dtype="float32")[ys]
    return X.astype("float32"), Y


def _missing(synthetic: Optional[bool], message: str):
    if synthetic is False:
        raise FileNotFoundError(message)


class MnistDataSetIterator(ArrayDataSetIterator):
    """DL4J MnistDataSetIterator: NHWC (B, 28, 28, 1) images in [0, 1] and
    10-class one-hot labels, from train-images-idx3-ubyte[.gz] and its
    labels (t10k-* for the test set) under <data_dir>/mnist/."""

    URL = "http://yann.lecun.com/exdb/mnist/"
    FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, batch_size: int = 32, train: bool = True,
                 synthetic: Optional[bool] = None, n_synthetic: int = 2048,
                 seed: int = 123, flatten: bool = False):
        X, Y = self._load(train, synthetic, n_synthetic, seed)
        if flatten:
            X = X.reshape(len(X), -1)
        super().__init__(X, Y, batch_size=batch_size)

    @classmethod
    def _load(cls, train, synthetic, n_synthetic, seed):
        d = os.path.join(data_dir(), "mnist")
        img_name, lab_name = cls.FILES[train]
        img = _find(d, img_name)
        if img is None:
            _missing(synthetic, f"MNIST not cached under {d}; put the "
                     f"{cls.URL} files there (nothing is downloaded), or "
                     "pass synthetic=True")
            return _synthetic_images(n_synthetic, 28, 28, 1, 10, seed)
        images = _u8_to_unit(read_idx(img))[..., None]
        labels = np.eye(10, dtype="float32")[read_idx(_find(d, lab_name))]
        return images, labels


class EmnistDataSetIterator(ArrayDataSetIterator):
    """DL4J EmnistDataSetIterator (the balanced, byclass, bymerge, digits,
    letters and mnist splits), from emnist-<split>-{train,test}-
    {images-idx3,labels-idx1}-ubyte[.gz] under <data_dir>/emnist/."""

    N_CLASSES = {"balanced": 47, "byclass": 62, "bymerge": 47,
                 "digits": 10, "letters": 26, "mnist": 10}

    def __init__(self, split: str = "balanced", batch_size: int = 32,
                 train: bool = True, synthetic: Optional[bool] = None,
                 n_synthetic: int = 2048, seed: int = 123):
        if split not in self.N_CLASSES:
            raise ValueError(f"unknown EMNIST split '{split}'")
        k = self.N_CLASSES[split]
        d = os.path.join(data_dir(), "emnist")
        t = "train" if train else "test"
        img = _find(d, f"emnist-{split}-{t}-images-idx3-ubyte")
        if img is None:
            _missing(synthetic, f"EMNIST not cached under {d}")
            X, Y = _synthetic_images(n_synthetic, 28, 28, 1, k, seed)
        else:
            X = _u8_to_unit(read_idx(img))[..., None]
            lab = _find(d, f"emnist-{split}-{t}-labels-idx1-ubyte")
            raw = read_idx(lab).astype(int)
            raw = raw - raw.min()          # the letters split is 1-indexed
            Y = np.eye(k, dtype="float32")[raw]
        super().__init__(X, Y, batch_size=batch_size)


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """DL4J Cifar10Fetcher: the CIFAR-10 binary batches (data_batch_N.bin,
    test_batch.bin) under <data_dir>/cifar10/ -> NHWC (B, 32, 32, 3) in
    [0, 1]."""

    def __init__(self, batch_size: int = 32, train: bool = True,
                 synthetic: Optional[bool] = None, n_synthetic: int = 2048,
                 seed: int = 123):
        d = os.path.join(data_dir(), "cifar10")
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        paths = [_find(d, n) for n in names]
        if any(p is None for p in paths):
            _missing(synthetic, f"CIFAR-10 not cached under {d}")
            X, Y = _synthetic_images(n_synthetic, 32, 32, 3, 10, seed)
        else:
            xs, ys = [], []
            for p in paths:
                with open(p, "rb") as f:
                    raw = np.frombuffer(f.read(), np.uint8).reshape(-1, 3073)
                ys.append(raw[:, 0])
                # stored as planar CHW -> NHWC
                xs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                          .transpose(0, 2, 3, 1))
            X = _u8_to_unit(np.ascontiguousarray(np.concatenate(xs)))
            Y = np.eye(10, dtype="float32")[np.concatenate(ys)]
        super().__init__(X, Y, batch_size=batch_size)


# ---------------------------------------------------------------------- IRIS
def _iris_arrays():
    """(X (150, 4) float32, one-hot Y (150, 3) float32)."""
    from deeplearning4j_tpu_torch.data._iris import IRIS_ROWS
    arr = np.asarray(IRIS_ROWS, "float32")
    return arr[:, :4], np.eye(3, dtype="float32")[arr[:, 4].astype(int)]


class IrisDataSetIterator(ArrayDataSetIterator):
    """DL4J IrisDataSetIterator (fetchers/IrisDataFetcher.java): the rows
    in the reference's seeded shuffle order."""

    def __init__(self, batch_size: int = 150,
                 shuffle_seed: Optional[int] = 42):
        X, Y = _iris_arrays()
        if shuffle_seed is not None:
            idx = np.random.RandomState(shuffle_seed).permutation(len(X))
            X, Y = X[idx], Y[idx]
        super().__init__(X, Y, batch_size=batch_size)


def iris_dataset() -> DataSet:
    """The whole iris set as one DataSet, in the file's order (150 rows,
    one-hot labels)."""
    X, Y = _iris_arrays()
    return DataSet(X.copy(), Y.copy())


# ----------------------------------------------------------------------- UCI
class UciSequenceDataSetIterator(ArrayDataSetIterator):
    """DL4J UciSequenceDataSetIterator: the UCI synthetic-control series
    (600 series x 60 steps, 6 classes) from <data_dir>/uci/
    synthetic_control.data, (N, 60, 1) features; 450 train, 150 test."""

    def __init__(self, batch_size: int = 32, train: bool = True,
                 synthetic: Optional[bool] = None, seed: int = 123):
        path = _find(os.path.join(data_dir(), "uci"),
                     "synthetic_control.data")
        if path is None:
            _missing(synthetic, "UCI synthetic_control.data not cached")
            rs = np.random.RandomState(seed)
            ys = rs.randint(0, 6, 600)
            t = np.arange(60)[None, :]
            X = (30 + rs.randn(600, 60) * 2 +
                 ys[:, None] * np.sin(t / (2 + ys[:, None])) * 5)
        else:
            X = np.loadtxt(path)
            ys = np.repeat(np.arange(6), 100)
        X = X.astype("float32")[..., None]          # (600, 60, 1)
        Y = np.eye(6, dtype="float32")[ys]
        # the file is class-ordered (6 blocks of 100): a fixed shuffle
        # before the 450/150 split (UciSequenceDataFetcher.java:143)
        perm = np.random.RandomState(12345).permutation(len(X))
        X, Y = X[perm], Y[perm]
        sl = slice(0, 450) if train else slice(450, 600)
        super().__init__(X[sl], Y[sl], batch_size=batch_size)


# ---------------------------------------------------------------------- SVHN
class SvhnDataSetIterator(ArrayDataSetIterator):
    """DL4J SvhnDataFetcher: the cropped Street View House Numbers
    (train_32x32.mat / test_32x32.mat under <data_dir>/svhn/, read with
    scipy) -> NHWC (B, 32, 32, 3) in [0, 1]; label 10 is class 0."""

    def __init__(self, batch_size: int = 32, train: bool = True,
                 synthetic: Optional[bool] = None, n_synthetic: int = 2048,
                 seed: int = 321):
        d = os.path.join(data_dir(), "svhn")
        name = "train_32x32.mat" if train else "test_32x32.mat"
        path = _find(d, name)
        if path is None:
            _missing(synthetic, f"SVHN not cached under {d} (expected "
                     f"{name}; http://ufldl.stanford.edu/housenumbers/)")
            X, Y = _synthetic_images(n_synthetic, 32, 32, 3, 10, seed)
        else:
            from scipy.io import loadmat
            mat = loadmat(path)
            X = mat["X"].transpose(3, 0, 1, 2).astype("float32") / 255.0
            ys = mat["y"].reshape(-1).astype(np.int64) % 10   # 10 -> 0
            Y = np.eye(10, dtype="float32")[ys]
        super().__init__(X, Y, batch_size=batch_size)


def _rgb(path, size=None) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size, size))
    return np.asarray(img, np.float32) / 255.0


# -------------------------------------------------------------- TinyImageNet
class TinyImageNetDataSetIterator(ArrayDataSetIterator):
    """DL4J TinyImageNetFetcher: 200 classes of 64x64 images from the
    tiny-imagenet-200 layout under <data_dir> (train/<wnid>/images/*.JPEG,
    val/ with val_annotations.txt; decoded with PIL) -> NHWC in [0, 1]."""

    NUM_CLASSES = 200
    SIZE = 64

    def __init__(self, batch_size: int = 32, train: bool = True,
                 synthetic: Optional[bool] = None, n_synthetic: int = 2048,
                 max_per_class: Optional[int] = None, seed: int = 7):
        root = os.path.join(data_dir(), "tiny-imagenet-200")
        split_dir = os.path.join(root, "train" if train else "val")
        if not os.path.isdir(split_dir):
            _missing(synthetic, f"TinyImageNet not cached under {root} "
                     "(https://cs231n.stanford.edu/tiny-imagenet-200.zip)")
            X, Y = _synthetic_images(n_synthetic, self.SIZE, self.SIZE, 3,
                                     self.NUM_CLASSES, seed)
        else:
            wnids = sorted(os.listdir(os.path.join(root, "train")))
            idx = {w: i for i, w in enumerate(wnids)}
            xs, ys = [], []
            if train:
                for w in wnids:
                    img_dir = os.path.join(split_dir, w, "images")
                    for fn in sorted(os.listdir(img_dir))[:max_per_class]:
                        xs.append(_rgb(os.path.join(img_dir, fn)))
                        ys.append(idx[w])
            else:
                ann = os.path.join(split_dir, "val_annotations.txt")
                with open(ann) as f:
                    rows = [line.split("\t")[:2] for line in f
                            if line.strip()]
                for fn, w in rows:
                    xs.append(_rgb(os.path.join(split_dir, "images", fn)))
                    ys.append(idx[w])
            X = np.stack(xs)
            Y = np.eye(self.NUM_CLASSES, dtype="float32")[np.asarray(ys)]
        super().__init__(X, Y, batch_size=batch_size)


# ----------------------------------------------------------------------- LFW
class LfwDataSetIterator(ArrayDataSetIterator):
    """DL4J LFWDataFetcher: Labeled Faces in the Wild, one directory per
    person under <data_dir>/lfw/ (decoded with PIL), people with at least
    `min_faces_per_person` images, resized to `image_size`."""

    def __init__(self, batch_size: int = 32, image_size: int = 64,
                 min_faces_per_person: int = 20,
                 synthetic: Optional[bool] = None, n_synthetic: int = 512,
                 n_synthetic_people: int = 8, seed: int = 11):
        root = os.path.join(data_dir(), "lfw")
        if not os.path.isdir(root):
            _missing(synthetic, f"LFW not cached under {root} "
                     "(http://vis-www.cs.umass.edu/lfw/lfw.tgz)")
            X, Y = _synthetic_images(n_synthetic, image_size, image_size, 3,
                                     n_synthetic_people, seed)
            self.label_names = [f"person_{i}"
                                for i in range(n_synthetic_people)]
        else:
            people = sorted(
                p for p in os.listdir(root)
                if os.path.isdir(os.path.join(root, p))
                and len(os.listdir(os.path.join(root, p)))
                >= min_faces_per_person)
            if not people:
                raise FileNotFoundError(
                    f"no people with >= {min_faces_per_person} faces "
                    f"under {root}")
            xs, ys = [], []
            for i, person in enumerate(people):
                pdir = os.path.join(root, person)
                for fn in sorted(os.listdir(pdir)):
                    xs.append(_rgb(os.path.join(pdir, fn), image_size))
                    ys.append(i)
            X = np.stack(xs)
            Y = np.eye(len(people), dtype="float32")[np.asarray(ys)]
            self.label_names = people
        super().__init__(X, Y, batch_size=batch_size)
