"""DataSet normalizers (the DataSetPreProcessor family).

A copy of the JAX package's `data/normalization.py` (numpy on the host),
with its device-side seam rewritten for torch:

- `NormalizerStandardize` (zero mean, unit variance, optionally labels),
- `NormalizerMinMaxScaler` (range scaling),
- `ImagePreProcessingScaler` (pixels [0, max] -> [lo, hi]),
- `VGG16ImagePreProcessor` (subtract the ImageNet channel means),
- `MultiNormalizerStandardize` (per-input statistics for a MultiDataSet),

with save and restore of the fitted statistics in the reference's JSON
format. fit() streams an iterator once with a chunked Welford update;
preprocess/transform map a DataSet as the reference's pre-processors do
and revert/revert_features undo it.

The device seam: a pre-processor whose feature transform is a
per-feature affine map advertises `device_affine() -> (shift, scale)`.
During a fit, `engaged_device_affine` detaches it from the iterator
chain, so raw features (uint8 pixels stay uint8) go to the device, and
the network applies `apply_device_affine` there: normalize in f32 (or
wider), then cast to the compute dtype.
"""
from __future__ import annotations

import contextlib
import json
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet


class DataSetPreProcessor:
    """Base contract: preprocess(ds) returns the transformed DataSet."""

    def preprocess(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def device_affine(self):
        """(shift, scale) float32 arrays such that
        ``features.astype(f32) * scale + shift`` reproduces this
        normalizer's feature transform, or None when the transform is not
        a per-feature affine map (or also touches the labels)."""
        return None

    __call__ = preprocess


def apply_device_affine(x: torch.Tensor, shift: torch.Tensor,
                        scale: torch.Tensor,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """The one device-norm rule of both containers: accumulate in (at
    least) f32, then cast to the compute dtype (normalize, then cast)."""
    acc = torch.promote_types(torch.float32, compute_dtype)
    return (x.to(acc) * scale + shift).to(compute_dtype)


def engage_device_affine(iterator):
    """Walk an iterator's wrapper chain (wrappers hold the backing
    iterator as `_source`) for an attached pre-processor that advertises
    `device_affine()`. If one is found, DETACH it (the host no longer
    applies it) and return ``(owner, pre_processor, (shift, scale))`` so
    the caller can restore ``owner.pre_processor``; ``(None, None, None)``
    when none is attached or it is not affine."""
    seen = set()
    it = iterator
    while it is not None and id(it) not in seen:
        seen.add(id(it))
        pp = getattr(it, "pre_processor", None)
        if pp is not None:
            aff = getattr(pp, "device_affine", lambda: None)()
            if aff is None:
                return None, None, None
            it.pre_processor = None
            # marker for the raw-uint8 warning of data/records.py: the
            # features are still normalized, on the device
            it._device_affine_active = True
            return it, pp, aff
        it = getattr(it, "_source", None)
    return None, None, None


@contextlib.contextmanager
def engaged_device_affine(iterator, listeners=()):
    """The device-norm seam of both containers' fit: yields ``(shift,
    scale)`` when device-side normalization is engaged for the body,
    else None.

    - A `reads_model` listener may evaluate through the same iterator
      mid-fit and would see raw features with the pre-processor
      detached, so such fits keep normalizing on the host.
    - The pre-processor is detached for the body and restored in
      `finally`, errors included."""
    if any(getattr(lst, "reads_model", False) for lst in listeners):
        yield None
        return
    owner, pp, aff = engage_device_affine(iterator)
    if aff is None:
        yield None
        return
    try:
        yield aff
    finally:
        owner.pre_processor = pp
        owner._device_affine_active = False


class _Welford:
    """Streaming mean/variance/min/max over the feature axis (all leading
    axes are reduced: (B, F), (B, T, F) and (B, H, W, C) alike)."""

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None
        self.min = None
        self.max = None

    def update(self, a):
        a = np.asarray(a, np.float64)
        flat = a.reshape(-1, a.shape[-1])
        if self.mean is None:
            self.mean = np.zeros(flat.shape[1])
            self.m2 = np.zeros(flat.shape[1])
            self.min = np.full(flat.shape[1], np.inf)
            self.max = np.full(flat.shape[1], -np.inf)
        # chunked Welford (Chan et al.'s parallel update)
        cn = flat.shape[0]
        cmean = flat.mean(0)
        cm2 = ((flat - cmean) ** 2).sum(0)
        delta = cmean - self.mean
        tot = self.n + cn
        self.mean = self.mean + delta * cn / tot
        self.m2 = self.m2 + cm2 + delta ** 2 * self.n * cn / tot
        self.n = tot
        np.minimum(self.min, flat.min(0), out=self.min)
        np.maximum(self.max, flat.max(0), out=self.max)

    @property
    def std(self):
        return np.sqrt(self.m2 / max(self.n, 1)) + 1e-8


class NormalizerStandardize(DataSetPreProcessor):
    """Zero-mean / unit-variance feature (and optionally label)
    standardization (ND4J NormalizerStandardize)."""

    def __init__(self, fit_labels: bool = False):
        self._fit_labels = fit_labels
        self.feature_mean = self.feature_std = None
        self.label_mean = self.label_std = None

    def fit_label(self, fit_labels: bool = True):
        self._fit_labels = fit_labels
        return self

    def fit(self, data) -> "NormalizerStandardize":
        fw, lw = _Welford(), _Welford()
        for ds in _iter_datasets(data):
            fw.update(ds.features)
            if self._fit_labels and ds.labels is not None:
                lw.update(ds.labels)
        self.feature_mean = fw.mean.astype(np.float32)
        self.feature_std = fw.std.astype(np.float32)
        if self._fit_labels and lw.mean is not None:
            self.label_mean = lw.mean.astype(np.float32)
            self.label_std = lw.std.astype(np.float32)
        _reset(data)
        return self

    def transform(self, features) -> np.ndarray:
        self._check_fit()
        return ((np.asarray(features, np.float32) - self.feature_mean)
                / self.feature_std)

    def revert_features(self, features) -> np.ndarray:
        self._check_fit()
        return np.asarray(features, np.float32) * self.feature_std \
            + self.feature_mean

    def preprocess(self, ds: DataSet) -> DataSet:
        self._check_fit()
        labels = ds.labels
        if self.label_mean is not None and labels is not None:
            labels = ((np.asarray(labels, np.float32) - self.label_mean)
                      / self.label_std)
        return DataSet(self.transform(ds.features), labels,
                       ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        self._check_fit()
        labels = ds.labels
        if self.label_mean is not None and labels is not None:
            labels = np.asarray(labels, np.float32) * self.label_std \
                + self.label_mean
        return DataSet(self.revert_features(ds.features), labels,
                       ds.features_mask, ds.labels_mask)

    def _check_fit(self):
        if self.feature_mean is None:
            raise RuntimeError("NormalizerStandardize is not fitted — "
                               "call fit(iterator) first")

    def device_affine(self):
        # label standardization has no device-side analog (labels go to
        # the loss, not the input): the host keeps it
        if self.feature_mean is None or self.label_mean is not None:
            return None
        scale = (1.0 / self.feature_std).astype(np.float32)
        shift = (-self.feature_mean * scale).astype(np.float32)
        return shift, scale

    def save(self, path: str):
        self._check_fit()
        _save_stats(path, type(self).__name__, {
            "feature_mean": self.feature_mean, "feature_std": self.feature_std,
            "label_mean": self.label_mean, "label_std": self.label_std})

    @classmethod
    def restore(cls, path: str) -> "NormalizerStandardize":
        stats = _load_stats(path, cls.__name__)
        out = cls(fit_labels=stats["label_mean"] is not None)
        out.feature_mean = stats["feature_mean"]
        out.feature_std = stats["feature_std"]
        out.label_mean = stats["label_mean"]
        out.label_std = stats["label_std"]
        return out


class NormalizerMinMaxScaler(DataSetPreProcessor):
    """Scale features into [lo, hi] per feature (ND4J
    NormalizerMinMaxScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = float(lo), float(hi)
        self.feature_min = self.feature_max = None

    def fit(self, data) -> "NormalizerMinMaxScaler":
        w = _Welford()
        for ds in _iter_datasets(data):
            w.update(ds.features)
        self.feature_min = w.min.astype(np.float32)
        self.feature_max = w.max.astype(np.float32)
        _reset(data)
        return self

    def _range(self):
        if self.feature_min is None:
            raise RuntimeError("NormalizerMinMaxScaler is not fitted")
        return np.maximum(self.feature_max - self.feature_min, 1e-8)

    def transform(self, features) -> np.ndarray:
        unit = (np.asarray(features, np.float32) - self.feature_min) \
            / self._range()
        return unit * (self.hi - self.lo) + self.lo

    def revert_features(self, features) -> np.ndarray:
        rng = self._range()
        unit = (np.asarray(features, np.float32) - self.lo) \
            / (self.hi - self.lo)
        return unit * rng + self.feature_min

    def preprocess(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def device_affine(self):
        if self.feature_min is None:
            return None
        scale = ((self.hi - self.lo) / self._range()).astype(np.float32)
        shift = (self.lo - self.feature_min * scale).astype(np.float32)
        return shift, scale

    def save(self, path: str):
        _save_stats(path, type(self).__name__, {
            "feature_min": self.feature_min, "feature_max": self.feature_max,
            "lo": np.float32(self.lo), "hi": np.float32(self.hi)})

    @classmethod
    def restore(cls, path: str) -> "NormalizerMinMaxScaler":
        stats = _load_stats(path, cls.__name__)
        out = cls(float(stats["lo"]), float(stats["hi"]))
        out.feature_min = stats["feature_min"]
        out.feature_max = stats["feature_max"]
        return out


class ImagePreProcessingScaler(DataSetPreProcessor):
    """Pixel scaling [0, max_pixel] -> [lo, hi] (ND4J
    ImagePreProcessingScaler); no fit needed."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_pixel: float = 255.0):
        self.lo, self.hi, self.max_pixel = float(lo), float(hi), \
            float(max_pixel)

    def transform(self, features) -> np.ndarray:
        x = np.asarray(features, np.float32) / self.max_pixel
        return x * (self.hi - self.lo) + self.lo

    def preprocess(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def device_affine(self):
        scale = np.float32((self.hi - self.lo) / self.max_pixel)
        return np.float32(self.lo), scale


class VGG16ImagePreProcessor(DataSetPreProcessor):
    """Subtract the ImageNet channel means (ND4J VGG16ImagePreProcessor);
    NHWC layout, RGB order."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def transform(self, features) -> np.ndarray:
        return np.asarray(features, np.float32) - self.MEANS

    def preprocess(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def device_affine(self):
        return -self.MEANS, np.float32(1.0)


class MultiNormalizerStandardize:
    """Per-input standardization for a MultiDataSet (ND4J
    MultiNormalizerStandardize)."""

    def __init__(self):
        self._stats: Optional[list] = None

    def fit(self, data) -> "MultiNormalizerStandardize":
        ws = None
        for mds in data:
            if ws is None:
                ws = [_Welford() for _ in mds.features]
            for w, f in zip(ws, mds.features):
                w.update(f)
        if ws is None:
            raise ValueError("empty source")
        self._stats = [(w.mean.astype(np.float32), w.std.astype(np.float32))
                       for w in ws]
        _reset(data)
        return self

    def preprocess(self, mds: MultiDataSet) -> MultiDataSet:
        if self._stats is None:
            raise RuntimeError("MultiNormalizerStandardize is not fitted")
        feats = tuple((np.asarray(f, np.float32) - m) / s
                      for f, (m, s) in zip(mds.features, self._stats))
        return MultiDataSet(feats, mds.labels, mds.features_masks,
                            mds.labels_masks)

    __call__ = preprocess


# ----------------------------------------------------------------- plumbing
def _iter_datasets(data):
    if isinstance(data, DataSet):
        yield data
    else:
        yield from data


def _reset(data):
    if hasattr(data, "reset"):
        data.reset()


def _save_stats(path: str, kind: str, arrays: dict):
    meta = {k: (None if v is None else v.tolist())
            for k, v in arrays.items()}
    with open(path, "w") as f:
        json.dump({"kind": kind, "stats": meta}, f)


def _load_stats(path: str, kind: str) -> dict:
    with open(path) as f:
        blob = json.load(f)
    if blob.get("kind") != kind:
        raise ValueError(f"{path} holds a {blob.get('kind')}, not {kind}")
    return {k: (None if v is None else np.asarray(v, np.float32))
            for k, v in blob["stats"].items()}
