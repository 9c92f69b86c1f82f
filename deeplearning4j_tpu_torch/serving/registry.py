"""ModelRegistry — named servables over the port's networks.

Counterpart of the JAX package's `serving/registry.py`. A servable loads
from a ``zoo:<Arch>`` name (untrained, weights from the config's seed;
constructor kwargs ride a query string), a `save_model` zip (written by
either package), or a live network. Each `ServedModel` owns a
`ShapeBucketedBatcher` whose runner is the network's `output()` on its
device, warmed at load time.

`deploy_lm` publishes a decode servable (`serving/decode.py`'s
`ServedLM`) beside them. Checkpoint-manifest directories, Keras sources,
hot swap and rollback, and the mesh-backed ParallelInference runner come
with later slices.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.batcher import (
    DEFAULT_BUCKETS, ShapeBucketedBatcher,
)
from deeplearning4j_tpu_torch.util.platform import DeviceLike

log = logging.getLogger("deeplearning4j_tpu_torch")


class ModelLoadError(RuntimeError):
    """A servable source could not be resolved/loaded."""


def _coerce_kwarg(v: str):
    """Query-string value -> python: int, float, true/false, else str."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_zoo_source(spec: str):
    """``TransformerLM?n_layers=2&vocab_size=512`` -> (arch name,
    constructor kwargs). Comma-joined values become tuples."""
    from urllib.parse import parse_qs
    arch, _, query = spec.partition("?")
    kwargs = {}
    if query:
        for k, vs in parse_qs(query, keep_blank_values=False).items():
            v = vs[-1]
            kwargs[k] = tuple(_coerce_kwarg(p) for p in v.split(",")) \
                if "," in v else _coerce_kwarg(v)
    return arch, kwargs


def load_servable(source, device: DeviceLike = None):
    """Resolve a servable source to an initialized network on `device`
    (default CUDA; raises without it).

    Accepted sources: a live MultiLayerNetwork; ``zoo:<ClassName>`` with
    optional ``?key=value&...`` constructor kwargs; a ``.zip`` checkpoint.
    """
    if hasattr(source, "conf") and hasattr(source, "params"):
        if source.params is None:
            source.init()
        return source
    if not isinstance(source, (str, os.PathLike)):
        raise ModelLoadError(f"cannot interpret servable source: "
                             f"{type(source).__name__}")
    src = str(source)
    if src.startswith("zoo:"):
        from deeplearning4j_tpu_torch.models import zoo
        arch, kwargs = parse_zoo_source(src[4:])
        try:
            arch_model = zoo.model_by_name(arch, **kwargs)
        except KeyError as e:
            raise ModelLoadError(str(e)) from None
        except TypeError as e:
            raise ModelLoadError(
                f"{src}: bad constructor kwargs for {arch}: {e}") from None
        return arch_model.init(device=device)
    if not os.path.exists(src):
        raise ModelLoadError(f"servable source not found: {src}")
    if os.path.isdir(src):
        raise ModelLoadError(
            f"{src}: checkpoint-manifest directories are not served by the "
            "port yet; pass a model zip")
    from deeplearning4j_tpu_torch.util.serialization import load_model
    return load_model(src, device=device)


def _network_runner(model):
    """The batcher's runner: numpy batch -> the network's output on its
    device -> numpy. The copy back synchronizes with the device."""
    def run(x: np.ndarray) -> np.ndarray:
        return model.output(x).float().cpu().numpy()
    return run


class ServedModel:
    """One named servable: its network and its warmed batcher."""

    def __init__(self, name: str, model, source: str,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_ms: float = 5.0,
                 queue_limit: int = 256):
        self.name = name
        self.status = "loading"
        self.model = model
        self.source = source
        self.version = 1
        self.loaded_at = time.time()
        it = model.conf.input_type
        if it is None:
            raise ModelLoadError(f"{name}: the network has no input_type; "
                                 "cannot derive the serving input shape")
        self.input_shape: Tuple[int, ...] = tuple(it.shape)
        self.batcher = ShapeBucketedBatcher(
            _network_runner(model), self.input_shape, buckets=buckets,
            max_delay_ms=max_delay_ms, queue_limit=queue_limit, name=name)
        self.warmup_seconds = self.batcher.warm()
        self.status = "ready"
        #: request-path snapshot of the active version's metadata
        self.active_info = self._version_info()

    def _version_info(self) -> dict:
        return {"version": self.version, "source": self.source,
                "loaded_at": self.loaded_at,
                "model_class": type(self.model).__name__,
                "device": str(self.model.device)}

    def predict(self, x, deadline: Optional[float] = None):
        return self.batcher.predict(x, deadline=deadline)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "status": self.status,
            "input_shape": list(self.input_shape),
            "buckets": list(self.batcher.buckets),
            "active_version": self.version,
            "versions": [self._version_info()],
        }

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        self.status = "stopping"
        if drain:
            self.batcher.drain(timeout=timeout)
        else:
            self.batcher.shutdown()


class ModelRegistry:
    """Thread-safe name -> ServedModel registry. Networks load onto
    `device` (default CUDA; raises without it)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self._lock = threading.Lock()
        self._deploy_lock = threading.Lock()
        self._models: Dict[str, ServedModel] = {}

    def deploy(self, name: str, source,
               buckets: Sequence[int] = DEFAULT_BUCKETS,
               max_delay_ms: float = 5.0,
               queue_limit: int = 256) -> ServedModel:
        """Load, warm, and publish a servable under `name`."""
        with self._deploy_lock:
            with self._lock:
                if name in self._models:
                    raise ModelLoadError(
                        f"{name!r} is already deployed; version swaps come "
                        "with a later slice of the port — undeploy first")
            model = load_servable(source, device=self.device)
            served = ServedModel(name, model, str(source), buckets=buckets,
                                 max_delay_ms=max_delay_ms,
                                 queue_limit=queue_limit)
            with self._lock:
                self._models[name] = served
        log.info("serving: deployed %r (%s) on %s, buckets %s, input %s",
                 name, source, model.device, served.batcher.buckets,
                 served.input_shape)
        return served

    def deploy_lm(self, name: str, source, decode=None):
        """Load, warm, and publish a DECODE servable (serving/decode.py:
        continuous-batching generation over a paged KV cache) under
        `name`, on the registry's device. `decode` is a DecodeConfig; a
        ``@int8`` / ``@bf16`` suffix on a string source selects a
        post-training-quantized variant (serving/quantize.py)."""
        from deeplearning4j_tpu_torch.serving.decode import (
            DecodeConfig, ServedLM, apply_variant,
        )
        from deeplearning4j_tpu_torch.serving.quantize import parse_variant
        with self._deploy_lock:
            with self._lock:
                existing = self._models.get(name)
            if existing is not None:
                if not hasattr(existing, "generate"):
                    raise ModelLoadError(
                        f"{name!r} is live as a PREDICT servable; a "
                        "decode servable cannot take its name — undeploy "
                        "first or pick a new name")
                raise ModelLoadError(
                    f"{name!r} is already deployed; version swaps of LM "
                    "servables are not yet ported — undeploy first")
            base, variant = source, None
            if isinstance(source, str):
                base, variant = parse_variant(source)
            if variant is not None:
                decode = apply_variant(
                    decode if decode is not None else DecodeConfig(),
                    variant)
            model = load_servable(base, device=self.device)
            served = ServedLM(name, model, str(source), decode=decode)
            with self._lock:
                self._models[name] = served
        log.info("serving: deployed LM %r (%s) on %s, decode %s", name,
                 source, model.device, served.describe().get("decode"))
        return served

    def get(self, name: str) -> Optional[ServedModel]:
        with self._lock:
            return self._models.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def describe(self) -> dict:
        with self._lock:
            models = list(self._models.values())
        return {"models": [m.describe() for m in models]}

    def all_ready(self) -> bool:
        with self._lock:
            models = list(self._models.values())
        return bool(models) and all(m.status == "ready" for m in models)

    def undeploy(self, name: str, drain: bool = True):
        with self._lock:
            served = self._models.pop(name, None)
        if served is not None:
            served.shutdown(drain=drain)

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        with self._lock:
            models = list(self._models.values())
            self._models.clear()
        for m in models:
            m.shutdown(drain=drain, timeout=timeout)
