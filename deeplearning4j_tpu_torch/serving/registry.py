"""ModelRegistry — named, versioned servables with zero-downtime swaps.

Counterpart of the JAX package's `serving/registry.py`:

- **Sources.** A servable loads from a ``zoo:<Arch>`` name (untrained,
  weights from the config's seed; constructor kwargs ride a query
  string), a `save_model` zip (written by either package), a checkpoint
  DIRECTORY (`train/resilience.CheckpointManager`'s manifest, written by
  either package: the newest entry whose SHA-256 verifies — a corrupt
  checkpoint falls back to the next-newest, never serves), or a live
  network.
- **Execution.** Each served model owns a `ParallelInference`
  (SEQUENTIAL: the shape-bucketed batcher owns all coalescing) and a
  `ShapeBucketedBatcher` whose ladder is warmed at load time.
- **Hot swap.** `swap(source)` loads and warms the replacement entirely
  off the request path (its whole bucket ladder runs on the new network
  first), then swaps it live atomically: in-flight batches finish on the
  old version, the next batch runs the new one.
- **Rollback.** Version history is kept in memory (bounded); `rollback`
  re-activates the previous version through the same warmed swap.

`deploy_lm` publishes a decode servable (`serving/decode.py`'s
`ServedLM`) beside them; redeploying a name is a version swap for both
kinds. Keras sources and sharded (mesh) servables come with later
slices (ROADMAP A.15-A.16).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving.batcher import (
    DEFAULT_BUCKETS, ServerDrainingError, ShapeBucketedBatcher,
)
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock
from deeplearning4j_tpu_torch.util.platform import DeviceLike

log = logging.getLogger("deeplearning4j_tpu_torch")


class ModelLoadError(RuntimeError):
    """A servable source could not be resolved/verified/loaded."""


def _input_type_of(model):
    """The single serving InputType of a container (multi-input graphs
    are not servable over the single-tensor HTTP surface)."""
    conf = model.conf
    it = getattr(conf, "input_type", None)
    if it is not None:
        return it
    types = getattr(conf, "input_types", None)
    if types:
        if len(types) > 1:
            raise ModelLoadError(
                "multi-input ComputationGraphs are not servable via the "
                "HTTP predict surface (single input tensor per request)")
        return types[0]
    raise ModelLoadError(
        f"{type(model).__name__} has no input_type; cannot derive the "
        "serving input shape")


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

    Accepted sources: a live MultiLayerNetwork or ComputationGraph;
    ``zoo:<ClassName>`` with optional ``?key=value&...`` constructor
    kwargs; a checkpoint directory with a ``manifest.json`` (newest
    SHA-256-verified entry; corrupt entries fall back); a ``.zip``
    checkpoint.
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
    from deeplearning4j_tpu_torch.util.serialization import load_model
    if os.path.isdir(src):
        from deeplearning4j_tpu_torch.train.resilience import (
            CheckpointManager,
        )
        entry = CheckpointManager(src).latest_valid()
        if entry is None:
            raise ModelLoadError(
                f"{src}: no checkpoint in the manifest passed SHA-256 "
                "verification")
        log.info("serving: loading %s (iteration %d, sha256 verified)",
                 entry["path"], entry.get("iteration", -1))
        return load_model(entry["path"], device=device)
    if not os.path.exists(src):
        raise ModelLoadError(f"servable source not found: {src}")
    return load_model(src, device=device)


@dataclasses.dataclass
class ServableVersion:
    version: int
    source: str
    model: object = dataclasses.field(repr=False)
    loaded_at: float = dataclasses.field(default_factory=time.time)

    def describe(self) -> dict:
        return {"version": self.version, "source": self.source,
                "loaded_at": self.loaded_at,
                "model_class": type(self.model).__name__,
                "device": str(self.model.device)}


class ServedModel:
    """One named servable: version history + ParallelInference + batcher.

    `device` is where a swap loads its replacement (the registry's
    device; None means CUDA, and raises without it)."""

    def __init__(self, name: str, model, source: str,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_ms: float = 5.0,
                 queue_limit: int = 256, device: DeviceLike = None):
        from deeplearning4j_tpu_torch.parallel.inference import (
            InferenceMode, ParallelInference,
        )
        self.name = name
        self.status = "loading"
        self.device = device
        # _swap_lock serializes whole swap/rollback operations (the warm
        # included); _state_lock guards only brief mutations of
        # versions/active, so describe() and the predict path never block
        # behind a warming swap
        self._swap_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.registry.ServedModel."
            "_swap_lock")
        self._state_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.registry.ServedModel."
            "_state_lock")
        self.versions: List[ServableVersion] = [
            ServableVersion(1, str(source), model)]
        self.active = 0                     # index into versions
        #: lock-free snapshot of the active version's metadata for the
        #: request path (atomic attribute swap; never indexes live lists)
        self.active_info = self.versions[0].describe()
        self.pi = ParallelInference(model, mode=InferenceMode.SEQUENTIAL)
        it = _input_type_of(model)
        self.input_shape: Tuple[int, ...] = tuple(it.shape)
        self.batcher = ShapeBucketedBatcher(
            self.pi.output, self.input_shape, buckets=buckets,
            max_delay_ms=max_delay_ms, queue_limit=queue_limit, name=name)
        self.warmup_seconds = self.batcher.warm()
        #: seconds of the last swap/rollback's warm + switch
        self.last_swap_seconds: Optional[float] = None
        self.status = "ready"
        monitor.gauge("serving_model_ready",
                      "1 while the servable is warmed and live",
                      labels=("model",)).set(1, model=name)

    @property
    def model(self):
        """The network serving right now."""
        return self.pi.model

    # ----------------------------------------------------------- lifecycle
    def _activate(self, sv: ServableVersion):
        """Warm the candidate's full bucket ladder, then swap it live
        atomically."""
        new_it = _input_type_of(sv.model)
        if tuple(new_it.shape) != self.input_shape:
            raise ModelLoadError(
                f"swap rejected: {sv.source!r} expects input "
                f"{tuple(new_it.shape)}, live servable {self.name!r} "
                f"serves {self.input_shape} (deploy under a new name)")
        t0 = time.perf_counter()
        with monitor.span("serving/swap", model=self.name,
                          version=sv.version):
            self.pi.update_model(sv.model,
                                 warmup=lambda run: self.batcher.warm(run))
        self.last_swap_seconds = time.perf_counter() - t0
        monitor.histogram("serving_swap_seconds",
                          "Load+warm+swap duration (off the request path)",
                          labels=("model",),
                          buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120)
                          ).observe(self.last_swap_seconds, model=self.name)

    def swap(self, source, keep_versions: int = 3) -> dict:
        """Load `source`, warm it off-path, make it the active version."""
        with self._swap_lock:
            if self.status == "stopping":
                # racing a drain: the batcher under this servable is
                # flushing for shutdown — a swap can neither warm nor go
                # live. Expected during the shutdown window.
                raise ServerDrainingError(
                    f"serving[{self.name}] is draining; swap rejected")
            model = load_servable(source, device=self.device)
            with self._state_lock:
                next_version = self.versions[-1].version + 1
            sv = ServableVersion(next_version, str(source), model)
            self._activate(sv)          # the warm: no state lock
            with self._state_lock:
                self.versions.append(sv)
                self.active = len(self.versions) - 1
                # bound in-memory history; sources stay in the metadata
                while len(self.versions) > keep_versions:
                    dropped = self.versions.pop(0)
                    self.active -= 1
                    log.info("serving[%s]: retired v%d (%s) from memory",
                             self.name, dropped.version, dropped.source)
                self.active_info = sv.describe()
            monitor.counter("serving_swaps_total",
                            "Zero-downtime model hot-swaps",
                            labels=("model",)).inc(model=self.name)
        log.info("serving[%s]: now serving v%d (%s)", self.name,
                 sv.version, sv.source)
        return sv.describe()

    def rollback(self) -> dict:
        """One-step rollback: re-activate the version before the active
        one through the same warmed swap."""
        with self._swap_lock:
            if self.status == "stopping":
                raise ServerDrainingError(
                    f"serving[{self.name}] is draining; rollback rejected")
            with self._state_lock:
                if self.active == 0:
                    raise ModelLoadError(
                        f"serving[{self.name}]: no previous version in "
                        "memory to roll back to")
                sv = self.versions[self.active - 1]
            self._activate(sv)
            with self._state_lock:
                self.active -= 1
                self.active_info = sv.describe()
            monitor.counter("serving_rollbacks_total",
                            "One-step version rollbacks",
                            labels=("model",)).inc(model=self.name)
        log.warning("serving[%s]: rolled back to v%d (%s)", self.name,
                    sv.version, sv.source)
        return sv.describe()

    # ------------------------------------------------------------- queries
    def predict(self, x, deadline: Optional[float] = None):
        return self.batcher.predict(x, deadline=deadline)

    def describe(self) -> dict:
        with self._state_lock:
            return {
                "name": self.name,
                "status": self.status,
                "input_shape": list(self.input_shape),
                "buckets": list(self.batcher.buckets),
                "active_version": self.versions[self.active].version,
                "versions": [v.describe() for v in self.versions],
            }

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        self.status = "stopping"
        monitor.gauge("serving_model_ready",
                      "1 while the servable is warmed and live",
                      labels=("model",)).set(0, model=self.name)
        if drain:
            self.batcher.drain(timeout=timeout)
        else:
            self.batcher.shutdown()
        self.pi.shutdown()


class ModelRegistry:
    """Thread-safe name -> ServedModel registry. Networks load onto
    `device` (default CUDA; raises without it)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.registry.ModelRegistry._lock")
        # deploys are rare admin ops: serializing them end-to-end (incl.
        # load+warm) closes the check-then-act race where two concurrent
        # deploys of one name would both build servables and leak one
        self._deploy_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.registry.ModelRegistry."
            "_deploy_lock")
        self._models: Dict[str, ServedModel] = {}

    def deploy(self, name: str, source,
               buckets: Sequence[int] = DEFAULT_BUCKETS,
               max_delay_ms: float = 5.0,
               queue_limit: int = 256) -> ServedModel:
        """Load, warm, and publish a servable under `name`. Deploying an
        existing name is a swap (version bump), not a replacement — the
        live batcher keeps ITS configuration (undeploy first to change
        buckets/queue bounds)."""
        with self._deploy_lock:
            with self._lock:
                existing = self._models.get(name)
            if existing is not None:
                if hasattr(existing, "generate"):
                    raise ModelLoadError(
                        f"{name!r} is already deployed as a DECODE "
                        "servable; a predict servable cannot swap over it "
                        "— undeploy first or pick a new name")
                if tuple(sorted(set(int(b) for b in buckets))) \
                        != existing.batcher.buckets \
                        or queue_limit != existing.batcher._queue.maxsize:
                    log.warning(
                        "serving[%s]: redeploy is a version swap — the "
                        "requested batcher config (buckets %s, queue %d) "
                        "is IGNORED; live config stays %s/%d (undeploy "
                        "first to change it)", name, tuple(buckets),
                        queue_limit, existing.batcher.buckets,
                        existing.batcher._queue.maxsize)
                existing.swap(source)
                return existing
            model = load_servable(source, device=self.device)
            served = ServedModel(name, model, str(source), buckets=buckets,
                                 max_delay_ms=max_delay_ms,
                                 queue_limit=queue_limit, device=self.device)
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
        post-training-quantized variant (serving/quantize.py) and
        ``@spec[:draft=...,k=...]`` turns on speculative decoding.
        Redeploying an existing name is a rolling swap — new streams
        admit on the new engine while in-flight streams finish on the
        old one."""
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
                if decode is not None and decode != existing.cfg:
                    log.warning(
                        "serving[%s]: redeploy is a version swap — the "
                        "requested DecodeConfig is IGNORED; the live "
                        "engine keeps %s (undeploy first to change it)",
                        name, existing.cfg)
                existing.swap(source)
                return existing
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
