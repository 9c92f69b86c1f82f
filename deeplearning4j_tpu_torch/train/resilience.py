"""Fault-tolerant training: the resilient fit loop, atomic checkpoints,
auto-resume, preemption handling and a per-step fault policy.

Counterpart of the JAX package's `train/resilience.py`, with its
directory layout, documents, metric families and spans:

- **Atomic, manifest-tracked checkpoints** (`CheckpointManager`): every
  zip is written tmp-then-`os.replace` and recorded in `manifest.json`
  (itself atomically replaced) with a SHA-256; `latest_valid()` skips a
  truncated or corrupt file, and pruning touches only tracked files.
  Either package reads a directory the other wrote, and the serving
  registry serves the newest entry that verifies.

      <dir>/manifest.json          atomic (tmp + os.replace), hash index
      <dir>/ckpt_000042.zip        save_model zip + resilience.json extras

  The zips' entries are stored, not deflated: the fit waits for each
  save, and deflate on the host takes seconds where writing takes a
  fraction of one. Both packages read either method.

- **Auto-resume** (`ResilientTrainer.fit`): the newest valid checkpoint is
  restored, the data source fast-forwarded (or seeked) to the recorded
  epoch and step, and the dropout generator set back to its banked
  state, so a killed-and-resumed run reaches bitwise the parameters and
  optimizer state of an uninterrupted one.
- **Preemption** (`PreemptionGuard`): SIGTERM/SIGINT set a flag; at the
  next step boundary the trainer writes a checkpoint and stops
  (`FitReport.preempted`).
- **Per-step fault policy** (`FaultPolicy`): transient errors retry with
  jittered exponential backoff from a pre-step snapshot, non-finite
  losses skip the step, a run of skips or an exploding score
  (`DivergenceListener`) restores the newest good checkpoint.

Where the port differs from the reference, by design:

- The step updates parameters, optimizer state and layer state in place
  (`nn/step_graph.commit`). The pre-step snapshot is therefore kept on
  the device, in buffers allocated once per tensor signature and written
  with one grouped copy per dtype (`_DeviceSnapshot`); a restore copies
  back into
  the same tensors, so the optimizer and any captured step keep valid
  references. With the dropout generator's state taken beside it, a
  retried step is bitwise an unfaulted one. It costs one copy of the
  parameters, the optimizer state and the layer state in device memory,
  and no host traffic.
- The resilient step is the per-call fit's step
  (`TrainableNet._dispatch_step` with the epoch generator of
  `_epoch_generator`, 7919 for a network and 331 for a graph), so an
  uninterrupted resilient fit is bitwise `fit(scan_steps=1)`. The
  source is not prefetched (the reference does not either, and the
  stream position banked in a checkpoint must be that of the batches
  consumed).
- The random-stream carry banked in a checkpoint is the generator's
  state, under the port's own key ``"torch_rng"`` (hex bytes and the
  device type). The reference's ``"rng"`` (a JAX key) is neither written
  nor read: a reference checkpoint taken mid-epoch resumes at its step
  with the port's epoch generator reseeded, and the log says the noise
  stream restarts. A mid-epoch resume is bitwise only within the port;
  across packages only for networks without stochastic layers.

`util/faults.py` injects deterministic faults at the same step
boundaries (``DL4J_CUDA_FAULTS``).

Data parallelism: a SYNC_GRADIENTS `ParallelWrapper` (every rank of the
process group runs its own trainer over it), or a network under the
`use_mesh` plan, trains through the plan's step (`parallel/plan.py`),
engaged after the resume and released at the end. Rank 0 writes the
checkpoints, of whole tensors (a sharded plan gathers them on every rank
first), with the plan's description banked in ``extra["plan"]``; every
rank restores them, and resuming under another plan (another ZeRO stage)
logs a warning and re-shards onto the live plan. A mid-epoch resume
restores rank 0's dropout stream on rank 0; the other data ranks restart
theirs from the epoch seed (bitwise for networks without dropout).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import random
import signal
import threading
import time
import weakref
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import goodput
from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
from deeplearning4j_tpu_torch.nn import step_graph
from deeplearning4j_tpu_torch.train.listeners import (
    DivergenceListener, TrainingDivergedError,
)
from deeplearning4j_tpu_torch.util.faults import (
    FaultInjector, TransientFaultError,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


# --------------------------------------------------------------------- policy
@dataclasses.dataclass
class FaultPolicy:
    """Per-step fault handling knobs."""

    #: transient-error retry: attempts beyond the first, with jittered
    #: exponential backoff in [backoff_base, backoff_max] seconds.
    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    #: exception classes treated as retryable. Everything else propagates.
    transient_errors: Tuple = (TransientFaultError, ConnectionError,
                               TimeoutError, OSError)
    #: NaN/Inf loss -> restore the pre-step snapshot and skip the batch.
    skip_nonfinite: bool = True
    #: consecutive skipped steps beyond which training is declared
    #: unrecoverable (the last good checkpoint is restored).
    max_consecutive_skips: int = 3
    #: "restore": restore newest good checkpoint, log, stop the fit.
    #: "raise": restore, then raise TrainingDivergedError.
    on_unrecoverable: str = "restore"
    #: score-explosion detection via DivergenceListener (None disables).
    explosion_factor: Optional[float] = 1e4
    explosion_window: int = 20
    #: seed for the backoff jitter stream (determinism in tests).
    seed: int = 0

    @property
    def guards_steps(self) -> bool:
        """True when a pre-step snapshot is kept (needed to undo a faulted
        step). Costs one device copy of params/opt/state per step —
        disable both knobs for maximum-throughput unguarded fits."""
        return self.skip_nonfinite or self.max_retries > 0


@dataclasses.dataclass
class FitReport:
    """What happened during a resilient fit (returned by
    ResilientTrainer.fit; the trained model lives on the network)."""

    applied_steps: int = 0
    skipped_steps: int = 0
    retries: int = 0
    checkpoints_written: int = 0
    checkpoints_blessed: int = 0
    resumed_from: Optional[str] = None
    preempted: bool = False
    diverged: bool = False
    restored_checkpoint: Optional[str] = None
    final_score: Optional[float] = None
    #: goodput-ledger session summary, when `monitor.goodput` is enabled:
    #: the fit's wall-clock split over the closed category set (so a
    #: preempt->resume run accounts its replay as overhead, not compute)
    goodput_pct: Optional[float] = None
    time_by_category: Optional[dict] = None


class _Unrecoverable(Exception):
    """Internal control flow: divergence beyond the fault policy's
    tolerance; fit() translates it into restore-last-good semantics."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:     # EPERM etc.: exists but not ours
        return True
    return True


class CheckpointManager:
    """Atomic, manifest-tracked checkpoint directory.

    The manifest is the source of truth: `latest_valid()` walks it
    newest-first and SHA-256-verifies each candidate, so a truncated or
    bit-rotted file is skipped with a warning. Pruning removes only
    manifest-tracked files — anything else in the directory is kept."""

    MANIFEST = "manifest.json"
    BLESSED = "blessed.json"

    def __init__(self, directory: str, keep_last: int = 3,
                 prefix: str = "ckpt"):
        self.dir = directory
        self.keep_last = max(1, int(keep_last))
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)
        # a kill mid-save leaves a *.zip.tmp.<pid> partial. Sweep only
        # leftovers whose writing process is gone — another live process
        # may be mid-save in a shared directory
        for name in os.listdir(directory):
            if not (name.startswith(prefix) and ".zip.tmp." in name):
                continue
            try:
                pid = int(name.rsplit(".", 1)[-1])
            except ValueError:
                continue
            if pid != os.getpid() and _pid_alive(pid):
                continue
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass

    # ------------------------------------------------------------- manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, self.MANIFEST)

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"version": 1, "next_ordinal": 0, "checkpoints": []}

    def _write_manifest(self, manifest: dict):
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())

    @staticmethod
    def _sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    # ----------------------------------------------------------------- save
    def save(self, model, extra: dict) -> str:
        """Write one checkpoint atomically and record it in the manifest.
        `extra` (JSON-serializable) lands in the zip as resilience.json."""
        from deeplearning4j_tpu_torch.util.serialization import save_model
        manifest = self._read_manifest()
        ordinal = int(manifest.get("next_ordinal", 0))
        fname = f"{self.prefix}_{ordinal:06d}.zip"
        path = os.path.join(self.dir, fname)
        save_model(model, path, atomic=True,
                   extra_entries={"resilience.json": json.dumps(extra)},
                   compression=zipfile.ZIP_STORED)
        manifest["checkpoints"].append({
            "file": fname,
            "sha256": self._sha256(path),
            "iteration": int(model.iteration_count),
            "epoch": int(model.epoch_count),
            "step_in_epoch": int(extra.get("step_in_epoch", 0)),
            "time": time.time(),
        })
        manifest["next_ordinal"] = ordinal + 1
        # keep_last pruning: drop only files THIS manifest tracks — and
        # never the blessed (serving-eligible) one
        blessed = self._blessed_file()
        while len(manifest["checkpoints"]) > self.keep_last:
            prunable = [e for e in manifest["checkpoints"][:-self.keep_last]
                        if e["file"] != blessed]
            if not prunable:
                break
            old = prunable[0]
            manifest["checkpoints"].remove(old)
            try:
                os.remove(os.path.join(self.dir, old["file"]))
            except OSError:
                pass
        self._write_manifest(manifest)
        return path

    # ---------------------------------------------------------------- bless
    def _blessed_path(self) -> str:
        return os.path.join(self.dir, self.BLESSED)

    def _blessed_file(self) -> Optional[str]:
        try:
            with open(self._blessed_path()) as f:
                return json.load(f).get("file")
        except (OSError, ValueError):
            return None

    def bless(self, path: str, metrics: Optional[dict] = None) -> str:
        """Mark a checkpoint serving-eligible: atomically (re)write
        <dir>/blessed.json naming the file, its SHA-256, and the eval
        metrics that justified the blessing."""
        fname = os.path.basename(path)
        doc = {
            "version": 1,
            "file": fname,
            "path": os.path.abspath(path),
            "sha256": self._sha256(path),
            "blessed_at": time.time(),
            "metrics": dict(metrics or {}),
        }
        for entry in self._read_manifest().get("checkpoints", []):
            if entry["file"] == fname:
                doc["iteration"] = entry["iteration"]
                doc["epoch"] = entry["epoch"]
                break
        tmp = self._blessed_path() + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self._blessed_path())
        monitor.counter("resilience_checkpoints_blessed_total",
                        "Checkpoints marked serving-eligible "
                        "(blessed.json writes)").inc()
        log.info("checkpoint blessed for serving: %s (metrics %s)",
                 fname, doc["metrics"])
        return self._blessed_path()

    # --------------------------------------------------------------- resume
    def latest_valid(self) -> Optional[dict]:
        """Newest manifest entry whose file exists and hash verifies;
        invalid entries are skipped (fall back to the next-newest)."""
        manifest = self._read_manifest()
        for entry in reversed(manifest.get("checkpoints", [])):
            path = os.path.join(self.dir, entry["file"])
            if not os.path.exists(path):
                log.warning("checkpoint %s missing; falling back", path)
                continue
            try:
                if self._sha256(path) != entry["sha256"]:
                    log.warning("checkpoint %s failed integrity check; "
                                "falling back", path)
                    continue
            except OSError as e:
                log.warning("checkpoint %s unreadable (%s); falling back",
                            path, e)
                continue
            return {**entry, "path": path}
        return None

    def restore_into(self, model, path: str) -> dict:
        """Load a checkpoint INTO an existing network (initialized here
        if it is not) and return the resilience extras dict ({} for plain
        save_model zips). Params, state and, when the zip has one, the
        optimizer state are written into the network's tensors on its
        device (a leaf of another dtype is replaced), so whatever holds
        them stays valid; counters are set from the zip."""
        from deeplearning4j_tpu_torch.util.serialization import (
            _npz_bytes_to_tree, params_from_numpy, updater_state_from_bytes,
        )
        if model.params is None:
            model.init()
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("metadata.json"))
            conf_json = zf.read("configuration.json").decode()
            if conf_json != model.conf.to_json():
                log.warning("restoring %s into a model whose configuration "
                            "differs from the checkpoint's", path)
            params = params_from_numpy(
                _npz_bytes_to_tree(zf.read("coefficients.npz")),
                model.device, template=model.params)
            state = params_from_numpy(
                _npz_bytes_to_tree(zf.read("state.npz")), model.device,
                template=model.state)
            names = zf.namelist()
            opt_state = updater_state_from_bytes(
                zf.read("updaterState.bin"),
                model.optimizer_state_template()) \
                if "updaterState.bin" in names else None
            extra = json.loads(zf.read("resilience.json")) \
                if "resilience.json" in names else {}
        with torch.no_grad():
            step_graph.commit(model.params, params)
            step_graph.commit(model.state, state)
            if opt_state is not None:
                step_graph.commit(model.opt_state, opt_state)
        model._drop_graphs()
        model.iteration_count = int(meta.get("iteration_count", 0))
        model.epoch_count = int(meta.get("epoch_count", 0))
        return extra


# ----------------------------------------------------------------- preemption
class PreemptionGuard:
    """SIGTERM/SIGINT -> request a clean stop at the next step boundary.

    Installed only on the main thread (signal.signal requires it); the
    previous handlers are restored on exit. A second signal while the
    final checkpoint is being written chains to the previous handler, so
    an operator can always force-quit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.requested = False
        self.signum: Optional[int] = None
        self._old: dict = {}

    def _handler(self, signum, frame):
        if self.requested:
            old = self._old.get(signum)
            if callable(old):
                old(signum, frame)
            return
        self.requested = True
        self.signum = signum
        log.warning("received signal %d: checkpointing and shutting down "
                    "at the next step boundary", signum)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                try:
                    self._old[s] = signal.signal(s, self._handler)
                except (ValueError, OSError):  # non-main thread / exotic os
                    pass
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            try:
                signal.signal(s, old)
            except (ValueError, OSError):
                pass
        self._old = {}
        return False


# ------------------------------------------------------------------- drivers
def _grouped_copy(dst: list, src: list):
    """dst[i].copy_(src[i]) for all i, one grouped copy per dtype: a list
    that mixes dtypes (AdamW's int32 step count among f32 moments) takes
    PyTorch's per-tensor path, a copy launched per tensor."""
    groups: dict = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _DeviceSnapshot:
    """The pre-step copy of a network's parameters, optimizer state and
    layer state, in device buffers allocated once per tensor signature and
    written with one grouped copy per dtype, plus the dropout generator's
    state (on CUDA its seed and offset, read with no sync)."""

    def __init__(self):
        self._key = None
        self._bufs: list = []
        self._gen_state = None
        self.nbytes = 0

    def take(self, trees, generator):
        live = step_graph.tree_tensors(*trees)
        key = tuple((t.shape, t.dtype, t.device) for t in live)
        if key != self._key:
            self._bufs = [torch.empty_like(t) for t in live]
            self._key = key
            self.nbytes = sum(t.numel() * t.element_size() for t in live)
        with torch.no_grad():
            _grouped_copy(self._bufs, live)
        self._gen_state = None if generator is None else generator.get_state()

    def restore(self, trees, generator):
        """Write the snapshot back into the trees' tensors; a leaf the step
        replaced with one of another dtype (an f64 network's batch-norm
        statistics on its first step) gets a copy of the snapshot."""
        bufs = iter(self._bufs)
        pairs = []

        def walk(tree):
            for k in sorted(tree):
                v = tree[k]
                if isinstance(v, dict):
                    walk(v)
                    continue
                buf = next(bufs)
                if v.dtype == buf.dtype and v.shape == buf.shape:
                    pairs.append((v, buf))
                else:
                    tree[k] = buf.clone()

        with torch.no_grad():
            for tree in trees:
                walk(tree)
            _grouped_copy([v for v, _ in pairs], [b for _, b in pairs])
        if generator is not None and self._gen_state is not None:
            generator.set_state(self._gen_state)


class _NetDriver:
    """Per-call step execution for MultiLayerNetwork — the step, staging
    and dropout stream of MultiLayerNetwork._fit_epoch."""

    #: the epoch generator's seed stride (`TrainableNet._epoch_generator`)
    stride = 7919

    #: the plan the trainer engages; None: the `use_mesh` one, if any
    plan = None

    def __init__(self, net):
        self.net = net
        self._snap = _DeviceSnapshot()

    def engage(self):
        """Engage the plan on the network (after any resume)."""
        from deeplearning4j_tpu_torch.parallel.plan import active_plan
        plan = self.plan if self.plan is not None else active_plan()
        if plan is not None:
            self.net._engage_plan(plan)

    def release(self):
        if self.net._plan_rt is not None:
            self.net._engage_plan(None)

    def plan_describe(self) -> Optional[dict]:
        """The engaged plan's description (banked in checkpoints)."""
        rt = self.net._plan_rt
        if rt is not None:
            return rt.plan.describe()
        from deeplearning4j_tpu_torch.parallel.plan import active_plan
        plan = self.plan if self.plan is not None else active_plan()
        return None if plan is None else plan.describe()

    def data_index(self) -> int:
        rt = self.net._plan_rt
        return 0 if rt is None else rt.data_index

    def whole_view(self):
        """A block in which the network holds whole tensors (collective
        under a sharded plan)."""
        import contextlib
        rt = self.net._plan_rt
        return contextlib.nullcontext() if rt is None \
            else rt.whole_view(self.net)

    def prepare(self):
        if self.net.params is None:
            self.net.init()
        if getattr(self.net.conf, "backprop_type", None) == "tbptt":
            raise NotImplementedError(
                "ResilientTrainer does not support tbptt fits yet (chunk "
                "carries would have to be checkpointed mid-batch)")

    def make_source(self, data, batch_size):
        return self.net._as_iterator(data, batch_size)

    def batches(self, source):
        return iter(source)

    @staticmethod
    def reset(source):
        if hasattr(source, "reset"):
            source.reset()

    def epoch_generator(self) -> torch.Generator:
        """The network's dropout generator, reseeded for its current
        epoch exactly as fit() reseeds it."""
        return self.net._epoch_generator(self.stride)

    def _trees(self):
        n = self.net
        return (n.params, n.opt_state, n.state)

    def snapshot(self, generator):
        self._snap.take(self._trees(), generator)
        return self._snap

    def restore(self, snap, generator):
        snap.restore(self._trees(), generator)

    def step(self, batch, generator):
        """(loss on the device, batch size, the ledger's record or None,
        whether this step was the record's counted one)."""
        n = self.net
        struct = n._batch_struct(batch)
        bs = int(np.shape(step_graph.flatten(struct)[0])[0])
        loss, rec, fresh = n._dispatch_step(struct, generator, bs)
        return loss, bs, rec, fresh


class _GraphDriver(_NetDriver):
    """ComputationGraph per-call step (ComputationGraph's fit math and
    per-epoch generator reseed)."""

    stride = 331

    def make_source(self, data, batch_size):
        return data

    def batches(self, source):
        return self.net._iter_data(source)


class _WrapperDriver(_NetDriver):
    """A SYNC_GRADIENTS ParallelWrapper's step: the network's own step
    under the wrapper's plan, on batches the wrapper pads to the ranks."""

    def __init__(self, wrapper):
        from deeplearning4j_tpu_torch.parallel.wrapper import TrainingMode
        if wrapper.mode != TrainingMode.SYNC_GRADIENTS:
            raise NotImplementedError(
                "ResilientTrainer drives ParallelWrapper in SYNC_GRADIENTS "
                "mode only (AVERAGING keeps per-worker replica state that "
                "is not checkpointable step-by-step yet)")
        super().__init__(wrapper.model)
        self.wrapper = wrapper
        self.plan = wrapper.plan
        if wrapper._is_graph:
            self.stride = _GraphDriver.stride

    def make_source(self, data, batch_size):
        return self.wrapper._source(data, batch_size)

    def batches(self, source):
        from deeplearning4j_tpu_torch.parallel.wrapper import _PaddedSource
        return iter(_PaddedSource(self.wrapper, source))


def _generator_extra(generator: torch.Generator) -> dict:
    state = generator.get_state()
    return {"state": bytes(state.numpy()).hex(),
            "device": generator.device.type}


def _set_generator(generator: torch.Generator, banked: dict) -> bool:
    """Set a generator to a banked `_generator_extra` state; False when
    the state was banked for another device type."""
    if banked.get("device") != generator.device.type:
        return False
    generator.set_state(torch.tensor(bytearray.fromhex(banked["state"]),
                                     dtype=torch.uint8))
    return True


# ------------------------------------------------------------------- trainer
class ResilientTrainer:
    """Fault-tolerant fit loop around MultiLayerNetwork / ComputationGraph.

    Usage:
        trainer = ResilientTrainer(net, "/ckpts", save_every_n_iterations=50)
        report = trainer.fit(iterator, epochs=10)     # auto-resumes

    `epochs` is the TOTAL target (unlike net.fit's "additional epochs"):
    a resumed run passes the same value and trains only the remainder.
    The trained model lives on the wrapped network; `fit` returns a
    FitReport describing what happened (resume source, skips, retries,
    preemption).

    With a `torch.distributed` process group, only rank 0 writes
    checkpoints (every process restores); override with
    `write_checkpoints=`. `model` may be a SYNC_GRADIENTS
    `ParallelWrapper` (see the module doc).
    """

    def __init__(self, model, checkpoint_dir: str,
                 save_every_n_iterations: int = 50,
                 save_every_n_epochs: int = 1,
                 keep_last: int = 3,
                 policy: Optional[FaultPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 normalizer=None,
                 resume: bool = True,
                 write_checkpoints: Optional[bool] = None,
                 eval_gate=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        if type(model).__name__ == "ParallelWrapper":
            self._driver = _WrapperDriver(model)
        else:
            self._driver = _GraphDriver(model) \
                if isinstance(model, ComputationGraph) else _NetDriver(model)
        self.net = self._driver.net
        self.ckpt = CheckpointManager(checkpoint_dir, keep_last=keep_last)
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_n_epochs = save_every_n_epochs
        self.policy = policy or FaultPolicy()
        self.injector = injector if injector is not None \
            else FaultInjector.from_env()
        self.normalizer = normalizer
        self.resume = resume
        self.write_checkpoints = write_checkpoints
        # eval gate for continuous rollout: called after every checkpoint
        # save with the live network; return a metrics dict to bless the
        # checkpoint (CheckpointManager.bless -> blessed.json) or None to
        # withhold it from serving
        self.eval_gate = eval_gate
        self._jitter = random.Random(self.policy.seed)
        self._gen: Optional[torch.Generator] = None
        self._dispatch_idx = 0          # batches consumed, fit-global
        self._consecutive_skips = 0

    # ------------------------------------------------------------- plumbing
    def _writes_enabled(self) -> bool:
        if self.write_checkpoints is not None:
            return self.write_checkpoints
        dist = torch.distributed
        return not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0

    def _normalizer_extra(self) -> Optional[dict]:
        nz = self.normalizer
        if nz is None or not hasattr(nz, "save"):
            return None
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            nz.save(path)
            with open(path) as f:
                return json.load(f)
        except Exception as e:          # unfitted normalizer etc.
            log.warning("normalizer not checkpointed: %s", e)
            return None
        finally:
            try:
                os.remove(path)
            except OSError:
                pass

    def _restore_normalizer(self, blob: dict):
        from deeplearning4j_tpu_torch.data import normalization
        kind = blob.get("kind")
        cls = getattr(normalization, kind, None)
        if cls is None or not hasattr(cls, "restore"):
            log.warning("checkpoint normalizer kind %r unknown; ignored",
                        kind)
            return None
        import tempfile
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as tf:
            json.dump(blob, tf)
            path = tf.name
        try:
            return cls.restore(path)
        finally:
            try:
                os.remove(path)
            except OSError:
                pass

    def _save(self, report: FitReport, step_in_epoch: int):
        # every rank enters: a sharded plan gathers whole tensors
        with self._driver.whole_view():
            return self._save_whole(report, step_in_epoch)

    def _save_whole(self, report: FitReport, step_in_epoch: int):
        if not self._writes_enabled():
            return None
        extra = {
            "torch_rng": _generator_extra(self._gen),
            "step_in_epoch": int(step_in_epoch),
            "dispatch_idx": int(self._dispatch_idx),
        }
        src = getattr(self, "_source", None)
        src = src() if src is not None else None
        if src is not None and hasattr(src, "stream_state"):
            # the exact shard file/offset the next batch starts at — the
            # explicit position makes checkpoints auditable and resumable
            # by offset without replaying the order rule
            try:
                extra["stream"] = src.stream_state()
            except Exception:
                log.warning("checkpoint: stream_state() unavailable — "
                            "banking position-replay resume only",
                            exc_info=True)
        if self.net._score is not None:
            extra["score"] = float(self.net._score)
        plan_desc = self._driver.plan_describe()
        if plan_desc is not None:
            # the plan the run trained under: a resume onto another one
            # is detected and logged
            extra["plan"] = plan_desc
        nz = self._normalizer_extra()
        if nz is not None:
            extra["normalizer"] = nz
        t0 = time.perf_counter()
        with monitor.span("resilience/checkpoint_save",
                          iteration=self.net.iteration_count):
            path = self.ckpt.save(self.net, extra)
        monitor.histogram("resilience_checkpoint_save_seconds",
                          "Checkpoint zip write + hash + manifest update"
                          ).observe(time.perf_counter() - t0)
        monitor.counter("resilience_checkpoints_written_total",
                        "Checkpoints written by ResilientTrainer").inc()
        report.checkpoints_written += 1
        log.info("checkpoint written: %s (iteration %d, epoch %d, step %d)",
                 path, self.net.iteration_count, self.net.epoch_count,
                 step_in_epoch)
        if self.eval_gate is not None:
            try:
                with monitor.span("resilience/eval_gate",
                                  iteration=self.net.iteration_count):
                    metrics = self.eval_gate(self.net)
            except Exception:           # noqa: BLE001 — a broken eval gate
                # must not kill training; it only withholds the blessing,
                # and loudly: an unblessed stream starves the rollout
                log.warning("eval gate raised; checkpoint NOT blessed",
                            exc_info=True)
                metrics = None
            if metrics is not None:
                if not isinstance(metrics, dict):
                    metrics = {"score": float(metrics)}
                self.ckpt.bless(path, metrics)
                report.checkpoints_blessed += 1
        return path

    # ------------------------------------------------------------ stepping
    def _run_step(self, batch, step_idx: int, report: FitReport):
        """One guarded optimizer step. Returns (status, loss, batch_size)
        with status in {"applied", "skipped"}; raises _Unrecoverable when
        the consecutive-skip threshold trips."""
        policy = self.policy
        gen = self._gen
        snap = self._driver.snapshot(gen) if policy.guards_steps else None
        attempt = 0
        while True:
            # per-attempt clock: train_step_seconds and the train/step
            # span time ONLY the attempt that landed
            attempt_start = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.before_step(step_idx)
                loss, bs, rec, fresh = self._driver.step(batch, gen)
                wait_start = time.perf_counter()
                # wait for the device FIRST (goodput: step_compute), so the
                # host_sync span covers only the narrow D2H fetch
                goodput.device_wait(loss)
                fetch_start = time.perf_counter()
                monitor.add_span("train/device_wait", wait_start,
                                 fetch_start)
                loss_f = float(loss)
                step_end = time.perf_counter()
                step_secs = step_end - attempt_start
                monitor.add_span("train/host_sync", fetch_start, step_end)
                monitor.add_span("train/step", attempt_start,
                                 step_end, step=step_idx)
                break
            except policy.transient_errors as e:
                attempt += 1
                monitor.counter("resilience_retries_total",
                                "Transient-error step retries").inc()
                monitor.add_span("resilience/step_retry", attempt_start,
                                 time.perf_counter(), step=step_idx,
                                 attempt=attempt, error=str(e))
                if snap is not None:
                    # the failed attempt may have updated the tensors and
                    # drawn dropout noise: both go back
                    self._driver.restore(snap, gen)
                if attempt > policy.max_retries:
                    log.error("step %d failed after %d retries: %s — "
                              "checkpointing last good state and raising",
                              step_idx, policy.max_retries, e)
                    raise
                delay = min(policy.backoff_base * (2 ** (attempt - 1)),
                            policy.backoff_max)
                delay *= 0.5 + self._jitter.random()     # jitter in [.5, 1.5)
                log.warning("transient error at step %d (attempt %d/%d): "
                            "%s — retrying in %.3fs", step_idx, attempt,
                            policy.max_retries, e, delay)
                report.retries += 1
                time.sleep(delay)
        if self.injector is not None:
            loss_f = self.injector.corrupt_loss(step_idx, loss_f)
        if not math.isfinite(loss_f) and policy.skip_nonfinite:
            if snap is not None:
                # the tensors go back; the generator stays past the
                # skipped batch's draws, as the reference's key carry
                # stays split
                self._driver.restore(snap, None)
            self._consecutive_skips += 1
            report.skipped_steps += 1
            monitor.counter("resilience_steps_skipped_total",
                            "Steps skipped on non-finite loss").inc()
            monitor.instant("resilience/nan_skip", step=step_idx)
            log.warning("non-finite loss %s at step %d: skipping batch "
                        "(%d consecutive skips, threshold %d)", loss_f,
                        step_idx, self._consecutive_skips,
                        policy.max_consecutive_skips)
            if self._consecutive_skips > policy.max_consecutive_skips:
                raise _Unrecoverable(
                    f"{self._consecutive_skips} consecutive non-finite "
                    f"steps (threshold {policy.max_consecutive_skips}) "
                    f"at step {step_idx}")
            return "skipped", loss_f, bs
        self._consecutive_skips = 0
        step_graph.record_iteration(loss_f, bs, step_seconds=step_secs)
        if rec is not None and not fresh:
            # the counted step ran under the counters: only later steps
            # feed the MFU accountant
            xla_ledger.observe_step(rec, step_secs)
        return "applied", loss_f, bs

    # ------------------------------------------------------------------ fit
    def fit(self, data, epochs: int = 1, batch_size: int = 32) -> FitReport:
        report = FitReport()
        # the goodput session owns the WHOLE resilient fit wall-clock —
        # prepare, restore, replay, every epoch, the final save
        gp_session = goodput.fit_begin("resilient/fit")
        try:
            return self._fit_guarded(data, epochs, batch_size, report)
        finally:
            gp = goodput.fit_end(gp_session)
            if gp is not None:
                report.goodput_pct = gp["goodput_pct"]
                report.time_by_category = gp["categories"]

    def _resume(self, report: FitReport) -> Tuple[int, bool]:
        """Restore the newest valid checkpoint, if any: (step in epoch,
        whether the run resumes mid-epoch)."""
        net = self.net
        entry = self.ckpt.latest_valid()
        if entry is None:
            return 0, False
        t0 = time.perf_counter()
        with monitor.span("resilience/checkpoint_restore",
                          path=entry["path"]):
            extra = self.ckpt.restore_into(net, entry["path"])
        monitor.histogram("resilience_checkpoint_restore_seconds",
                          "Checkpoint verify + load into the model"
                          ).observe(time.perf_counter() - t0)
        monitor.counter("resilience_resumes_total",
                        "Auto-resumes from a checkpoint").inc()
        report.resumed_from = entry["path"]
        step_in_epoch = int(extra.get("step_in_epoch", 0))
        self._dispatch_idx = int(extra.get("dispatch_idx", 0))
        live_plan = self._driver.plan_describe()
        if extra.get("plan") != live_plan:
            # supported (checkpoints hold whole tensors; the live plan
            # re-shards them when it is engaged) but never silent
            log.warning(
                "resuming onto a different sharding plan: checkpoint "
                "trained under %s, live plan is %s — placements re-derived "
                "from the live plan", extra.get("plan"), live_plan)
        if step_in_epoch > 0:
            self._gen = self._driver.epoch_generator()
            banked = extra.get("torch_rng")
            if banked is None or not _set_generator(self._gen, banked):
                log.warning(
                    "resuming mid-epoch from %s without a dropout generator "
                    "state for %s (%s): the epoch's noise stream restarts "
                    "from its seed", entry["path"], self._gen.device.type,
                    "banked for " + banked["device"] if banked
                    else "not banked by this package")
        if "score" in extra:
            net._score = float(extra["score"])
        if "normalizer" in extra and self.normalizer is None:
            self.normalizer = self._restore_normalizer(extra["normalizer"])
        log.info("resumed from %s (iteration %d, epoch %d, step-in-epoch %d)",
                 entry["path"], net.iteration_count, net.epoch_count,
                 step_in_epoch)
        return step_in_epoch, step_in_epoch > 0

    def _fit_guarded(self, data, epochs: int, batch_size: int,
                     report: FitReport) -> FitReport:
        net = self.net
        policy = self.policy
        self._driver.prepare()

        step_in_epoch, resumed_mid_epoch = 0, False
        if self.resume:
            step_in_epoch, resumed_mid_epoch = self._resume(report)
        self._driver.engage()
        if resumed_mid_epoch and self._driver.data_index() > 0:
            log.info("data rank %d restarts its dropout stream from the "
                     "epoch seed (the checkpoint banks rank 0's)",
                     self._driver.data_index())
            self._gen = self._driver.epoch_generator()
        try:
            return self._fit_engaged(data, epochs, batch_size, report,
                                     step_in_epoch, resumed_mid_epoch)
        finally:
            self._driver.release()

    def _fit_engaged(self, data, epochs, batch_size, report, step_in_epoch,
                     resumed_mid_epoch):
        net = self.net
        policy = self.policy

        source = self._driver.make_source(data, batch_size)
        # weakly held: _save banks the seekable stream position while the
        # local `source` keeps it alive for the fit
        try:
            self._source = weakref.ref(source)
        except TypeError:
            self._source = None     # plain list/array: no stream_state
        if self.normalizer is not None \
                and getattr(source, "pre_processor", False) is None \
                and hasattr(source, "set_pre_processor"):
            source.set_pre_processor(self.normalizer)

        if any(getattr(lst, "wants_gradients", False)
               for lst in net.listeners):
            log.warning("gradient-capturing listeners (wants_gradients) are "
                        "not fed by the resilient fit loop — gradient/update "
                        "capture will be empty; use the plain fit() for "
                        "capture runs")

        div_guard = None
        if policy.explosion_factor:
            def _diverged(model, iteration, msg):
                raise TrainingDivergedError(msg)
            div_guard = DivergenceListener(
                explosion_factor=policy.explosion_factor,
                window=policy.explosion_window, on_divergence=_diverged)

        steps_since_save = 0
        gen_at_step_start = None    # generator state of the in-flight step
        with PreemptionGuard() as guard, \
                monitor.span("resilience/fit", epochs=epochs):
            # the uninterrupted run resets the source once per completed
            # epoch — replay those resets so epoch-dependent shuffles
            # match; a live streaming source re-fit in the same process
            # already consumed its in-fit resets (stream_state names its
            # epoch), so replay only the difference
            src_epoch = 0
            state_fn = getattr(source, "stream_state", None)
            if callable(state_fn):
                src_epoch = int(state_fn().get("epoch") or 0)
            for _ in range(max(0, net.epoch_count - src_epoch)):
                self._driver.reset(source)
            try:
                while net.epoch_count < epochs:
                    epoch = net.epoch_count
                    if not resumed_mid_epoch:
                        self._gen = self._driver.epoch_generator()
                        step_in_epoch = 0
                        for lst in net.listeners:
                            lst.on_epoch_start(net, epoch)
                    resumed_mid_epoch = False
                    consumed = 0
                    if step_in_epoch > 0 \
                            and getattr(source, "supports_seek", False):
                        # streaming sources land on the exact next shard
                        # offset instead of replaying the stream prefix
                        seek_start = time.perf_counter()
                        source.seek(step_in_epoch)
                        consumed = step_in_epoch
                        monitor.add_span("train/resume_replay", seek_start,
                                         time.perf_counter(),
                                         seeked=step_in_epoch)
                        if hasattr(source, "stream_state"):
                            log.info("resume: seeked stream to %s",
                                     source.stream_state())
                    it = self._driver.batches(source)
                    while True:
                        if guard.requested or (
                                self.injector is not None
                                and self.injector.should_preempt(
                                    self._dispatch_idx)):
                            self._save(report, step_in_epoch)
                            report.preempted = True
                            report.final_score = net._score
                            monitor.counter(
                                "resilience_preemptions_total",
                                "Preemption-triggered clean stops").inc()
                            monitor.instant("resilience/preempted",
                                            iteration=net.iteration_count)
                            log.warning("preempted: checkpointed at "
                                        "iteration %d; re-run to resume",
                                        net.iteration_count)
                            return report
                        etl_start = time.perf_counter()
                        if self.injector is not None:
                            # inside the ETL window: an injected stall
                            # must read as data_wait, like a real one
                            self.injector.before_fetch(self._dispatch_idx)
                        try:
                            batch = next(it)
                        except StopIteration:
                            break
                        etl_end = time.perf_counter()
                        if consumed < step_in_epoch:    # resume fast-forward
                            consumed += 1
                            # replayed batches are resume overhead, not
                            # data_wait
                            monitor.add_span("train/resume_replay",
                                             etl_start, etl_end,
                                             step=consumed)
                            continue
                        consumed += 1
                        etl_ms = (etl_end - etl_start) * 1e3
                        monitor.add_span("train/etl", etl_start, etl_end,
                                         step=self._dispatch_idx)
                        gen_at_step_start = self._gen.get_state()
                        step_idx = self._dispatch_idx
                        self._dispatch_idx += 1
                        status, loss_f, bs = self._run_step(
                            batch, step_idx, report)
                        gen_at_step_start = None    # step landed: no rewind
                        step_in_epoch = consumed
                        if status == "skipped":
                            continue
                        net._score = loss_f
                        report.applied_steps += 1
                        for lst in net.listeners:
                            lst.iteration_done(net, net.iteration_count,
                                               epoch, loss_f, etl_ms, bs)
                        if div_guard is not None:
                            div_guard.iteration_done(net,
                                                     net.iteration_count,
                                                     epoch, loss_f, 0.0, bs)
                        net.iteration_count += 1
                        steps_since_save += 1
                        if self.save_every_n_iterations and \
                                steps_since_save >= \
                                self.save_every_n_iterations:
                            self._save(report, step_in_epoch)
                            steps_since_save = 0
                    for lst in net.listeners:
                        lst.on_epoch_end(net, epoch)
                    net.epoch_count += 1
                    self._driver.reset(source)
                    step_in_epoch = 0
                    if self.save_every_n_epochs and \
                            net.epoch_count % self.save_every_n_epochs == 0 \
                            and net.epoch_count < epochs:
                        self._gen = self._driver.epoch_generator()
                        self._save(report, 0)
                        steps_since_save = 0
            except (_Unrecoverable, TrainingDivergedError) as e:
                return self._handle_unrecoverable(report, str(e))
            except policy.transient_errors:
                # retries exhausted: state is at the last good step —
                # checkpoint it so the operator can resume, then surface
                # the original error (a failing emergency save must not
                # mask it). The generator has drawn for the failed step
                # while step_in_epoch was not advanced — rewind it so the
                # resumed run draws the SAME noise for that step
                if gen_at_step_start is not None:
                    self._gen.set_state(gen_at_step_start)
                    self._dispatch_idx = max(0, self._dispatch_idx - 1)
                try:
                    self._save(report, step_in_epoch)
                except Exception as save_err:
                    log.error("emergency checkpoint failed: %s", save_err)
                raise
            # final checkpoint: a re-run of the same command sees
            # epoch_count == epochs and returns without retraining. A
            # no-op rerun (resumed, nothing trained) must NOT save again —
            # duplicate finals would rotate real history out of keep_last.
            if report.applied_steps > 0 or report.resumed_from is None:
                self._gen = self._driver.epoch_generator()
                self._save(report, 0)
        report.final_score = net._score
        return report

    def _handle_unrecoverable(self, report: FitReport, reason: str):
        """Graceful degradation: restore the newest good checkpoint so the
        model is left usable, then stop (or raise, per policy)."""
        report.diverged = True
        self._driver.release()          # the restore loads whole tensors
        monitor.counter("resilience_divergence_rollbacks_total",
                        "Unrecoverable divergences rolled back to the "
                        "last good checkpoint").inc()
        entry = self.ckpt.latest_valid()
        if entry is not None:
            self.ckpt.restore_into(self.net, entry["path"])
            report.restored_checkpoint = entry["path"]
            log.error("unrecoverable divergence (%s); restored last good "
                      "checkpoint %s", reason, entry["path"])
        else:
            log.error("unrecoverable divergence (%s) and no valid "
                      "checkpoint to restore", reason)
        report.final_score = self.net._score
        if self.policy.on_unrecoverable == "raise":
            raise TrainingDivergedError(
                f"{reason}; model restored to "
                f"{entry['path'] if entry else 'initial state'}")
        return report
