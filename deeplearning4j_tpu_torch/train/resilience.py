"""Atomic, manifest-tracked checkpoint directories.

Counterpart of the `CheckpointManager` of the JAX package's
`train/resilience.py`: the same directory layout, the same
`manifest.json` and `blessed.json` documents and the same SHA-256
checks, so either package reads a directory the other wrote — and the
serving registry (`serving/registry.load_servable`) serves the newest
entry that verifies, falling back past corrupt ones.

    <dir>/manifest.json          atomic (tmp + os.replace), hash index
    <dir>/ckpt_000042.zip        save_model zip + resilience.json extras

Only the manager is ported. The resilient fit loop (`ResilientTrainer`,
`FaultPolicy`, `PreemptionGuard`, auto-resume and the per-step fault
policy) stays with ROADMAP A.12.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import zipfile
from typing import Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


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
                   extra_entries={"resilience.json": json.dumps(extra)})
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
        save_model zips). Params, state, counters and, when the zip has
        one, the optimizer state land on the network's device."""
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
            model.params = params_from_numpy(
                _npz_bytes_to_tree(zf.read("coefficients.npz")),
                model.device, template=model.params)
            model.state = params_from_numpy(
                _npz_bytes_to_tree(zf.read("state.npz")), model.device,
                template=model.state)
            model.iteration_count = int(meta.get("iteration_count", 0))
            model.epoch_count = int(meta.get("epoch_count", 0))
            names = zf.namelist()
            if "updaterState.bin" in names:
                model.opt_state = updater_state_from_bytes(
                    zf.read("updaterState.bin"),
                    model.optimizer_state_template())
            extra = json.loads(zf.read("resilience.json")) \
                if "resilience.json" in names else {}
        return extra
