"""StatsListener — per-iteration training stats capture.

Counterpart of the JAX package's `ui/stats.py` (DL4J
`deeplearning4j-ui-model/.../stats/BaseStatsListener.java:229-304`:
score, timing, memory, parameter/gradient/update histograms and mean
magnitudes, and the static-info record).

Gradients and updates come from the fit's capture iterations: on an
iteration `should_capture` accepts, `MultiLayerNetwork`'s per-call and
accumulate paths hand `on_gradients` the step's gradients and the
updater's output (averaged under accumulation) before `iteration_done`;
other steps run as they always do.

The summaries are the reference's numbers, computed where the tensors
lie (on the card for a network there) in float64: norm, mean magnitude
and non-finite count of each leaf, and a histogram of its finite values
over [min, max] whose counts equal `np.histogram`'s. numpy bins a value
by an estimate from its offset in the range, (x - lo) / (hi - lo) * n,
then corrects it once against the edges `np.linspace(lo, hi, n + 1)`;
the same float64 operations run here on the tensors (IEEE subtraction,
division and product, each its own kernel), against numpy's own edges
computed on the host from the leaf's min and max. Where the edges are
distinct the correction fixes every count. A range of a few ulps (the
reference widens a constant leaf's by 1e-12) can give repeated edges:
numpy 2.3 refuses to bin those, and a fit must not, so such a leaf is
binned by the estimate above (numpy 2.1's; 2.0 multiplied by n / (hi -
lo) and may put such a value one bin away). A constant leaf is
unaffected: its estimate is 0 either way. A group
(params, gradients, updates) costs two host syncs: the leaves' scalars
come back in one copy, then every leaf's edges go out in one and the
counts come back in one. Device memory and the static device list come
from torch.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import (
    StatsRecord, StatsStorageRouter, new_session_id,
)

TYPE_ID = "StatsListener"        # DL4J uses the listener class name


def _leaf_paths(tree, prefix="") -> Dict[str, torch.Tensor]:
    """Flatten a {layer: {param: tensor}} tree into {"0/W": tensor} paths
    (keys sorted at each level, empty leaves dropped)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaf_paths(tree[k], f"{prefix}{k}/"))
    elif tree is not None:
        t = tree if isinstance(tree, torch.Tensor) \
            else torch.as_tensor(np.asarray(tree))
        if t.numel():
            out[prefix[:-1]] = t.detach()
    return out


def _range(lo: float, hi: float):
    """`np.histogram`'s range for (lo, hi): an empty one is widened."""
    return (lo - 0.5, hi + 0.5) if lo == hi else (lo, hi)


def _histogram(a: torch.Tensor, ok: torch.Tensor, lo: float, hi: float,
               edges: torch.Tensor, n_bins: int) -> torch.Tensor:
    """`np.histogram(a[ok], bins=n_bins, range=(lo, hi))[0]` of a float64
    tensor whose finite values (`ok`) lie in the range, computed on its
    device as numpy computes it; `edges` are numpy's for the range (on
    the device). No host sync (counts land by `scatter_add_`, whose
    integer sums do not depend on their order)."""
    lo, hi = _range(lo, hi)
    x = torch.where(ok, a, lo)
    idx = ((x - lo) / (hi - lo) * n_bins).to(torch.int64)
    idx = idx - (idx == n_bins).to(torch.int64)
    idx = idx - (x < edges[idx]).to(torch.int64)
    idx = idx + ((x >= edges[idx + 1]) & (idx != n_bins - 1)).to(torch.int64)
    idx = torch.where(ok, idx, n_bins)          # a bin dropped below
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=a.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))[:n_bins]


def _summarize(arrays: Dict[str, torch.Tensor], n_bins: int,
               histograms: bool) -> Dict[str, dict]:
    """The reference's `_summarize` over tensors, on their device, with two
    host syncs: the leaves' scalars, then their counts (non-finite values
    are masked, never indexed out)."""
    if not arrays:
        return {}
    paths = list(arrays)
    flats, scalars = [], []
    for path in paths:
        a = arrays[path].reshape(-1).to(torch.float64)
        ok = torch.isfinite(a)
        n = ok.sum()
        zero = torch.zeros((), dtype=torch.float64, device=a.device)
        fin = torch.where(ok, a, zero)
        lo = torch.where(ok, a, float("inf")).min()
        hi = torch.where(ok, a, float("-inf")).max()
        nf = n.to(torch.float64)
        scalars.append(torch.stack([
            torch.linalg.vector_norm(fin),
            torch.where(n > 0, fin.abs().sum() / nf.clamp(min=1), zero),
            a.numel() - nf, nf, lo, hi]))
        flats.append((a, ok))
    table = torch.stack(scalars).to("cpu").tolist()
    summary, ranges = {}, []
    for path, (norm, mean_mag, bad, n, lo, hi) in zip(paths, table):
        entry = {"norm": float(norm), "mean_mag": float(mean_mag),
                 "n_non_finite": int(bad)}
        if histograms:
            if n:
                if lo == hi:
                    hi = lo + 1e-12
            else:
                lo, hi = 0.0, 0.0
            entry["hist"] = None
            entry["lo"], entry["hi"] = lo, hi
            ranges.append((lo, hi) if n else None)
        summary[path] = entry
    if histograms:
        edges = torch.from_numpy(np.stack([
            np.linspace(*_range(*r), n_bins + 1, endpoint=True,
                        dtype=np.float64) if r else np.zeros(n_bins + 1)
            for r in ranges])).to(flats[0][0].device)
        counts = torch.stack([
            _histogram(a, ok, *r, e, n_bins) if r else torch.zeros(
                n_bins, dtype=torch.int64, device=a.device)
            for (a, ok), r, e in zip(flats, ranges, edges)])
        for path, c in zip(paths, counts.to("cpu").tolist()):
            summary[path]["hist"] = c
    return summary


def _model_device(model) -> Optional[torch.device]:
    dev = getattr(model, "device", None)
    return torch.device(dev) if dev is not None else None


def _device_memory(device: Optional[torch.device] = None) -> dict:
    mem = {}
    if device is not None and device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        mem["device_bytes_in_use"] = int(
            stats.get("allocated_bytes.all.current", 0))
        mem["device_bytes_limit"] = int(
            torch.cuda.get_device_properties(device).total_memory)
    try:
        import resource
        mem["host_max_rss_kb"] = int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except (ImportError, OSError):
        pass
    return mem


def _devices(device: Optional[torch.device]) -> List[str]:
    """The process's devices of the model's kind, "<type>:<index>"."""
    if device is not None and device.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


class StatsListener(TrainingListener):
    """Captures score/timing/memory/param/grad/update stats into a
    StatsStorageRouter every `frequency` iterations.

    Usage (mirrors the reference's UIServer quickstart):
        storage = InMemoryStatsStorage()
        UIServer.get_instance().attach(storage)
        net.set_listeners(StatsListener(storage))
    """

    wants_gradients = True       # ask fit() for the capture iterations

    def __init__(self, router: StatsStorageRouter, frequency: int = 1,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker-0", histograms: bool = True,
                 n_bins: int = 20):
        self.router = router
        self.frequency = max(int(frequency), 1)
        self.session_id = session_id or new_session_id()
        self.worker_id = worker_id
        self.histograms = histograms
        self.n_bins = int(n_bins)
        self._static_sent = False
        self._last_time: Optional[float] = None
        self._pending: Optional[dict] = None

    # -------------------------------------------------------------- hooks
    def should_capture(self, iteration: int) -> bool:
        return iteration % self.frequency == 0

    def on_gradients(self, model, iteration, epoch, grads, updates):
        """Receives the gradient and update trees on capture iterations."""
        self._pending = {
            "gradients": _summarize(_leaf_paths(grads), self.n_bins,
                                    self.histograms),
            "updates": _summarize(_leaf_paths(updates), self.n_bins,
                                  self.histograms),
        }

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        if not self._static_sent:
            self._send_static(model)
        now = time.perf_counter()
        iter_ms = (now - self._last_time) * 1e3 if self._last_time else 0.0
        self._last_time = now
        if not self.should_capture(iteration):
            self._pending = None
            return
        data = {
            "iteration": int(iteration),
            "epoch": int(epoch),
            "score": float(score),
            "iter_ms": iter_ms,
            "etl_ms": float(etl_ms),
            "batch_size": int(batch_size),
            "samples_sec": (batch_size / (iter_ms / 1e3)
                            if iter_ms > 0 else 0.0),
            "memory": _device_memory(_model_device(model)),
            "params": _summarize(_leaf_paths(model.params), self.n_bins,
                                 self.histograms),
        }
        if self._pending is not None:
            data.update(self._pending)
            self._pending = None
        self.router.put_update(StatsRecord(
            session_id=self.session_id, type_id=TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(), data=data))

    # ------------------------------------------------------------- static
    def _send_static(self, model):
        self._static_sent = True
        layers: List[str] = [type(l).__name__
                             for l in getattr(model, "layers", [])]
        # per-layer drill-down table (TrainModule model tab): name, type,
        # param count and shapes, keyed the same way the update records
        # key their params ("0/W", "conv1/b", ...)
        params = getattr(model, "params", None) or {}
        detail = []
        if layers:
            named = [(str(i), type(l).__name__)
                     for i, l in enumerate(getattr(model, "layers", []))]
        else:       # ComputationGraph: vertices in topological order
            conf = getattr(model, "conf", None)
            vertices = getattr(conf, "vertices", {}) or {}
            named = [(name, type(vd.vertex).__name__)
                     for name, vd in vertices.items()]
        for key, ltype in named:
            leaves = _leaf_paths(params.get(key, {}) or {})
            detail.append({
                "name": key,
                "type": ltype,
                "n_params": int(sum(a.numel() for a in leaves.values())),
                "shapes": {k: list(a.shape) for k, a in leaves.items()},
            })
        info = {
            "start_time": time.time(),
            "model_class": type(model).__name__,
            "num_params": int(model.num_params()),
            "num_layers": len(detail) if detail else len(layers),
            "layer_names": layers,
            "layers": detail,
            "devices": _devices(_model_device(model)),
        }
        try:
            info["config_json"] = model.conf.to_json()
        except Exception:
            info["config_json"] = json.dumps({"error": "unserializable"})
        try:                      # layer table for the dashboard info card
            info["summary"] = model.summary()
        except Exception:
            pass
        self.router.put_static_info(StatsRecord(
            session_id=self.session_id, type_id=TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(), data=info))
