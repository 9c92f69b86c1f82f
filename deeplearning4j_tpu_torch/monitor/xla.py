"""Program ledger on CUDA — the third half of the telemetry subsystem.

The counterpart of the JAX package's compiled-program ledger, with its
API, its ``xla_*`` metric families, its program names and its JSON schema
(``LEDGER_SCHEMA_VERSION = 1``), so the same readers (a Prometheus
scrape, ``tools/perf_report.py --ledger``) apply to the port's output.
The port has no XLA program to lower, so what fills a record differs:

- **A program** is a step callable's name plus its signature: the shapes
  and dtypes of its inputs, K (``steps_per_call``), the device name and
  a variant the inputs cannot show (a network's compute dtype), the key
  a captured CUDA graph is kept under (`nn/step_graph.py`). The
  fingerprint is a SHA-256 of that key; ``hlo_hash`` holds the hash of
  the signature alone. ``xla_compiles_total`` counts captures of one key.
- **A "compile"** is the counted step: the one eager step that runs
  before a CUDA graph is captured (or, per call, the first step of a
  signature), plus the graph capture. ``compile_seconds`` is that wall
  time, emitted as an ``xla/compile`` span so goodput books it as
  ``compile``; a kernel's first-use nvcc build (`ops/_build.py`) emits
  one too.
- **FLOPs** are counted with `torch.utils.flop_counter.FlopCounterMode`
  over the counted step only (the timed steps never run under it). The
  flash kernels are launched through ctypes, where the counter cannot see
  them: their wrapper adds its work by the kernels' formula while a
  capture is open (`add_kernel_work`; per live (q, k) pair 4·D forward,
  6·D dQ, 8·D dK/dV) and hides its own PyTorch ops from the counters
  (`uncounted`), on the CPU route as on the card. ``flops`` is one
  step's count and ``total_flops_per_call`` scales it by K, as the
  reference's scan programs do.
- **Bytes accessed** are the operand and result bytes of every op of the
  counted step (a dispatch mode that sums tensor sizes), plus the
  kernels' Q, K, V, O, LSE, dO, dQ, dK and dV: an op-level upper bound on
  HBM traffic, not XLA's fused count.
- **HBM**: ``argument_bytes`` are the bytes of the tensors that go into
  the step (parameters, optimizer and layer state, the batch),
  ``output_bytes`` those it returns, ``temp_bytes`` the allocator's peak
  during the counted step less what was allocated before it
  (`torch.cuda.reset_peak_memory_stats` is called for that). On the CPU
  there is no allocator peak: ``hbm`` is None and
  ``xla_analysis_unavailable_total{kind="memory"}`` counts it.

On top of the ledger sits the live **MFU accountant**: call sites feed
measured wall time per execution into :func:`observe_step`, and the
``train_mfu_pct`` / ``serving_mfu_pct`` gauges report
``flops / seconds / device peak``. The peak is keyed on
`torch.cuda.get_device_name()`; only the card the repository has
measured is listed, at its dense bf16 tensor-core peak, so an f32 run is
measured against the bf16 peak too. ``DL4J_CUDA_PEAK_FLOPS`` and
``DL4J_CUDA_HBM_BYTES_PER_SEC`` override the table; any other device
reads None and the gauges stay unset.

Zero cost while disabled (the default): every hook is one module-global
bool read — no counter mode, no clock read, no extra sync or launch.
Enabled, the only extra host work is on the counted step. The module
imports no torch at import time (spawned ETL workers load `monitor`);
the functions that need it import it.

Quickstart:

    from deeplearning4j_tpu_torch import monitor
    monitor.xla.enable_ledger("/tmp/perf_ledger.json")
    net.fit(data, epochs=1)                  # programs captured as counted
    monitor.xla.save_ledger()                # JSON artifact for perf_report
    print(monitor.prometheus_text())         # xla_* families + train_mfu_pct
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.monitor import metrics, trace
from deeplearning4j_tpu_torch.util.env import env_float

log = logging.getLogger("deeplearning4j_tpu_torch")

#: peak dense-matmul FLOPs/s per card by `torch.cuda.get_device_name()`
#: (dense bf16 tensor cores, the reference's "bf16 for TPUs" convention;
#: NVIDIA's data sheet for the SXM part at its 700 W power limit — a card
#: capped lower reaches less, and its `power.limit` says so).
#: DL4J_CUDA_PEAK_FLOPS overrides for unlisted devices (e.g. a nominal CPU
#: peak in smoke tests — the gauge is then live but its absolute value is
#: only as real as the override).
PEAK_FLOPS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

#: HBM bandwidth bytes/s per card — the roofline's memory ceiling
#: (ridge point = peak_flops / hbm_bytes_per_sec).
HBM_BYTES_PER_SEC_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

#: capture-time buckets: sub-second eager steps through minute-long
#: first steps that build kernels.
COMPILE_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 180.0, 600.0)

LEDGER_SCHEMA_VERSION = 1

_lock = threading.RLock()
_enabled = False
_default_path: Optional[str] = None
_records: Dict[str, "ProgramRecord"] = {}    # fingerprint -> record
_latest: Dict[str, "ProgramRecord"] = {}     # domain -> last captured/observed
_last_mfu: Dict[str, float] = {}             # domain -> last gauge value
_device_info: Optional[Tuple[Optional[str], Optional[str]]] = None
#: the capture whose step is being counted (kernel wrappers add to it)
_open: Optional["Capture"] = None


class ProgramRecord:
    """One distinct step program (deduped by fingerprint).

    `flops` / `bytes_accessed` are one counted step's numbers; a scan or
    accumulation program runs `steps_per_call` (K) of them per call, and
    `total_flops_per_call` is the per-execution figure MFU uses (the
    reference's scan convention: XLA counts a scan body once)."""

    __slots__ = ("fingerprint", "name", "domain", "arg_shapes", "hlo_hash",
                 "compile_seconds", "compiles", "flops", "bytes_accessed",
                 "hbm", "examples_per_call", "steps_per_call",
                 "first_captured_unix", "arg_shardings")

    def __init__(self, fingerprint, name, domain, arg_shapes, hlo_hash,
                 compile_seconds, flops, bytes_accessed, hbm,
                 examples_per_call, steps_per_call, arg_shardings=None):
        self.fingerprint = fingerprint
        self.name = name
        self.domain = domain
        self.arg_shapes = arg_shapes
        self.hlo_hash = hlo_hash
        self.compile_seconds = compile_seconds    # first capture's wall time
        self.compiles = 1
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.hbm = hbm                            # dict or None
        self.examples_per_call = examples_per_call
        self.steps_per_call = max(int(steps_per_call), 1)
        #: per-arg placement ("single" for a device tensor, "host" for a
        #: host array): the port runs no sharded program, so `sharded` is
        #: always False
        self.arg_shardings = tuple(arg_shardings or ())
        self.first_captured_unix = time.time()

    @property
    def total_flops_per_call(self) -> Optional[float]:
        if not self.flops:
            return None
        return self.flops * self.steps_per_call

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        if self.flops and self.bytes_accessed:
            return self.flops / self.bytes_accessed
        return None

    @property
    def hbm_peak_bytes(self) -> Optional[int]:
        return hbm_peak(self.hbm)

    @property
    def is_sharded(self) -> bool:
        return any("PartitionSpec(" in s and s != "PartitionSpec()"
                   for s in self.arg_shardings)

    def to_json(self) -> dict:
        ai = self.arithmetic_intensity
        return {
            "fingerprint": self.fingerprint,
            "name": self.name,
            "domain": self.domain,
            "arg_shapes": list(self.arg_shapes),
            "hlo_hash": self.hlo_hash,
            "compile_seconds": round(self.compile_seconds, 6),
            "compiles": self.compiles,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "arithmetic_intensity": None if ai is None else round(ai, 3),
            "hbm": self.hbm,
            "hbm_peak_bytes": self.hbm_peak_bytes,
            "examples_per_call": self.examples_per_call,
            "steps_per_call": self.steps_per_call,
            "total_flops_per_call": self.total_flops_per_call,
            "arg_shardings": list(self.arg_shardings),
            "sharded": self.is_sharded,
            "first_captured_unix": round(self.first_captured_unix, 3),
        }

    def brief(self) -> dict:
        """Compact row for a sweep's JSON (full detail in the ledger)."""
        out = {"name": self.name, "fingerprint": self.fingerprint,
               "compile_s": round(self.compile_seconds, 3)}
        total = self.total_flops_per_call
        if total:
            out["gflops_per_call"] = round(total / 1e9, 2)
        ai = self.arithmetic_intensity
        if ai is not None:
            out["arithmetic_intensity"] = round(ai, 2)
        peak = self.hbm_peak_bytes
        if peak:
            out["hbm_peak_bytes"] = peak
        if self.is_sharded:
            out["sharded"] = True
        return out


# ------------------------------------------------------------- lifecycle
def enable_ledger(path: Optional[str] = None):
    """Start capturing programs (idempotent). `path` becomes the default
    for save_ledger(). Registers every xla_* metric family so the
    exposition carries them (with TYPE/HELP) even before the first
    capture — scrapers can alert on absence, not just on values."""
    global _enabled, _default_path
    if path is not None:
        _default_path = path
    _register_families()
    _enabled = True


def disable_ledger():
    global _enabled
    _enabled = False


def ledger_enabled() -> bool:
    return _enabled


#: alias used by the hot-path hooks (reads one module global).
enabled = ledger_enabled


def clear_ledger():
    """Drop every record, the default path, and the cached device lookup
    (tests)."""
    global _device_info, _default_path
    with _lock:
        _records.clear()
        _latest.clear()
        _last_mfu.clear()
        _device_info = None
        _default_path = None


def _register_families():
    metrics.counter("xla_compiles_total",
                    "XLA compile events captured by the program ledger "
                    "(recompiles of the same fingerprint keep counting)",
                    labels=("program",))
    metrics.histogram("xla_compile_seconds",
                      "Compile wall time per captured program (AOT "
                      "lower+compile; cache-hit cost when the persistent "
                      "compile cache is warm)",
                      labels=("program",), buckets=COMPILE_BUCKETS)
    metrics.gauge("xla_programs",
                  "Distinct compiled programs in the ledger (fingerprint-"
                  "deduped)")
    metrics.gauge("xla_program_flops",
                  "cost_analysis() FLOPs per call of the compiled program",
                  labels=("program", "fingerprint"))
    metrics.gauge("xla_program_bytes_accessed",
                  "cost_analysis() bytes accessed per call",
                  labels=("program", "fingerprint"))
    metrics.gauge("xla_program_arithmetic_intensity",
                  "FLOPs / bytes accessed (roofline x-coordinate)",
                  labels=("program", "fingerprint"))
    metrics.gauge("xla_hbm_peak_bytes",
                  "memory_analysis() argument+output+temp bytes of the "
                  "compiled program (peak HBM residency)",
                  labels=("program", "fingerprint"))
    metrics.gauge("xla_program_sharded",
                  "1 when the program's arguments carry non-trivial "
                  "PartitionSpecs (GSPMD plan), 0 when replicated/"
                  "single-device",
                  labels=("program", "fingerprint"))
    metrics.counter("xla_analysis_unavailable_total",
                    "cost/memory analysis probes that degraded (backend "
                    "capability missing, not a lowering bug), by kind",
                    labels=("kind",))
    metrics.gauge("train_mfu_pct",
                  "Live model FLOPs utilization of the training step: "
                  "ledger FLOPs / measured step time / device peak, %")
    metrics.gauge("serving_mfu_pct",
                  "Live model FLOPs utilization of the serving forward, %")


def analysis_unavailable(kind: str):
    """Count a degraded capability probe (counted, never crashing)."""
    metrics.counter("xla_analysis_unavailable_total",
                    "cost/memory analysis probes that degraded (backend "
                    "capability missing, not a lowering bug), by kind",
                    labels=("kind",)).inc(kind=kind)


# --------------------------------------------------------------- devices
def _device() -> Tuple[Optional[str], Optional[str]]:
    """(device name, backend) of the programs: the card a capture ran on,
    else the first card, else the CPU."""
    global _device_info
    if _device_info is None:
        try:
            import torch
            if torch.cuda.is_available():
                _device_info = (torch.cuda.get_device_name(0), "cuda")
            else:
                _device_info = ("cpu", "cpu")
        except Exception:                  # noqa: BLE001 — telemetry only
            _device_info = (None, None)
    return _device_info


def _peak_override(var: str) -> Optional[float]:
    """env_float, but a malformed value DEGRADES to the device table
    with one warning instead of raising: these are telemetry overrides
    read from the MFU accountant on the fit path — a typo'd knob must
    never kill a training run."""
    try:
        return env_float(var)
    except ValueError as e:
        if var not in _warned_overrides:
            _warned_overrides.add(var)
            log.warning("%s — falling back to the device table", e)
        return None


_warned_overrides: set = set()


def device_peak_flops() -> Optional[float]:
    """Peak FLOPs/s for MFU accounting: the env override
    DL4J_CUDA_PEAK_FLOPS wins, then the per-device table; None for
    unlisted devices (the MFU gauges are then simply not set)."""
    env = _peak_override("DL4J_CUDA_PEAK_FLOPS")
    if env is not None:
        return env
    kind, _ = _device()
    return PEAK_FLOPS_BY_KIND.get(kind) if kind else None


def device_hbm_bytes_per_sec() -> Optional[float]:
    env = _peak_override("DL4J_CUDA_HBM_BYTES_PER_SEC")
    if env is not None:
        return env
    kind, _ = _device()
    return HBM_BYTES_PER_SEC_BY_KIND.get(kind) if kind else None


# --------------------------------------------------------------- signatures
def _leaves(tree) -> list:
    """Leaves of nested dicts (sorted keys), lists and tuples; None
    disappears, as in a pytree flatten."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _leaf_sig(leaf) -> str:
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return f"{_dtype_name(leaf.dtype)}[{','.join(map(str, leaf.shape))}]"
    return type(leaf).__name__


def shape_key(tree) -> Tuple[str, ...]:
    """Cheap per-call cache key: shapes/dtypes of every array leaf (no
    device sync)."""
    return tuple(_leaf_sig(leaf) for leaf in _leaves(tree))


def _leaf_sharding(leaf) -> str:
    """"single" for a tensor on a device, "host" for a host array or
    scalar."""
    dev = getattr(leaf, "device", None)
    if dev is None or getattr(dev, "type", "cpu") == "cpu":
        return "host"
    return "single"


def sharding_key(tree) -> Tuple[str, ...]:
    """Per-arg placement paired with shape_key (the ledger's
    `arg_shardings`)."""
    return tuple(_leaf_sharding(leaf) for leaf in _leaves(tree))


def _nbytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        n = getattr(leaf, "nbytes", None)
        if n is None and hasattr(leaf, "element_size"):
            n = leaf.numel() * leaf.element_size()
        total += int(n or 0)
    return total


def _cuda_device(tree):
    for leaf in _leaves(tree):
        dev = getattr(leaf, "device", None)
        if getattr(dev, "type", None) == "cuda":
            return dev
    return None


def hbm_peak(hbm: Optional[Dict[str, int]]) -> Optional[int]:
    """THE peak-residency definition every surface shares: arguments +
    output + temps of the program."""
    if not hbm:
        return None
    return (hbm.get("argument_bytes", 0) + hbm.get("output_bytes", 0)
            + hbm.get("temp_bytes", 0))


# --------------------------------------------------------------- capture
def counting() -> bool:
    """True while a capture counts its step (kernel wrappers then add
    their work with `add_kernel_work` and run under `uncounted`)."""
    return _open is not None


def add_kernel_work(name: str, flops: float, bytes_accessed: float):
    """Add a hand-written kernel's work to the open capture (the FLOP
    counter cannot see a ctypes launch)."""
    cap = _open
    if cap is not None:
        cap.add_kernel(name, flops, bytes_accessed)


def uncounted():
    """Context that hides the ops inside it from the open capture's
    counters (a kernel wrapper whose work `add_kernel_work` counts)."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


def _byte_mode():
    """A dispatch mode summing the bytes of every op's tensor operands
    and results."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__ not in ("detach.default", "empty.memory_format",
                                     "empty_strided.default",
                                     "view.default",
                                     "_unsafe_view.default", "t.default",
                                     "transpose.int", "permute.default",
                                     "expand.default", "as_strided.default",
                                     "unsqueeze.default", "squeeze.dim",
                                     "slice.Tensor", "select.int"):
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor):
                        self.bytes += t.numel() * t.element_size()
            return out

    return ByteCounter()


class Capture:
    """One counted step: ``with cap: out = fn()`` runs it under the FLOP
    and byte counters, then `finish()` books the record (the caller may
    do untimed-but-booked work between the two, like a graph capture,
    whose time joins ``compile_seconds``). Built by `begin_capture`."""

    def __init__(self, name: str, args, domain: str,
                 examples_per_call: Optional[int], steps_per_call: int,
                 variant: str = ""):
        self.name = name
        self.variant = variant
        self.domain = domain
        self.examples_per_call = examples_per_call
        self.steps_per_call = max(int(steps_per_call), 1)
        self.arg_shapes = shape_key(args)
        self.arg_shardings = sharding_key(args)
        self.argument_bytes = _nbytes(args)
        self.device = _cuda_device(args)
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.flops = self.bytes_accessed = None
        self.hbm = None
        self.output = None
        self.t0 = self.t1 = None
        self._flop_mode = self._byte_mode = None
        self._base_alloc = 0

    def add_kernel(self, name: str, flops: float, nbytes: float):
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __enter__(self):
        global _open
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        if self.device is not None:
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base_alloc = torch.cuda.memory_allocated(self.device)
        self._flop_mode = FlopCounterMode(display=False)
        self._byte_mode = _byte_mode()
        self._flop_mode.__enter__()
        self._byte_mode.__enter__()
        _open = self
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _open
        import torch
        _open = None
        self._byte_mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        if exc[0] is not None:
            return False
        f = float(self._flop_mode.get_total_flops()) + self.kernel_flops
        self.flops = f if f > 0 else None
        b = float(self._byte_mode.bytes) + self.kernel_bytes
        self.bytes_accessed = b if b > 0 else None
        if self.device is not None:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.hbm = {
                "argument_bytes": int(self.argument_bytes),
                "output_bytes": int(_nbytes(self.output)),
                "temp_bytes": int(max(peak - self._base_alloc, 0)),
                "alias_bytes": 0, "generated_code_bytes": 0}
        return False

    def finish(self) -> ProgramRecord:
        """Book the record (dedup by fingerprint), the metrics and the
        ``xla/compile`` span from the counted step's start to now."""
        global _device_info
        t1 = time.perf_counter()
        trace.add_span("xla/compile", self.t0, t1, program=self.name,
                       domain=self.domain)
        dev_name = "cpu"
        if self.device is not None:
            import torch
            dev_name = torch.cuda.get_device_name(self.device)
            _device_info = (dev_name, "cuda")
        sig = "|".join(self.arg_shapes + (f"k={self.steps_per_call}",
                                          dev_name, self.variant))
        sig_hash = hashlib.sha256(sig.encode()).hexdigest()[:16]
        fingerprint = hashlib.sha256(
            f"{self.name}|{sig}".encode()).hexdigest()[:16]
        if self.flops is None:
            analysis_unavailable("cost")
        if self.hbm is None:
            analysis_unavailable("memory")
        return _book(fingerprint, self.name, self.domain, self.arg_shapes,
                     sig_hash, t1 - self.t0, self.flops,
                     self.bytes_accessed, self.hbm, self.examples_per_call,
                     self.steps_per_call, self.arg_shardings)


def begin_capture(name: str, args, domain: str = "train",
                  examples_per_call: Optional[int] = None,
                  steps_per_call: int = 1,
                  variant: str = "") -> Optional[Capture]:
    """The counted step's context for a hot-path hook, or None while the
    ledger is disabled (one bool read). `args` are the tensors that go
    into the step (for the signature and ``argument_bytes``); `variant`
    joins the signature (what the inputs do not show, e.g. the compute
    dtype of a network with f32 master weights)."""
    if not _enabled:
        return None
    return Capture(name, args, domain, examples_per_call, steps_per_call,
                   variant)


def _book(fingerprint, name, domain, arg_shapes, sig_hash, seconds, flops,
          bytes_accessed, hbm, examples_per_call, steps_per_call,
          arg_shardings) -> ProgramRecord:
    with _lock:
        rec = _records.get(fingerprint)
        if rec is None:
            rec = ProgramRecord(fingerprint, name, domain, arg_shapes,
                                sig_hash, seconds, flops, bytes_accessed,
                                hbm, examples_per_call, steps_per_call,
                                arg_shardings=arg_shardings)
            _records[fingerprint] = rec
        else:
            rec.compiles += 1
        _latest[domain] = rec
        n_programs = len(_records)

    metrics.counter("xla_compiles_total", labels=("program",)
                    ).inc(program=name)
    metrics.histogram("xla_compile_seconds", labels=("program",),
                      buckets=COMPILE_BUCKETS).observe(seconds, program=name)
    metrics.gauge("xla_programs").set(n_programs)
    if rec.flops:
        metrics.gauge("xla_program_flops",
                      labels=("program", "fingerprint")).set(
            rec.flops, program=name, fingerprint=fingerprint)
    if rec.bytes_accessed:
        metrics.gauge("xla_program_bytes_accessed",
                      labels=("program", "fingerprint")).set(
            rec.bytes_accessed, program=name, fingerprint=fingerprint)
    ai = rec.arithmetic_intensity
    if ai is not None:
        metrics.gauge("xla_program_arithmetic_intensity",
                      labels=("program", "fingerprint")).set(
            ai, program=name, fingerprint=fingerprint)
    peak_bytes = rec.hbm_peak_bytes
    if peak_bytes:
        metrics.gauge("xla_hbm_peak_bytes",
                      labels=("program", "fingerprint")).set(
            peak_bytes, program=name, fingerprint=fingerprint)
    metrics.gauge("xla_program_sharded",
                  labels=("program", "fingerprint")).set(
        1.0 if rec.is_sharded else 0.0, program=name,
        fingerprint=fingerprint)
    return rec


def capture(name: str, fn, args, domain: str = "train",
            examples_per_call: Optional[int] = None,
            steps_per_call: int = 1) -> Optional[ProgramRecord]:
    """Capture the program `fn(*args)` into the ledger by RUNNING it once
    under the counters (the port has nothing to lower: call this where
    the step runs anyway, e.g. on a signature's first step; hot-path
    hooks use `begin_capture` to keep the step's output).

    Every call increments ``xla_compiles_total``; identical fingerprints
    dedup to one ledger entry. Returns None while the ledger is disabled
    (one bool read) or if the step itself raises (counted, never
    raised — observability must not take down a fit)."""
    cap = begin_capture(name, args, domain, examples_per_call,
                        steps_per_call)
    if cap is None:
        return None
    try:
        with cap:
            cap.output = fn(*args)
    except Exception as e:  # noqa: BLE001 — ledger must never kill a fit
        analysis_unavailable("lower")
        log.warning("xla ledger: capture of %r failed: %r", name, e)
        return None
    return cap.finish()


def capture_cached(cache: dict, key, name: str, fn, args,
                   domain: str = "train",
                   examples_per_call: Optional[int] = None,
                   steps_per_call: int = 1) -> Optional[ProgramRecord]:
    """Hot-loop helper: capture once per caller-observed program (`key`
    is the caller's cheap identity), then a dict hit per step. A key can
    legitimately map to None (capture failed) — that negative result is
    cached too, so a broken step is probed once, not every step."""
    if not _enabled:
        return None
    if key in cache:
        return cache[key]
    rec = capture(name, fn, args, domain=domain,
                  examples_per_call=examples_per_call,
                  steps_per_call=steps_per_call)
    cache[key] = rec
    return rec


# ----------------------------------------------------------- observation
def observe_step(rec: Optional[ProgramRecord], seconds: float,
                 domain: Optional[str] = None):
    """Feed one measured execution of `rec` (wall seconds) into the MFU
    accountant. train → train_mfu_pct, serving → serving_mfu_pct; the
    gauge is only set when both the program's FLOPs and the device peak
    are known. No-op when the ledger is disabled or rec is None."""
    if rec is None or not _enabled or seconds <= 0:
        return
    d = domain or rec.domain
    with _lock:
        _latest[d] = rec
    peak = device_peak_flops()
    total = rec.total_flops_per_call
    if peak and total:
        mfu = 100.0 * total / seconds / peak
        with _lock:
            _last_mfu[d] = mfu
        metrics.gauge("train_mfu_pct" if d == "train"
                      else "serving_mfu_pct").set(mfu)


def latest_record(domain: str = "train") -> Optional[ProgramRecord]:
    with _lock:
        return _latest.get(domain)


def last_mfu(domain: str = "train") -> Optional[float]:
    with _lock:
        return _last_mfu.get(domain)


def records() -> List[ProgramRecord]:
    with _lock:
        return list(_records.values())


# ------------------------------------------------------------ persistence
def ledger_dict() -> dict:
    """The persisted schema (consumed by tools/perf_report.py)."""
    kind, backend = _device()
    with _lock:
        progs = [r.to_json() for r in _records.values()]
    return {
        "version": LEDGER_SCHEMA_VERSION,
        "created_unix": round(time.time(), 3),
        "device_kind": kind,
        "backend": backend,
        "peak_flops": device_peak_flops(),
        "hbm_bytes_per_sec": device_hbm_bytes_per_sec(),
        "programs": progs,
    }


def save_ledger(path: Optional[str] = None,
                merge_existing: bool = False) -> int:
    """Atomically write the ledger JSON (tmp + os.replace, like
    save_trace). Returns the number of program records written.

    merge_existing=True folds in the programs an earlier process already
    wrote to `path` (deduped by fingerprint, this process's records win),
    for runs that write one DL4J_CUDA_PERF_LEDGER file from several
    processes in turn."""
    path = path or _default_path
    if not path:
        raise ValueError("no ledger path: pass one or enable_ledger(path)")
    doc = ledger_dict()
    if merge_existing and os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
            ours = {p["fingerprint"] for p in doc["programs"]}
            doc["programs"] = [p for p in prior.get("programs", [])
                               if p.get("fingerprint") not in ours] \
                + doc["programs"]
        except (OSError, ValueError, TypeError, KeyError):
            pass                      # corrupt prior file: overwrite it
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return len(doc["programs"])
