"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `ops/csrc/<name>.cu` is compiled on first use into a shared
library with a plain C interface,
``build/kernels/lib<name>-<hash>.so`` under the repository root (git
ignores ``build/``). The hash covers the source, the headers beside it and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Only sources in the repository are built; nothing is fetched.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

`build_all` starts one nvcc per source, all at once, and waits for them.
Each build emits an ``xla/compile`` span (program ``nvcc/<name>``), so
the goodput ledger books a first use's build as ``compile``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: every kernel source of the port, by name (csrc/<name>.cu)
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NVCC_TIMEOUT_S = 600


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    path: Path
    seconds: float          # nvcc wall time; 0.0 when loaded as built
    log: str                # nvcc's output (ptxas registers/spills)


_LOCK = threading.Lock()
_BUILT: Dict[str, BuiltLibrary] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from ops/csrc at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (target, tmp, process, t0) or (target, None, None, None)."""
    target = library_path(name)
    if target.exists():
        return target, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, time.perf_counter()


def _finish(name, target, tmp, proc, t0) -> BuiltLibrary:
    if proc is None:
        return BuiltLibrary(name, target, 0.0, "")
    try:
        out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise KernelBuildError(f"nvcc timed out after {NVCC_TIMEOUT_S}s "
                               f"building {name}")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed building {name} "
                               f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)     # atomic: a reader never sees half a library
    from deeplearning4j_tpu_torch.monitor import trace
    trace.add_span("xla/compile", t0, t0 + seconds, program=f"nvcc/{name}",
                   domain="kernel")
    return BuiltLibrary(name, target, seconds, out)


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> List[BuiltLibrary]:
    """Build every named source, one nvcc each, all started together."""
    with _LOCK:
        # graftlint: disable=transitive-blocking-under-lock -- one nvcc per source is the intent: a second caller waits for the running build instead of racing a duplicate compile into the same target; each nvcc is bounded by NVCC_TIMEOUT_S
        pending = [(n, *_start(n)) for n in names if n not in _BUILT]
        errors = []
        for name, target, tmp, proc, t0 in pending:
            try:
                _BUILT[name] = _finish(name, target, tmp, proc, t0)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
        return [_BUILT[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    built = build_all((name,))[0]
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(built.path))
            _LOADED[name] = lib
    return lib
