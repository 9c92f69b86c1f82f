"""Native host kernels: C++ built with g++ at first use, loaded by ctypes.

The port's copy of the JAX package's native library. `src/*.cpp` (the
gradient codec and the HogWild skip-gram trainer, the INDArray-contract
host ops, the Barnes-Hut tree, the strict CSV parser and the batch
tokenizer) compile once into one shared library:

    g++ -std=c++17 -O3 -shared -fPIC -march=native [-fopenmp] src/*.cpp

with OpenMP first and serially when that build fails, the reference's
flags in the reference's order. The library lands in ``build/native/``
under the repository root (git ignores ``build/``), or in the directory
``DL4J_CUDA_NATIVE_CACHE`` names. Its file name hashes the sources, the
flags, ``g++ --version`` and the host CPU's model name: a ``-march=native``
library built on one host can die of an illegal instruction on another.

When no toolchain is present everything degrades to the numpy twins (the
callers check `available()`). `CALLS` counts the calls into the library
by C function, so a test or a smoke run can show the native path ran.
The library is loaded with ``RTLD_LOCAL`` (ctypes' default): the JAX
package's library exports the same C symbols and may share the process.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import platform
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SRCS = [os.path.join(_SRC_DIR, "dl4jtpu_native.cpp"),
         os.path.join(_SRC_DIR, "ndarray_ops.cpp"),
         os.path.join(_SRC_DIR, "sptree.cpp"),
         os.path.join(_SRC_DIR, "csv.cpp"),
         os.path.join(_SRC_DIR, "tokenizer.cpp")]
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-march=native")
#: tried in order: OpenMP if the toolchain has it, else serial
FLAG_VARIANTS = (("-fopenmp",), ())
ABI_VERSION = 1

_lib = None
_build_failed = False
_load_lock = threading.Lock()

#: calls into the library by C function name
CALLS: Dict[str, int] = defaultdict(int)
_CALLS_LOCK = threading.Lock()

#: how the loaded library was obtained: path, flags, openmp, seconds
#: (0 when it was found built), abi
BUILD_INFO: Dict[str, object] = {}


def reset_calls():
    with _CALLS_LOCK:
        CALLS.clear()


def cache_dir() -> str:
    from deeplearning4j_tpu_torch.util.env import env_str
    d = env_str("DL4J_CUDA_NATIVE_CACHE",
                os.path.join(_REPO, "build", "native"))
    os.makedirs(d, exist_ok=True)
    return d


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _gxx_version() -> str:
    try:
        r = subprocess.run(["g++", "--version"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout


def build_key() -> str:
    """The hash of the sources, the flags, the compiler and the host CPU
    that names the library file."""
    h = hashlib.sha256()
    for path in _SRCS:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(repr((GXX_FLAGS, FLAG_VARIANTS)).encode())
    h.update(_gxx_version().encode())
    h.update(_cpu_model().encode())
    return h.hexdigest()[:16]


def _compile(so_path: str) -> Optional[Tuple[str, ...]]:
    """Builds the library at `so_path`; the flags it got, or None."""
    tmp = so_path + f".tmp{os.getpid()}"
    r = None
    for extra in FLAG_VARIANTS:
        cmd = ["g++", *GXX_FLAGS, *_SRCS, *extra, "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            log.warning("native build failed to run g++: %s", e)
            return None
        if r.returncode == 0:
            flags = GXX_FLAGS + extra
            side = f"{so_path}.json.tmp{os.getpid()}"
            with open(side, "w") as f:
                json.dump({"flags": list(flags)}, f)
            os.replace(side, so_path + ".json")
            os.replace(tmp, so_path)
            return flags
    log.warning("native build failed:\n%s", r.stderr.decode()[-1000:])
    return None


def _build():
    t0 = time.perf_counter()
    so_path = os.path.join(cache_dir(), f"dl4jtpu_native-{build_key()}.so")
    built = 0.0
    if os.path.exists(so_path):
        try:
            with open(so_path + ".json") as f:
                flags = tuple(json.load(f)["flags"])
        except (OSError, ValueError, KeyError):
            flags = ()
    else:
        flags = _compile(so_path)
        if flags is None:
            return None
        built = time.perf_counter() - t0
    lib = ctypes.CDLL(so_path)          # RTLD_LOCAL: never RTLD_GLOBAL
    _declare_core(lib)
    if lib.native_abi_version() != ABI_VERSION:
        log.warning("native ABI mismatch")
        return None
    _declare_ndarray_ops(lib)
    BUILD_INFO.clear()
    BUILD_INFO.update(path=so_path, flags=list(flags),
                      openmp="-fopenmp" in flags, seconds=built,
                      abi=ABI_VERSION)
    return _CountedLib(lib)


def _declare_core(lib: ctypes.CDLL) -> None:
    """ctypes prototypes of the codec and the skip-gram trainer
    (src/dl4jtpu_native.cpp)."""
    lib.threshold_encode_f32.restype = ctypes.c_int64
    lib.threshold_encode_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.decode_accumulate_f32.restype = None
    lib.decode_accumulate_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.sg_ns_train.restype = ctypes.c_double
    lib.sg_ns_train.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_int32]
    lib.native_abi_version.restype = ctypes.c_int32


def _declare_ndarray_ops(lib: ctypes.CDLL) -> None:
    """ctypes prototypes for the INDArray-contract host kernels
    (src/ndarray_ops.cpp, src/sptree.cpp, src/csv.cpp, src/tokenizer.cpp)."""
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    f32, u64 = ctypes.c_float, ctypes.c_uint64
    lib.dot_f32.restype = f32
    lib.dot_f32.argtypes = [f32p, f32p, i64]
    lib.axpy_f32.restype = None
    lib.axpy_f32.argtypes = [f32, f32p, f32p, i64]
    lib.nrm2_f32.restype = f32
    lib.nrm2_f32.argtypes = [f32p, i64]
    lib.gemm_f32.restype = None
    lib.gemm_f32.argtypes = [i32, i32, i64, i64, i64, f32, f32p, f32p,
                             f32, f32p]
    lib.transform_f32.restype = None
    lib.transform_f32.argtypes = [i32, f32p, i64, f32, f32p]
    lib.binary_f32.restype = None
    lib.binary_f32.argtypes = [i32, f32p, f32p, i64, f32p]
    lib.broadcast_row_f32.restype = None
    lib.broadcast_row_f32.argtypes = [i32, f32p, i64, i64, f32p, f32p]
    lib.reduce_f32.restype = None
    lib.reduce_f32.argtypes = [i32, f32p, i64, i64, i32, f32p]
    lib.im2col_f32.restype = None
    lib.im2col_f32.argtypes = [f32p] + [i64] * 9 + [f32p]
    lib.col2im_f32.restype = None
    lib.col2im_f32.argtypes = [f32p] + [i64] * 9 + [f32p]
    lib.random_uniform_f32.restype = None
    lib.random_uniform_f32.argtypes = [u64, i64, f32, f32, f32p]
    lib.random_gaussian_f32.restype = None
    lib.random_gaussian_f32.argtypes = [u64, i64, f32, f32, f32p]
    lib.pairwise_sqdist_f32.restype = None
    lib.pairwise_sqdist_f32.argtypes = [f32p, i64, f32p, i64, i64, f32p]
    lib.bh_repulsion_f32.restype = ctypes.c_double
    lib.bh_repulsion_f32.argtypes = [f32p, i64, i32, f32, f32p,
                                     ctypes.POINTER(i64)]
    lib.csv_parse_f32.restype = i64
    lib.csv_parse_f32.argtypes = [ctypes.c_char_p, i64, ctypes.c_char,
                                  i64, f32p, i64, ctypes.POINTER(i64)]
    lib.scale_u8_f32.restype = None
    lib.scale_u8_f32.argtypes = [u8p, i64, f32, f32, f32p]
    # batch tokenizer (src/tokenizer.cpp)
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(i32)
    lib.dl4j_vocab_create.restype = ctypes.c_void_p
    lib.dl4j_vocab_create.argtypes = [ctypes.c_char_p, i64p, i64]
    lib.dl4j_vocab_free.restype = None
    lib.dl4j_vocab_free.argtypes = [ctypes.c_void_p]
    lib.dl4j_tokenize_encode.restype = i64
    lib.dl4j_tokenize_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, i32, i32,
        i32p, i64, i64p, i64, i64p]
    lib.dl4j_count_tokens.restype = ctypes.c_void_p
    lib.dl4j_count_tokens.argtypes = [ctypes.c_char_p, i64, i32]
    lib.dl4j_counts_size.restype = i64
    lib.dl4j_counts_size.argtypes = [ctypes.c_void_p]
    lib.dl4j_counts_blob_len.restype = i64
    lib.dl4j_counts_blob_len.argtypes = [ctypes.c_void_p]
    lib.dl4j_counts_export.restype = None
    lib.dl4j_counts_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       i64p, i64p]
    lib.dl4j_counts_free.restype = None
    lib.dl4j_counts_free.argtypes = [ctypes.c_void_p]


class _CountedLib:
    """The loaded library; each call of one of its C functions adds one to
    `CALLS[name]`."""

    def __init__(self, lib: ctypes.CDLL):
        self.cdll = lib

    def __getattr__(self, name: str):
        fn = getattr(self.cdll, name)

        def call(*args):
            with _CALLS_LOCK:
                CALLS[name] += 1
            return fn(*args)

        call.__name__ = name
        setattr(self, name, call)
        return call


def get_lib():
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        with _load_lock:
            if _lib is None and not _build_failed:
                _lib = _build()
                if _lib is None:
                    _build_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native backend unavailable: the g++ build failed or no "
            "toolchain is present (check the 'native build failed' log); "
            "use the torch/device backends instead")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def threshold_encode(grad: np.ndarray, threshold: float, cap: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host codec: exact-magnitude sparse encode. Returns (idx int32[m],
    vals f32[m], residual f32 like grad) with m <= cap: the native twin of
    encoding.threshold_encode_values (no -1 padding: host buffers are
    dynamic)."""
    lib = _require_lib()
    g = np.ascontiguousarray(np.asarray(grad, np.float32).reshape(-1))
    n = g.size
    cap = int(min(max(cap, 0), n))
    idx = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float32)
    residual = np.empty(n, np.float32)
    m = lib.threshold_encode_f32(_fptr(g), n, ctypes.c_float(threshold),
                                 cap, _i32ptr(idx), _fptr(vals),
                                 _fptr(residual))
    return idx[:m].copy(), vals[:m].copy(), residual.reshape(np.shape(grad))


def decode_accumulate(dense: np.ndarray, idx: np.ndarray,
                      vals: np.ndarray) -> np.ndarray:
    lib = _require_lib()
    d = np.ascontiguousarray(np.asarray(dense, np.float32))
    lib.decode_accumulate_f32(
        _fptr(d), d.size, _i32ptr(np.ascontiguousarray(idx, np.int32)),
        _fptr(np.ascontiguousarray(vals, np.float32)), int(len(idx)))
    return d


def sg_ns_train(syn0: np.ndarray, syn1neg: np.ndarray, corpus: np.ndarray,
                offsets: np.ndarray, window: int, negative: int,
                table: np.ndarray, lr_start: float, lr_min: float,
                total_words: int, seed: int = 0,
                n_threads: int = 0) -> float:
    """HogWild skip-gram/negative-sampling epoch IN PLACE on syn0/syn1neg.
    Returns the mean pair loss (AggregateSkipGram analog)."""
    lib = _require_lib()
    for name, a in (("syn0", syn0), ("syn1neg", syn1neg)):
        if not (isinstance(a, np.ndarray) and a.dtype == np.float32
                and a.flags["C_CONTIGUOUS"]):
            # a silent ascontiguousarray copy would discard the in-place
            # updates: demand the right layout instead
            raise ValueError(f"{name} must be C-contiguous float32")
    corpus = np.ascontiguousarray(corpus, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    table = np.ascontiguousarray(table, np.int32)
    # the C side's omp_set_num_threads(n_threads) sets the calling
    # thread's OpenMP thread count for every later parallel region of
    # this runtime (the native library's, and torch's where they share
    # libgomp): put it back after the epoch
    get_max = getattr(lib.cdll, "omp_get_max_threads", None)
    before = get_max() if get_max is not None else None
    try:
        loss = lib.sg_ns_train(
            _fptr(syn0), _fptr(syn1neg), syn0.shape[0], syn0.shape[1],
            _i32ptr(corpus),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offsets) - 1, window, negative, _i32ptr(table), table.size,
            ctypes.c_float(lr_start), ctypes.c_float(lr_min),
            int(total_words), ctypes.c_uint64(seed), int(n_threads))
    finally:
        if before is not None:
            lib.cdll.omp_set_num_threads(before)
    return float(loss)


def sg_ns_train_plain(syn0: np.ndarray, syn1neg: np.ndarray,
                      corpus: np.ndarray, offsets: np.ndarray, window: int,
                      negative: int, table: np.ndarray, lr_start: float,
                      lr_min: float, total_words: int,
                      seed: int = 0) -> float:
    """The plain version of `sg_ns_train` at one thread, for checking the
    kernel on small inputs: the same random stream, windows, negatives
    and updates in the same order, in float64 numpy, IN PLACE on the
    given (float64) tables. Returns the mean pair loss."""
    mask = (1 << 64) - 1
    rng = (seed + 0x9E3779B97F4A7C15) & mask
    dim = syn0.shape[1]
    seen, loss, pairs = 0, 0.0, 0
    for s in range(len(offsets) - 1):
        beg, end = int(offsets[s]), int(offsets[s + 1])
        for pos in range(beg, end):
            frac = seen / total_words if total_words > 0 else 0.0
            seen += 1
            lr = max(lr_start * (1.0 - frac), lr_min)
            center = int(corpus[pos])
            rng = (rng * 6364136223846793005 + 1442695040888963407) & mask
            b = rng % window
            for j in range(pos - window + b, pos + window - b + 1):
                if j == pos or j < beg or j >= end:
                    continue
                v_in = syn0[int(corpus[j])]
                neu1e = np.zeros(dim)
                for k in range(negative + 1):
                    if k == 0:
                        target, label = center, 1.0
                    else:
                        rng = (rng * 6364136223846793005
                               + 1442695040888963407) & mask
                        target = int(table[rng % len(table)])
                        if target == center:
                            continue
                        label = 0.0
                    v_out = syn1neg[target]
                    f = float(v_in @ v_out)
                    p = 1.0 if f > 8 else 0.0 if f < -8 \
                        else 1.0 / (1.0 + np.exp(-f))
                    g = (label - p) * lr
                    loss += -np.log(max(p, 1e-7)) if label > 0.5 \
                        else -np.log(max(1.0 - p, 1e-7))
                    neu1e += g * v_out
                    v_out += g * v_in
                v_in += neu1e
                pairs += 1
    return loss / (pairs * (negative + 1)) if pairs else 0.0
