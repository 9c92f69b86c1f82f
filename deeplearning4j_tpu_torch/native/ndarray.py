"""HostNDArray: the INDArray op contract on host buffers, C++-backed.

The port's copy of the JAX package's `native/ndarray.py`. The reference
consumes an op surface from its native tensor layer (INDArray, the Nd4j
factory, Transforms, gemm at LSTMHelpers.java:212/522/616, im2col at
ConvolutionLayer.java:215). On the card the device half of that contract
is PyTorch; this module is the host half, the `nd4j-native` analog used
by host-side subsystems (clustering distance kernels, dataset ETL, codec
paths) and a toolchain-free numpy fallback when g++ is unavailable.

Every op dispatches to src/ndarray_ops.cpp via ctypes when
`native.available()`, else to the numpy twin, with the same results
either way (the tests assert backend equivalence).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np

from . import available, get_lib

_TRANSFORM = {"exp": 0, "log": 1, "tanh": 2, "sigmoid": 3, "relu": 4,
              "sqrt": 5, "abs": 6, "neg": 7, "square": 8, "add_scalar": 9,
              "mul_scalar": 10, "pow_scalar": 11, "clip_min": 12,
              "clip_max": 13, "sign": 14, "reciprocal": 15}
_BINARY = {"add": 0, "sub": 1, "mul": 2, "div": 3, "max": 4, "min": 5}
_REDUCE = {"sum": 0, "mean": 1, "max": 2, "min": 3, "argmax": 4,
           "norm2": 5}


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HostNDArray:
    """A host f32 tensor carrying the INDArray-style fluent op surface."""

    __array_priority__ = 100    # our __r*__ ops win over np scalars/arrays

    def __init__(self, data):
        self.data = _f32(data.data if isinstance(data, HostNDArray)
                         else data)

    # ---- factory (Nd4j.* analogs) ------------------------------------
    @staticmethod
    def zeros(*shape: int) -> "HostNDArray":
        return HostNDArray(np.zeros(shape, np.float32))

    @staticmethod
    def ones(*shape: int) -> "HostNDArray":
        return HostNDArray(np.ones(shape, np.float32))

    @staticmethod
    def rand(*shape: int, seed: int = 0, lo: float = 0.0,
             hi: float = 1.0) -> "HostNDArray":
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, np.float32)
        if available():
            get_lib().random_uniform_f32(
                ctypes.c_uint64(seed), n, ctypes.c_float(lo),
                ctypes.c_float(hi), _ptr(out))
        else:
            out[:] = np.random.RandomState(seed & 0x7FFFFFFF).uniform(
                lo, hi, n).astype(np.float32)
        return HostNDArray(out.reshape(shape))

    @staticmethod
    def randn(*shape: int, seed: int = 0, mean: float = 0.0,
              std: float = 1.0) -> "HostNDArray":
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, np.float32)
        if available():
            get_lib().random_gaussian_f32(
                ctypes.c_uint64(seed), n, ctypes.c_float(mean),
                ctypes.c_float(std), _ptr(out))
        else:
            out[:] = np.random.RandomState(seed & 0x7FFFFFFF).normal(
                mean, std, n).astype(np.float32)
        return HostNDArray(out.reshape(shape))

    # ---- shape ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def reshape(self, *shape: int) -> "HostNDArray":
        return HostNDArray(self.data.reshape(shape))

    def transpose(self) -> "HostNDArray":
        return HostNDArray(np.ascontiguousarray(self.data.T))

    def ravel(self) -> "HostNDArray":
        return HostNDArray(self.data.reshape(-1))

    def numpy(self) -> np.ndarray:
        return self.data

    def __repr__(self) -> str:
        return f"HostNDArray{self.shape}\n{self.data!r}"

    # ---- BLAS -------------------------------------------------------
    def mmul(self, other: "HostNDArray", transpose_a: bool = False,
             transpose_b: bool = False, alpha: float = 1.0) -> "HostNDArray":
        """gemm: op(self) @ op(other) (Nd4j.gemm,
        LSTMHelpers.java:212)."""
        a, b = self.data, _as_np(other)
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError("mmul expects rank-2 operands")
        m = a.shape[1] if transpose_a else a.shape[0]
        ka = a.shape[0] if transpose_a else a.shape[1]
        kb = b.shape[1] if transpose_b else b.shape[0]
        n = b.shape[0] if transpose_b else b.shape[1]
        if ka != kb:
            raise ValueError(f"mmul shape mismatch: {a.shape} x {b.shape}")
        if available():
            out = np.zeros((m, n), np.float32)
            get_lib().gemm_f32(int(transpose_a), int(transpose_b), m, n,
                               ka, ctypes.c_float(alpha), _ptr(a), _ptr(b),
                               ctypes.c_float(0.0), _ptr(out))
        else:
            out = alpha * ((a.T if transpose_a else a)
                           @ (b.T if transpose_b else b))
        return HostNDArray(out)

    def dot(self, other: "HostNDArray") -> float:
        a, b = self.data.reshape(-1), _as_np(other).reshape(-1)
        if a.size != b.size:
            raise ValueError(f"dot length mismatch: {a.size} vs {b.size}")
        if available():
            return float(get_lib().dot_f32(_ptr(a), _ptr(b), a.size))
        return float(a @ b)

    def norm2(self) -> float:
        a = self.data.reshape(-1)
        if available():
            return float(get_lib().nrm2_f32(_ptr(a), a.size))
        return float(np.linalg.norm(a))

    def axpy(self, alpha: float, y: "HostNDArray") -> "HostNDArray":
        """y += alpha * self, in place on y's buffer."""
        a, yd = self.data.reshape(-1), _as_np(y).reshape(-1)
        if a.size != yd.size:
            raise ValueError(
                f"axpy length mismatch: {a.size} vs {yd.size}")
        if available():
            get_lib().axpy_f32(ctypes.c_float(alpha), _ptr(a), _ptr(yd),
                               a.size)
        else:
            yd += alpha * a
        return y if isinstance(y, HostNDArray) else HostNDArray(yd)

    # ---- elementwise transforms (Transforms.* analogs) ---------------
    def _transform(self, name: str, arg: float = 0.0) -> "HostNDArray":
        x = self.data.reshape(-1)
        if available():
            out = np.empty_like(x)
            get_lib().transform_f32(_TRANSFORM[name], _ptr(x), x.size,
                                    ctypes.c_float(arg), _ptr(out))
        else:
            out = _np_transform(name, x, arg)
        return HostNDArray(out.reshape(self.shape))

    def exp(self): return self._transform("exp")
    def log(self): return self._transform("log")
    def tanh(self): return self._transform("tanh")
    def sigmoid(self): return self._transform("sigmoid")
    def relu(self): return self._transform("relu")
    def sqrt(self): return self._transform("sqrt")
    def abs(self): return self._transform("abs")
    def square(self): return self._transform("square")
    def sign(self): return self._transform("sign")
    def reciprocal(self): return self._transform("reciprocal")

    def clip(self, lo: float, hi: float) -> "HostNDArray":
        return self._transform("clip_min", lo)._transform("clip_max", hi)

    # ---- arithmetic ---------------------------------------------------
    def _binary(self, name: str, other) -> "HostNDArray":
        if np.isscalar(other):
            if name == "add":
                return self._transform("add_scalar", float(other))
            if name == "mul":
                return self._transform("mul_scalar", float(other))
            if name == "sub":
                return self._transform("add_scalar", -float(other))
            if name == "div":
                with np.errstate(divide="ignore"):  # 0 → ±inf, as elementwise
                    inv = float(np.float64(1.0) / np.float64(other))
                return self._transform("mul_scalar", inv)
            other = np.full_like(self.data, other)
        b = _as_np(other)
        if b.shape == self.shape:
            x = self.data.reshape(-1)
            bf = b.reshape(-1)
            if available():
                out = np.empty_like(x)
                get_lib().binary_f32(_BINARY[name], _ptr(x), _ptr(bf),
                                     x.size, _ptr(out))
            else:
                out = _np_binary(name, x, bf)
            return HostNDArray(out.reshape(self.shape))
        # row-vector broadcast (addiRowVector family)
        if self.data.ndim >= 1 and b.ndim == 1 \
                and self.shape[-1] == b.shape[0]:
            return self.broadcast_row(name, b)
        return HostNDArray(_np_binary(name, self.data, b))

    def broadcast_row(self, name: str, vec) -> "HostNDArray":
        v = _as_np(vec).reshape(-1)
        rows = int(np.prod(self.shape[:-1])) if self.data.ndim > 1 else 1
        cols = self.shape[-1]
        x = self.data.reshape(rows, cols)
        if available():
            out = np.empty_like(x)
            get_lib().broadcast_row_f32(_BINARY[name], _ptr(x), rows, cols,
                                        _ptr(v), _ptr(out))
        else:
            out = _np_binary(name, x, v[None, :])
        return HostNDArray(out.reshape(self.shape))

    def __add__(self, o): return self._binary("add", o)
    def __radd__(self, o): return self._binary("add", o)
    def __sub__(self, o): return self._binary("sub", o)
    def __rsub__(self, o): return self.__neg__()._binary("add", o)
    def __mul__(self, o): return self._binary("mul", o)
    def __rmul__(self, o): return self._binary("mul", o)
    def __truediv__(self, o): return self._binary("div", o)
    def __rtruediv__(self, o):
        num = np.full_like(self.data, o) if np.isscalar(o) else _as_np(o)
        return HostNDArray(num)._binary("div", self)
    def __neg__(self): return self._transform("neg")

    def maximum(self, o): return self._binary("max", o)
    def minimum(self, o): return self._binary("min", o)

    # ---- reductions ----------------------------------------------------
    def _reduce(self, name: str, axis: Optional[int]) \
            -> Union[float, "HostNDArray"]:
        if axis is None:
            if name == "argmax" and self.data.size == 0:
                raise ValueError("argmax of an empty array")
            flat = self.data.reshape(1, -1)
            out = np.empty(1, np.float32)
            if available():
                get_lib().reduce_f32(_REDUCE[name], _ptr(flat), 1,
                                     flat.shape[1], 1, _ptr(out))
            else:
                out[0] = _np_reduce(name, flat[0])
            return float(out[0])
        if self.data.ndim != 2:
            raise ValueError("axis reductions expect rank 2 (reshape first)")
        if axis == -1:
            axis = 1
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0, 1 or -1, got {axis}")
        rows, cols = self.shape
        if name == "argmax" and (cols if axis == 1 else rows) == 0:
            raise ValueError("argmax of an empty array")
        out = np.empty(rows if axis == 1 else cols, np.float32)
        if available():
            get_lib().reduce_f32(_REDUCE[name], _ptr(self.data), rows,
                                 cols, axis, _ptr(out))
        else:
            out[:] = _np_reduce(name, self.data, axis)
        return HostNDArray(out)

    def sum(self, axis=None): return self._reduce("sum", axis)
    def mean(self, axis=None): return self._reduce("mean", axis)
    def max(self, axis=None): return self._reduce("max", axis)
    def min(self, axis=None): return self._reduce("min", axis)

    def argmax(self, axis=1) -> np.ndarray:
        r = self._reduce("argmax", axis)
        if isinstance(r, HostNDArray):
            return r.data.astype(np.int64)
        return np.int64(r)


def _as_np(x) -> np.ndarray:
    return x.data if isinstance(x, HostNDArray) else _f32(x)


def _np_transform(name: str, x: np.ndarray, arg: float) -> np.ndarray:
    f = {"exp": np.exp, "log": np.log, "tanh": np.tanh,
         "sigmoid": lambda v: 1.0 / (1.0 + np.exp(-v)),
         "relu": lambda v: np.maximum(v, 0), "sqrt": np.sqrt,
         "abs": np.abs, "neg": np.negative, "square": np.square,
         "add_scalar": lambda v: v + arg, "mul_scalar": lambda v: v * arg,
         "pow_scalar": lambda v: np.power(v, arg),
         "clip_min": lambda v: np.maximum(v, arg),
         "clip_max": lambda v: np.minimum(v, arg), "sign": np.sign,
         "reciprocal": lambda v: 1.0 / v}[name]
    return f(x).astype(np.float32)


def _np_binary(name: str, a, b) -> np.ndarray:
    f = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
         "div": np.divide, "max": np.maximum, "min": np.minimum}[name]
    return f(a, b).astype(np.float32)


def _np_reduce(name: str, x: np.ndarray, axis=None):
    reduced = x.shape[axis] if axis is not None and x.ndim > 1 else x.size
    if reduced == 0:    # match native: sum of empty = 0, rest = NaN
        shape = () if axis is None or x.ndim <= 1 else \
            (x.shape[1 - axis],)
        return np.full(shape, 0.0 if name == "sum" else np.nan, np.float32)
    f = {"sum": np.sum, "mean": np.mean, "max": np.max, "min": np.min,
         "argmax": np.argmax, "norm2": lambda v, axis=None:
         np.sqrt(np.sum(np.square(v), axis=axis))}[name]
    return np.asarray(f(x, axis=axis) if x.ndim > 1 else f(x),
                      np.float32)


# ---- free functions on raw numpy (hot paths for other subsystems) -----

def im2col(img: np.ndarray, kh: int, kw: int, sh: int = 1, sw: int = 1,
           ph: int = 0, pw: int = 0) -> np.ndarray:
    """NCHW im2col ([C,H,W] → [C*kh*kw, oh*ow]); the
    ConvolutionLayer.java:215 host contract."""
    img = _f32(img)
    C, H, W = img.shape
    oh = (H + 2 * ph - kh) // sh + 1
    ow = (W + 2 * pw - kw) // sw + 1
    out = np.empty((C * kh * kw, oh * ow), np.float32)
    if available():
        get_lib().im2col_f32(_ptr(img), C, H, W, kh, kw, sh, sw, ph, pw,
                             _ptr(out))
        return out
    padded = np.pad(img, ((0, 0), (ph, ph), (pw, pw)))
    k = 0
    for c in range(C):
        for ki in range(kh):
            for kj in range(kw):
                out[k] = padded[c, ki:ki + oh * sh:sh,
                                kj:kj + ow * sw:sw].reshape(-1)
                k += 1
    return out


def col2im(cols: np.ndarray, C: int, H: int, W: int, kh: int, kw: int,
           sh: int = 1, sw: int = 1, ph: int = 0, pw: int = 0
           ) -> np.ndarray:
    """Adjoint of im2col (gradient scatter-add back to the image)."""
    cols = _f32(cols)
    out = np.zeros((C, H, W), np.float32)
    if available():
        get_lib().col2im_f32(_ptr(cols), C, H, W, kh, kw, sh, sw, ph, pw,
                             _ptr(out))
        return out
    oh = (H + 2 * ph - kh) // sh + 1
    ow = (W + 2 * pw - kw) // sw + 1
    padded = np.zeros((C, H + 2 * ph, W + 2 * pw), np.float32)
    k = 0
    for c in range(C):
        for ki in range(kh):
            for kj in range(kw):
                padded[c, ki:ki + oh * sh:sh, kj:kj + ow * sw:sw] += \
                    cols[k].reshape(oh, ow)
                k += 1
    return padded[:, ph:H + ph, pw:W + pw]


def pairwise_sqdist(X: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """||X[i]-Q[j]||² for all pairs — the clustering/KNN host hot loop."""
    X, Q = _f32(X), _f32(Q)
    n, d = X.shape
    m = Q.shape[0]
    if available():
        out = np.empty((n, m), np.float32)
        get_lib().pairwise_sqdist_f32(_ptr(X), n, _ptr(Q), m, d, _ptr(out))
        return out
    # the expansion can round slightly negative for x≈q; clamp so callers
    # that feed these into probabilities/sqrt stay well-defined
    return np.maximum(np.sum(X * X, 1)[:, None] - 2.0 * (X @ Q.T)
                      + np.sum(Q * Q, 1)[None, :], 0.0).astype(np.float32)


def scale_u8(src: np.ndarray, scale: float, shift: float = 0.0
             ) -> np.ndarray:
    """u8 → f32 * scale + shift: byte-image ETL (fetcher normalization)."""
    src = np.ascontiguousarray(src, np.uint8)
    if available():
        out = np.empty(src.shape, np.float32)
        get_lib().scale_u8_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
            ctypes.c_float(scale), ctypes.c_float(shift),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    return src.astype(np.float32) * scale + shift
