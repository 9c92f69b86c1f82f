"""Quantized gradient encoding (threshold + bitmap).

Counterpart of the JAX package's `parallel/encoding.py`: ND4J's
compression ops as DL4J's data-parallel paths use them
(`EncodingHandler.java:136-178`), with the adaptive threshold and the
residual ("left-overs") kept inside the encoder. Plain torch ops on the
gradient's own device, with the reference's static `max_elements` cap:
the same inputs give bitwise the reference's messages and residuals (the
selection is a stable descending sort, which breaks ties by index as
`lax.top_k` does).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


def _cap(n: int, max_elements: Optional[int]) -> int:
    if max_elements is None:
        # 1/16 density cap: beyond that the reference switches to bitmap
        # encoding anyway (EncodingHandler bitmap branch)
        max_elements = max(16, n // 16)
    return min(max_elements, n)


def _select(flat: torch.Tensor, threshold: float, max_elements: int):
    """(indices of the top-|max_elements| |values| over the threshold,
    validity): the reference's `lax.top_k` of ``where(|g| >= thr, |g|,
    -1)``."""
    mag = flat.abs()
    score = torch.where(mag >= threshold, mag, torch.full_like(mag, -1.0))
    _, order = torch.sort(score, descending=True, stable=True)
    idx = order[:max_elements]
    return idx, score[idx] > 0


def _residual(flat, idx, valid, values, shape):
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    delta = torch.zeros_like(flat).index_add_(
        0, safe, torch.where(valid, values, torch.zeros_like(values)))
    return (flat - delta).reshape(shape)


def threshold_encode(grad: torch.Tensor, threshold: float,
                     max_elements: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse sign encoding: elements with |g| >= threshold are sent as
    +-threshold; the remainder stays in the residual. Returns (indices
    int64, -1-padded to `max_elements`; signs int8; residual)."""
    flat = grad.reshape(-1)
    cap = _cap(flat.numel(), max_elements)
    idx, valid = _select(flat, threshold, cap)
    sign = torch.sign(flat[idx])
    indices = torch.where(valid, idx, torch.full_like(idx, -1))
    signs = torch.where(valid, sign, torch.zeros_like(sign))
    residual = _residual(flat, idx, valid, sign * threshold, grad.shape)
    return indices, signs.to(torch.int8), residual


def threshold_encode_scaled(grad: torch.Tensor, threshold: float,
                            max_elements: Optional[int] = None):
    """Like `threshold_encode`, but the scalar sent is the mean |value| of
    the selected elements. Returns (indices, signs, scale, residual)."""
    flat = grad.reshape(-1)
    cap = _cap(flat.numel(), max_elements)
    idx, valid = _select(flat, threshold, cap)
    picked = flat[idx]
    nsent = valid.sum().clamp_min(1)
    scale = torch.where(valid, picked.abs(),
                        torch.zeros_like(picked)).sum() / nsent
    sign = torch.sign(picked)
    indices = torch.where(valid, idx, torch.full_like(idx, -1))
    signs = torch.where(valid, sign, torch.zeros_like(sign))
    residual = _residual(flat, idx, valid, sign * scale, grad.shape)
    return indices, signs.to(torch.int8), scale, residual


def threshold_encode_values(grad: torch.Tensor, threshold: float,
                            max_elements: Optional[int] = None):
    """Sparse encoding with exact magnitudes: the top-|max_elements|
    values with |g| >= threshold are sent verbatim. Returns (indices,
    values f32, residual)."""
    flat = grad.reshape(-1)
    cap = _cap(flat.numel(), max_elements)
    idx, valid = _select(flat, threshold, cap)
    picked = flat[idx]
    indices = torch.where(valid, idx, torch.full_like(idx, -1))
    values = torch.where(valid, picked,
                         torch.zeros_like(picked)).to(torch.float32)
    residual = _residual(flat, idx, valid, values.to(flat.dtype),
                         grad.shape)
    return indices, values, residual


def values_decode(indices, values, shape) -> torch.Tensor:
    """The dense update of an exact-magnitude sparse encoding, on the
    indices' device."""
    indices = torch.as_tensor(indices).to(torch.int64)
    values = torch.as_tensor(values, device=indices.device)
    valid = indices >= 0
    flat = torch.zeros((math.prod(shape),), dtype=torch.float32,
                       device=indices.device)
    flat.index_add_(0, torch.where(valid, indices, torch.zeros_like(indices)),
                    torch.where(valid, values.to(torch.float32),
                                torch.zeros((), device=indices.device)))
    return flat.reshape(shape)


def threshold_decode(indices, signs, threshold: float,
                     shape) -> torch.Tensor:
    """The dense update of a sign encoding, on the indices' device."""
    indices = torch.as_tensor(indices).to(torch.int64)
    signs = torch.as_tensor(signs, device=indices.device)
    valid = indices >= 0
    flat = torch.zeros((math.prod(shape),), dtype=torch.float32,
                       device=indices.device)
    vals = signs.to(torch.float32) * torch.as_tensor(
        threshold, dtype=torch.float32, device=indices.device)
    flat.index_add_(0, torch.where(valid, indices, torch.zeros_like(indices)),
                    torch.where(valid, vals, torch.zeros_like(vals)))
    return flat.reshape(shape)


def bitmap_encode(grad: torch.Tensor, threshold: float):
    """Dense 2-bit encoding: per element {0: below, 1: +thr, 2: -thr},
    packed 16 per 32-bit word (ND4J bitmapEncode). Returns (packed int64
    words holding uint32 values, residual)."""
    flat = grad.reshape(-1)
    n = flat.numel()
    pad = (-n) % 16
    codes = torch.where(flat >= threshold, 1,
                        torch.where(flat <= -threshold, 2, 0)).to(torch.int64)
    codes = torch.cat([codes, torch.zeros(pad, dtype=torch.int64,
                                          device=flat.device)])
    shifts = torch.arange(16, dtype=torch.int64, device=flat.device) * 2
    packed = (codes.reshape(-1, 16) << shifts).sum(dim=1)
    residual = torch.where(flat.abs() >= threshold,
                           flat - torch.sign(flat) * threshold, flat)
    return packed, residual.reshape(grad.shape)


def bitmap_decode(packed, threshold: float, shape) -> torch.Tensor:
    """The dense update of a bitmap encoding, on `packed`'s device."""
    if not isinstance(packed, torch.Tensor):
        packed = torch.from_numpy(np.asarray(packed).astype(np.int64))
    packed = packed.to(torch.int64)
    n = math.prod(shape)
    shifts = torch.arange(16, dtype=torch.int64, device=packed.device) * 2
    codes = ((packed[:, None] >> shifts) & 3).reshape(-1)[:n]
    thr = torch.tensor(threshold, dtype=torch.float32, device=packed.device)
    vals = torch.where(codes == 1, thr,
                       torch.where(codes == 2, -thr, torch.zeros_like(thr)))
    return vals.reshape(shape)


@dataclasses.dataclass
class EncodingHandler:
    """Adaptive-threshold gradient encoder with residual accumulation
    (DL4J EncodingHandler): initial threshold, adaptation toward a
    target density band (`boundary`), residual carry between steps."""
    threshold: float = 1e-3
    min_threshold: float = 1e-5
    boundary: float = 0.02          # target fraction of elements sent
    decay: float = 0.98
    # "values": exact magnitudes (8 B/element); "sign": sign x scale
    mode: str = "values"
    # hard cap on the sent density; defaults to 4x the target band
    max_density: Optional[float] = None
    # "torch": encode with torch ops on the gradient's device; "native":
    # the C++ host codec (deeplearning4j_tpu_torch.native, the twin of
    # ND4J's native thresholdEncode), for a gradient that is on the host
    # already (a model on the CPU). values mode only.
    backend: str = "torch"

    def __post_init__(self):
        if self.backend not in ("torch", "native"):
            raise ValueError(f"backend must be 'torch' or 'native', got "
                             f"{self.backend!r}")
        self._residual = None
        self.iterations = 0
        self.last_sparsity = 0.0

    def encode(self, grad):
        """(indices, payload, scale) of the gradient plus the carried
        residual. `scale` is the one this gradient was encoded with;
        threshold adaptation only affects the next call. The native
        backend copies a device gradient to the host once, keeps the
        residual there, and returns host tensors of the sent elements
        only (no -1 padding)."""
        native = self.mode == "values" and self.backend == "native"
        g = torch.as_tensor(grad).to(torch.float32)
        if native:
            g = g.cpu()
        if self._residual is not None:
            g = g + self._residual
        used_threshold = self.threshold
        density_cap = (self.boundary * 4 if self.max_density is None
                       else self.max_density)
        cap = max(16, int(g.numel() * min(1.0, density_cap)))
        if native:
            from deeplearning4j_tpu_torch import native as host
            idx, payload, residual = (torch.from_numpy(a) for a in
                                      host.threshold_encode(g.numpy(),
                                                            used_threshold,
                                                            cap))
            scale = used_threshold
            sent = float(len(idx))
        elif self.mode == "values":
            idx, payload, residual = threshold_encode_values(
                g, used_threshold, cap)
            scale = used_threshold
            sent = float((idx >= 0).sum())
        else:
            idx, payload, scale, residual = threshold_encode_scaled(
                g, used_threshold, cap)
            sent = float((idx >= 0).sum())
        self._residual = residual
        self.iterations += 1
        self.last_sparsity = sent / g.numel()
        # outside the target band: jump straight to the magnitude
        # quantile that yields `boundary` density (the reference's rule)
        if (self.last_sparsity > self.boundary
                or self.last_sparsity < self.boundary / 4):
            q = _quantile(g.reshape(-1).abs(), 1.0 - min(1.0, self.boundary))
            self.threshold = max(self.min_threshold, q)
        return idx, payload, scale

    def decode(self, idx, payload, scale, shape):
        if self.mode == "values":
            return values_decode(idx, payload, shape)
        return threshold_decode(idx, payload, scale, shape)

    def reset(self):
        self._residual = None
        self.iterations = 0


def _quantile(a: torch.Tensor, q: float) -> float:
    """`jnp.quantile(a, q)` (linear interpolation) in f32, on `a`'s
    device."""
    s, _ = torch.sort(a.reshape(-1).to(torch.float32))
    pos = float(np.float32(q) * np.float32(s.numel() - 1))
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    frac = torch.tensor(np.float32(pos - np.float32(lo)), device=s.device)
    return float(s[lo] * (1 - frac) + s[hi] * frac)
