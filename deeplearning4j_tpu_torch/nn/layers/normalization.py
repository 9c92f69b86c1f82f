"""Normalization layers.

Counterpart of the JAX package's `nn/layers/normalization.py`:

- BatchNormalization: the running statistics live in the layer's state
  ({"mean", "var"}, f32, saved in `state.npz`). In training the batch is
  normalized by its own mean and *biased* variance, and the state moves
  as ``decay * old + (1 - decay) * batch`` with the biased variance, as
  the reference's `jnp.var`. The statistics are taken in f32 (or wider)
  whatever x's dtype, and the output has x's dtype.
- LocalResponseNormalization: cross-channel LRN over the last axis.

The training normalize is `torch.native_batch_norm` with no running
buffers: one pass that also returns the batch mean and 1/σ, from which
the state update is made (PyTorch's own running-buffer update would use
the unbiased variance, so it is never given the state). It runs the
normalize in f32 arithmetic and rounds once to x's dtype; the reference
rounds the mean and 1/σ to x's dtype first, so under bf16 the two differ
by bf16 rounding. Inference runs the reference's formula as it is.
"""
from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, register_layer,
)


def _channels_second(x):
    """(B, ..., C) -> a (B, C, ...) view: for a contiguous NHWC tensor, a
    channels_last NCHW one, so no copy is made."""
    return x if x.ndim == 2 else x.movedim(-1, 1)


def _channels_last(y):
    return y if y.ndim == 2 else y.movedim(1, -1)


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(LayerConf):
    epsilon: float = 1e-5
    decay: float = 0.9          # running-stat EMA decay (DL4J `decay`)
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False   # DL4J lockGammaBeta: fixed scale/shift

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        c = input_type.features
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((c,), float(self.gamma_init),
                                          dtype=dtype),
                      "beta": torch.full((c,), float(self.beta_init),
                                         dtype=dtype)}
        state = {"mean": torch.zeros((c,), dtype=torch.float32),
                 "var": torch.ones((c,), dtype=torch.float32)}
        return params, state

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        if train:
            return self._train_forward(params, state, x)
        inv = torch.rsqrt(state["var"] + self.epsilon)
        y = (x - state["mean"].to(x.dtype)) * inv.to(x.dtype)
        if not self.lock_gamma_beta:
            return y * params["gamma"] + params["beta"], state
        return y * self.gamma_init + self.beta_init, state

    def _train_forward(self, params, state, x):
        stat_t = torch.promote_types(torch.float32, x.dtype)
        xs = _channels_second(x)
        if stat_t != x.dtype and xs.device.type == "cpu":
            # the CPU kernel wants one dtype: normalize in f32, round once
            xs = xs.to(stat_t)
        gamma = beta = None
        if not self.lock_gamma_beta:
            gamma, beta = params["gamma"], params["beta"]
            if xs.device.type == "cpu":
                gamma, beta = gamma.to(xs.dtype), beta.to(xs.dtype)
        y, mean, invstd = torch.native_batch_norm(
            xs, gamma, beta, None, None, True, 0.0, self.epsilon)
        y = _channels_last(y).to(x.dtype)
        if self.lock_gamma_beta:
            y = y * self.gamma_init + self.beta_init
        with torch.no_grad():
            mean = mean.to(stat_t)
            var = invstd.to(stat_t).pow(-2) - self.epsilon
            new_state = {
                "mean": self.decay * state["mean"] + (1.0 - self.decay) * mean,
                "var": self.decay * state["var"] + (1.0 - self.decay) * var,
            }
        return y, new_state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(LayerConf):
    """Cross-channel LRN: y = x / (k + alpha * sum(x^2 over n channels))^beta,
    the window centred on each channel (NHWC last axis)."""
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        half = self.n // 2
        sq = torch.nn.functional.pad(x * x, (half, self.n - 1 - half))
        summed = sq.unfold(-1, self.n, 1).sum(-1)
        return x / (self.k + self.alpha * summed) ** self.beta, state
