"""Convolution layer family — NHWC activations, HWIO kernels.

Counterpart of the JAX package's `nn/layers/convolution.py`, every class
with the reference's fields and math. The reference lowers each layer to
one XLA op; the port hands them to PyTorch (cuDNN on the card), keeping
the reference's layouts at every boundary:

- Activations stay NHWC-contiguous between layers. ``x.permute(0, 3, 1,
  2)`` of such a tensor is already a channels_last NCHW tensor, so
  `F.conv2d` and the pooling ops take it without a copy, and their
  channels_last output permutes back to NHWC-contiguous.
- Kernels stay HWIO in the parameter dict (so checkpoint key paths,
  `updaterState.bin` and `params_from_numpy` need no transposes); a conv
  is handed ``W.permute(3, 2, 0, 1)``, the OIHW view.
- XLA's "SAME" padding is asymmetric: ``total = max((ceil(n/s) - 1)·s +
  (k - 1)·d + 1 - n, 0)``, ``lo = total // 2``, ``hi = total - lo``.
  PyTorch's convolution and pooling pad symmetrically, so an uneven SAME
  pad is made explicitly: zeros before a convolution, -inf before max
  pooling; average pooling divides by the count of real cells.
- ConvolutionMode: same -> SAME; truncate -> VALID; strict -> VALID with
  a shape check at config time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.nn.losses import get_loss


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_out_dim(size, k, s, d, mode) -> int:
    eff_k = (k - 1) * d + 1
    if mode == "same":
        return -(-size // s)
    out = (size - eff_k) // s + 1
    if mode == "strict" and (size - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.Strict: input size {size} with kernel {k}, "
            f"stride {s}, dilation {d} does not tile exactly")
    return out


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (lo, hi), hi - lo in {0, 1}."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, stride, dilation, mode):
    """Per spatial dim (lo, hi) of a channels-last x (B, *spatial, C)."""
    if mode != "same":
        return [(0, 0)] * len(kernel)
    return [same_pads(n, k, s, d) for n, k, s, d
            in zip(x.shape[1:-1], kernel, stride, dilation)]


def _pad_channels_last(x, pads, value=0.0):
    """Pad the spatial dims of a channels-last x by [(lo, hi), ...]."""
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def conv_nd(x, w, bias, stride, dilation, mode, groups: int = 1):
    """An XLA-style conv_general_dilated of a channels-last x (B, *spatial,
    C_in) with a channels-last-in kernel (*k, C_in/groups, C_out) (HWIO or
    WIO), 1 or 2 spatial dims; the result channels-last."""
    nd = x.ndim - 2
    kernel = tuple(w.shape[:nd])
    pads = _pads(x, kernel, stride, dilation, mode)
    padding = tuple(lo for lo, _ in pads)
    if any(lo != hi for lo, hi in pads):
        x = _pad_channels_last(x, pads)
        padding = (0,) * nd
    xc = x.movedim(-1, 1)
    wc = w.permute(nd + 1, nd, *range(nd))          # (C_out, C_in/g, *k)
    conv = F.conv2d if nd == 2 else F.conv1d
    y = conv(xc, wc, bias, tuple(stride), padding, tuple(dilation), groups)
    return y.movedim(1, -1)


def pool2d(x, kernel, stride, mode, pooling_type, pnorm=2):
    """reduce_window pooling of an NHWC x: max | avg | sum | pnorm, with
    XLA's SAME padding (-inf for max; avg divides by the real cells)."""
    pt = pooling_type.lower()
    if pt not in ("max", "avg", "sum", "pnorm"):
        raise ValueError(f"Unknown pooling type {pooling_type}")
    pads = _pads(x, kernel, stride, (1, 1), mode)
    padded = any(lo or hi for lo, hi in pads)
    if pt == "max":
        if padded:
            x = _pad_channels_last(x, pads, float("-inf"))
        return F.max_pool2d(x.movedim(-1, 1), kernel, stride).movedim(1, -1)
    src = x.abs() ** float(pnorm) if pt == "pnorm" else x
    if padded:
        src = _pad_channels_last(src, pads)
    s = F.avg_pool2d(src.movedim(-1, 1), kernel, stride,
                     divisor_override=1).movedim(1, -1)
    if pt == "sum":
        return s
    if pt == "pnorm":
        return s ** (1.0 / float(pnorm))
    if not padded:
        return s / float(kernel[0] * kernel[1])
    ones = _pad_channels_last(
        torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                   device=x.device), pads)
    cnt = F.avg_pool2d(ones.movedim(-1, 1), kernel, stride,
                       divisor_override=1).movedim(1, -1)
    return s / cnt


def _conv_transpose_pads(k, s, mode):
    """jax.lax.conv_transpose's (before, after) padding of one dim for a
    SAME or VALID forward conv (effective kernel k, stride s)."""
    if mode == "same":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def _spatial_out(layer, input_type):
    h, w, _ = input_type.shape
    kh, kw = _pair(layer.kernel)
    sh, sw = _pair(layer.stride)
    dh, dw = _pair(getattr(layer, "dilation", 1))
    return (_conv_out_dim(h, kh, sh, dh, layer.convolution_mode),
            _conv_out_dim(w, kw, sw, dw, layer.convolution_mode))


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(LayerConf):
    n_out: int = 0                       # output channels
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"   # same | truncate | strict
    activation: str = "identity"
    weight_init: str = "relu"
    bias_init: float = 0.0
    has_bias: bool = True
    n_in: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(*_spatial_out(self, input_type),
                                       self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        c_in = self.n_in or input_type.shape[2]
        kh, kw = _pair(self.kernel)
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (kh, kw, c_in, self.n_out),
                              c_in * kh * kw, self.n_out * kh * kw, dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        y = conv_nd(x, params["W"], params.get("b") if self.has_bias
                    else None, _pair(self.stride), _pair(self.dilation),
                    self.convolution_mode)
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (DL4J Deconvolution2D), as the reference's
    `lax.conv_transpose` with an unflipped HWIO kernel: the input dilated
    by the stride, padded, then a stride-1 correlation."""

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        if self.convolution_mode == "same":
            oh, ow = h * sh, w * sw
        else:
            oh, ow = (h - 1) * sh + ekh, (w - 1) * sw + ekw
        return InputType.convolutional(oh, ow, self.n_out)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        mode = "same" if self.convolution_mode == "same" else "valid"
        b, h, w, c = x.shape
        xd = x.new_zeros((b, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
        xd[:, ::sh, ::sw, :] = x
        xd = _pad_channels_last(xd, [
            _conv_transpose_pads((kh - 1) * dh + 1, sh, mode),
            _conv_transpose_pads((kw - 1) * dw + 1, sw, mode)])
        y = conv_nd(xd, params["W"], params.get("b") if self.has_bias
                    else None, (1, 1), (dh, dw), "truncate")
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class DepthwiseConvolution2D(LayerConf):
    """Per-channel convolution (DL4J DepthwiseConvolution2D): groups =
    C_in, W (kh, kw, 1, C_in * depth_multiplier)."""
    depth_multiplier: int = 1
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(
            *_spatial_out(self, input_type),
            input_type.shape[2] * self.depth_multiplier)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        c_in = input_type.shape[2]
        kh, kw = _pair(self.kernel)
        w_init = get_initializer(self.weight_init)
        fan_in = kh * kw
        params = {"W": w_init(generator,
                              (kh, kw, 1, c_in * self.depth_multiplier),
                              fan_in, fan_in * self.depth_multiplier, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((c_in * self.depth_multiplier,),
                                      dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        y = conv_nd(x, params["W"], params.get("b") if self.has_bias
                    else None, _pair(self.stride), _pair(self.dilation),
                    self.convolution_mode, groups=x.shape[-1])
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2D(LayerConf):
    """Depthwise then pointwise (DL4J SeparableConvolution2D)."""
    n_out: int = 0
    depth_multiplier: int = 1
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(*_spatial_out(self, input_type),
                                       self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        c_in = input_type.shape[2]
        kh, kw = _pair(self.kernel)
        w_init = get_initializer(self.weight_init)
        mid = c_in * self.depth_multiplier
        params = {
            "dW": w_init(generator, (kh, kw, 1, mid), kh * kw, kh * kw,
                         dtype),
            "pW": w_init(generator, (1, 1, mid, self.n_out), mid, self.n_out,
                         dtype),
        }
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        y = conv_nd(x, params["dW"], None, _pair(self.stride),
                    _pair(self.dilation), self.convolution_mode,
                    groups=x.shape[-1])
        y = conv_nd(y, params["pW"], params.get("b") if self.has_bias
                    else None, (1, 1), (1, 1), "truncate")
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(LayerConf):
    """2D pooling (DL4J SubsamplingLayer): max | avg | sum | pnorm."""
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    pooling_type: str = "max"
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        return InputType.convolutional(
            _conv_out_dim(h, kh, sh, 1, self.convolution_mode),
            _conv_out_dim(w, kw, sw, 1, self.convolution_mode), c)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return pool2d(x, _pair(self.kernel), _pair(self.stride),
                      self.convolution_mode, self.pooling_type,
                      self.pnorm), state


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(LayerConf):
    """Global pooling over the spatial or time axes (DL4J
    GlobalPoolingLayer); mask-aware for (B, T, F) input."""
    pooling_type: str = "max"            # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.features)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        if x.ndim == 4:
            axes = (1, 2)
        elif x.ndim == 3:
            axes = (1,)
        else:
            raise ValueError(f"GlobalPooling expects 3d/4d input, got "
                             f"{tuple(x.shape)}")
        pt = self.pooling_type.lower()
        p = float(self.pnorm)
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if pt == "max":
                y = torch.where(m > 0, x, torch.full_like(x, float("-inf"))
                                ).amax(dim=1)
            elif pt == "sum":
                y = (x * m).sum(dim=1)
            elif pt == "avg":
                y = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
            elif pt == "pnorm":
                y = ((x.abs() * m) ** p).sum(dim=1) ** (1.0 / p)
            else:
                raise ValueError(self.pooling_type)
            return y, state
        if pt == "max":
            y = x.amax(dim=axes)
        elif pt == "sum":
            y = x.sum(dim=axes)
        elif pt == "avg":
            y = x.mean(dim=axes)
        elif pt == "pnorm":
            y = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
        else:
            raise ValueError(self.pooling_type)
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling2D(LayerConf):
    size: Tuple[int, int] = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        sh, sw = _pair(self.size)
        return InputType.convolutional(h * sh, w * sw, c)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), \
            state


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(LayerConf):
    padding: Tuple[int, int, int, int] = (0, 0, 0, 0)   # top,bottom,left,right

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        t, b, l, r = self.padding
        return InputType.convolutional(h + t + b, w + l + r, c)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        t, b, l, r = self.padding
        return _pad_channels_last(x, [(t, b), (l, r)]), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping2D(LayerConf):
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top,bottom,left,right

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        t, b, l, r = self.cropping
        return InputType.convolutional(h - t - b, w - l - r, c)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        t, b, l, r = self.cropping
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class SpaceToDepthLayer(LayerConf):
    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        bs = self.block_size
        return InputType.convolutional(h // bs, w // bs, c * bs * bs)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        b, h, w, c = x.shape
        bs = self.block_size
        x = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // bs, w // bs, bs * bs * c), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SpaceToBatchLayer(LayerConf):
    block_size: Tuple[int, int] = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        bh, bw = _pair(self.block_size)
        return InputType.convolutional(h // bh, w // bw, c)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        b, h, w, c = x.shape
        bh, bw = _pair(self.block_size)
        x = x.reshape(b, h // bh, bh, w // bw, bw, c).permute(2, 4, 0, 1, 3, 5)
        return x.reshape(b * bh * bw, h // bh, w // bw, c), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Convolution1DLayer(LayerConf):
    """1D convolution over (B, T, C), W (k, C_in, C_out) (DL4J
    Convolution1DLayer)."""
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    dilation: int = 1
    convolution_mode: str = "same"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        ot = _conv_out_dim(t, self.kernel, self.stride, self.dilation,
                           self.convolution_mode)
        return InputType(Kind.RNN, (ot, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        c_in = input_type.shape[1]
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (self.kernel, c_in, self.n_out),
                              c_in * self.kernel, self.n_out * self.kernel,
                              dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        y = conv_nd(x, params["W"], params.get("b") if self.has_bias
                    else None, (self.stride,), (self.dilation,),
                    self.convolution_mode)
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(LayerConf):
    kernel: int = 2
    stride: int = 2
    pooling_type: str = "max"           # max, else average
    convolution_mode: str = "truncate"

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        ot = _conv_out_dim(t, self.kernel, self.stride, 1,
                           self.convolution_mode)
        return InputType(Kind.RNN, (ot, c))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        pt = "max" if self.pooling_type == "max" else "avg"
        y = pool2d(x[:, None], (1, self.kernel), (1, self.stride),
                   self.convolution_mode, pt)
        return y[:, 0], state


@register_layer
@dataclasses.dataclass(frozen=True)
class CnnLossLayer(LayerConf):
    """Per-pixel loss head for dense prediction (DL4J CnnLossLayer)."""
    activation: str = "softmax"
    loss: str = "mcxent"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(x), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        b = x.shape[0]
        z = x.reshape(b, -1, x.shape[-1])
        lab = labels.reshape(b, -1, labels.shape[-1])
        per_pix_mask = None if mask is None else mask.reshape(b, -1)
        return get_loss(self.loss)(lab, z, self.activation,
                                   mask=per_pix_mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping1D(LayerConf):
    """Crop timesteps off a (B, T, C) sequence."""
    cropping: Tuple[int, int] = (0, 0)      # (head, tail)

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        a, b = self.cropping
        return InputType(Kind.RNN, (t - a - b, c))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling1D(LayerConf):
    """Repeat each timestep `size` times."""
    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        return InputType(Kind.RNN, (t * int(self.size), c))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return x.repeat_interleave(int(self.size), dim=1), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(LayerConf):
    """Zero-pad the time axis of a (B, T, C) sequence."""
    padding: Tuple[int, int] = (0, 0)       # (head, tail)

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        a, b = self.padding
        return InputType(Kind.RNN, (t + a + b, c))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return _pad_channels_last(x, [tuple(self.padding)]), state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocallyConnected1D(LayerConf):
    """1D convolution with untied weights, a kernel per output position
    (DL4J LocallyConnected1D): W (ot, k*C_in, n_out), b (ot, n_out)."""
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    convolution_mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def _out_len(self, t: int) -> int:
        return _conv_out_dim(t, self.kernel, self.stride, 1,
                             "strict" if self.convolution_mode == "strict"
                             else "truncate")

    def output_type(self, input_type: InputType) -> InputType:
        t, c = input_type.shape
        return InputType(Kind.RNN, (self._out_len(t), self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        t, c = input_type.shape
        ot = self._out_len(t)
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (ot, self.kernel * c, self.n_out),
                              self.kernel * c, self.n_out, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((ot, self.n_out), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        ot = params["W"].shape[0]
        idx = (torch.arange(ot, device=x.device)[:, None] * self.stride
               + torch.arange(self.kernel, device=x.device)[None, :])
        patches = x[:, idx, :].reshape(x.shape[0], ot, -1)
        y = torch.einsum("bok,okn->bon", patches, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocallyConnected2D(LayerConf):
    """2D convolution with untied weights (DL4J LocallyConnected2D): W
    (oh*ow, kh*kw*C_in, n_out), b (oh, ow, n_out)."""
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def _out_hw(self, h: int, w: int) -> Tuple[int, int]:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        mode = "strict" if self.convolution_mode == "strict" else "truncate"
        return (_conv_out_dim(h, kh, sh, 1, mode),
                _conv_out_dim(w, kw, sw, 1, mode))

    def output_type(self, input_type: InputType) -> InputType:
        h, w, c = input_type.shape
        return InputType.convolutional(*self._out_hw(h, w), self.n_out)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        h, w, c = input_type.shape
        oh, ow = self._out_hw(h, w)
        kh, kw = _pair(self.kernel)
        fan_in = kh * kw * c
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (oh * ow, fan_in, self.n_out),
                              fan_in, self.n_out, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((oh, ow, self.n_out), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        b, h, w, c = x.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        oh, ow = self._out_hw(h, w)
        iy = (torch.arange(oh, device=x.device)[:, None] * sh
              + torch.arange(kh, device=x.device)[None, :])
        ix = (torch.arange(ow, device=x.device)[:, None] * sw
              + torch.arange(kw, device=x.device)[None, :])
        # (B, oh, kh, ow, kw, C) -> (B, oh, ow, kh, kw, C)
        patches = x[:, iy[:, :, None, None], ix[None, None, :, :], :]
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            b, oh * ow, kh * kw * c)
        y = torch.einsum("bok,okn->bon", patches, params["W"])
        y = y.reshape(b, oh, ow, self.n_out)
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation)(y), state
