"""The port's convolution layers (`nn/layers/convolution.py`, every class)
against the JAX package.

NHWC activations and HWIO kernels on both sides, the same numpy
parameters and inputs; forward and the gradients of sum(y * g) with
respect to the parameters and the input. The padding cases cover XLA's
asymmetric SAME padding (odd and even sizes, strides 1 and 2, dilation
2, even kernels), truncate and strict, for convolution and for max /
avg / sum / pnorm pooling (-inf padding for max, the count of real cells
for avg). Tolerance: f32 atol 1e-5, rtol 1e-4 (the same sums in other
orders).
"""
import numpy as np
import pytest
import torch

from _torch_parity import check_layer, perturbed
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.layers import convolution as pconv

CNN = JInputType.convolutional


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _pair(name, **kw):
    return getattr(jconv, name)(**kw), getattr(pconv, name)(**kw)


def _types_match(jl, pl, it):
    pit = InputType.from_dict(it.to_dict())
    assert pl.output_type(pit).to_dict() == jl.output_type(it).to_dict()


@pytest.mark.parametrize("mode,size,kernel,stride,dilation", [
    ("same", 8, 3, 1, 1), ("same", 7, 3, 2, 1), ("same", 8, 3, 2, 1),
    ("same", 9, 2, 1, 1), ("same", 8, 4, 2, 1), ("same", 7, 3, 1, 2),
    ("same", 10, 3, 2, 2), ("same", 6, 1, 2, 1),
    ("truncate", 8, 3, 1, 1), ("truncate", 7, 3, 2, 1),
    ("truncate", 8, 3, 2, 2), ("truncate", 9, 2, 2, 1),
    ("strict", 7, 3, 2, 1), ("strict", 9, 3, 1, 2)])
def test_convolution_layer_padding_modes(mode, size, kernel, stride,
                                         dilation):
    kw = dict(n_out=4, kernel=(kernel, kernel), stride=(stride, stride),
              dilation=(dilation, dilation), convolution_mode=mode,
              activation="tanh")
    jl, pl = _pair("ConvolutionLayer", **kw)
    it = CNN(size, size + 1 if mode != "strict" else size, 3)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, it.shape[0], it.shape[1], 3))
    _types_match(jl, pl, it)


def test_convolution_layer_without_bias_and_strict_refusal():
    jl, pl = _pair("ConvolutionLayer", n_out=5, kernel=(2, 3),
                   stride=(1, 2), has_bias=False)
    params, _ = perturbed(jl, CNN(6, 7, 2))
    assert sorted(params) == ["W"] and params["W"].shape == (2, 3, 2, 5)
    check_layer(jl, pl, params, _x(3, 6, 7, 2))
    strict = pconv.ConvolutionLayer(n_out=2, kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="strict")
    with pytest.raises(ValueError, match="Strict"):
        strict.output_type(InputType.convolutional(8, 8, 1))


@pytest.mark.parametrize("size,kernel,stride", [(7, 3, 2), (8, 3, 2),
                                                (112, 3, 2), (9, 4, 3)])
def test_same_pads_are_xla_s(size, kernel, stride):
    lo, hi = pconv.same_pads(size, kernel, stride)
    out = -(-size // stride)
    assert lo + hi == max((out - 1) * stride + kernel - size, 0)
    assert lo == (lo + hi) // 2
    if (size, kernel, stride) == (112, 3, 2):      # ResNet's stem pool
        assert (lo, hi) == (0, 1)


@pytest.mark.parametrize("mode,stride,dilation", [
    ("same", 1, 1), ("same", 2, 1), ("truncate", 2, 1), ("truncate", 1, 2),
    ("same", 3, 1)])
def test_deconvolution_2d(mode, stride, dilation):
    kw = dict(n_out=3, kernel=(3, 3), stride=(stride, stride),
              dilation=(dilation, dilation), convolution_mode=mode)
    jl, pl = _pair("Deconvolution2D", **kw)
    it = CNN(5, 4, 2)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 5, 4, 2))
    _types_match(jl, pl, it)


@pytest.mark.parametrize("mode,stride", [("same", 1), ("same", 2),
                                         ("truncate", 2)])
def test_depthwise_convolution_2d(mode, stride):
    jl, pl = _pair("DepthwiseConvolution2D", depth_multiplier=2,
                   kernel=(3, 3), stride=(stride, stride),
                   convolution_mode=mode)
    it = CNN(7, 6, 3)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 7, 6, 3))
    _types_match(jl, pl, it)


@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_separable_convolution_2d(mode):
    jl, pl = _pair("SeparableConvolution2D", n_out=5, depth_multiplier=2,
                   kernel=(3, 3), stride=(2, 2), convolution_mode=mode)
    it = CNN(7, 8, 3)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 7, 8, 3))
    _types_match(jl, pl, it)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode,size,kernel,stride", [
    ("same", 7, 3, 2), ("same", 8, 3, 2), ("same", 9, 2, 2),
    ("truncate", 7, 3, 2), ("truncate", 8, 2, 2), ("same", 6, 3, 1)])
def test_subsampling_layer(pooling, mode, size, kernel, stride):
    jl, pl = _pair("SubsamplingLayer", kernel=(kernel, kernel),
                   stride=(stride, stride), pooling_type=pooling,
                   convolution_mode=mode, pnorm=3)
    it = CNN(size, size + 1, 3)
    x = _x(2, size, size + 1, 3)
    if pooling == "pnorm":
        x = np.abs(x) + 0.1      # |x|^p's gradient is defined away from 0
    check_layer(jl, pl, {}, x)
    _types_match(jl, pl, it)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_layer(pooling, masked):
    jl, pl = _pair("GlobalPoolingLayer", pooling_type=pooling)
    x4 = np.abs(_x(2, 4, 5, 3)) + 0.1
    check_layer(jl, pl, {}, x4)
    x3 = np.abs(_x(3, 6, 4)) + 0.1
    mask = None
    if masked:
        mask = np.ones((3, 6), "float32")
        mask[0, 4:] = 0.0
        mask[2, 1:] = 0.0
    check_layer(jl, pl, {}, x3, mask=mask)


@pytest.mark.parametrize("name,kw", [
    ("Upsampling2D", dict(size=(2, 3))),
    ("ZeroPaddingLayer", dict(padding=(1, 2, 0, 3))),
    ("Cropping2D", dict(cropping=(1, 0, 2, 1))),
    ("SpaceToDepthLayer", dict(block_size=2)),
    ("SpaceToBatchLayer", dict(block_size=(2, 2)))])
def test_spatial_rearrangements(name, kw):
    jl, pl = _pair(name, **kw)
    it = CNN(4, 6, 3)
    check_layer(jl, pl, {}, _x(2, 4, 6, 3))
    _types_match(jl, pl, it)


@pytest.mark.parametrize("mode,stride,dilation", [
    ("same", 1, 1), ("same", 2, 1), ("truncate", 2, 1), ("same", 1, 2)])
def test_convolution_1d_layer(mode, stride, dilation):
    jl, pl = _pair("Convolution1DLayer", n_out=4, kernel=3, stride=stride,
                   dilation=dilation, convolution_mode=mode)
    it = JInputType.recurrent(3, 9)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 9, 3))
    _types_match(jl, pl, it)


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_subsampling_1d_layer(pooling, mode):
    jl, pl = _pair("Subsampling1DLayer", kernel=3, stride=2,
                   pooling_type=pooling, convolution_mode=mode)
    check_layer(jl, pl, {}, _x(2, 9, 3))


def test_cnn_loss_layer_forward_and_score():
    jl, pl = _pair("CnnLossLayer")
    x = _x(2, 3, 4, 5)
    check_layer(jl, pl, {}, x)
    labels = np.eye(5, dtype="float32")[
        np.random.RandomState(0).randint(0, 5, (2, 3, 4))]
    mask = np.ones((2, 3, 4), "float32")
    mask[1, 2:] = 0.0
    for m in (None, mask):
        js = jl.score({}, x, labels, mask=m)
        ps = pl.score({}, torch.from_numpy(x), torch.from_numpy(labels),
                      mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(ps.item(), float(js), rtol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("Cropping1D", dict(cropping=(1, 2))),
    ("Cropping1D", dict(cropping=(2, 0))),
    ("Upsampling1D", dict(size=3)),
    ("ZeroPadding1DLayer", dict(padding=(2, 1)))])
def test_sequence_rearrangements(name, kw):
    jl, pl = _pair(name, **kw)
    check_layer(jl, pl, {}, _x(2, 6, 3))
    _types_match(jl, pl, JInputType.recurrent(3, 6))


@pytest.mark.parametrize("stride", [1, 2])
def test_locally_connected_1d(stride):
    jl, pl = _pair("LocallyConnected1D", n_out=4, kernel=3, stride=stride,
                   activation="tanh")
    it = JInputType.recurrent(3, 9)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 9, 3))


@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_locally_connected_2d(stride):
    jl, pl = _pair("LocallyConnected2D", n_out=3, kernel=(2, 3),
                   stride=stride)
    it = CNN(5, 6, 2)
    params, _ = perturbed(jl, it)
    check_layer(jl, pl, params, _x(2, 5, 6, 2))
    _types_match(jl, pl, it)


def test_convolution_keeps_nhwc_contiguous_at_the_boundary():
    pl = pconv.ConvolutionLayer(n_out=8, kernel=(3, 3),
                                convolution_mode="same")
    params, _ = pl.init(torch.Generator().manual_seed(0),
                        InputType.convolutional(6, 6, 4))
    y, _ = pl.apply(params, {}, torch.randn(2, 6, 6, 4))
    assert y.shape == (2, 6, 6, 8)
    pool = pconv.SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                  convolution_mode="same")
    z, _ = pool.apply({}, {}, y)
    assert z.shape == (2, 3, 3, 8)
    assert params["W"].shape == (3, 3, 4, 8)          # HWIO in the dict
    assert y.is_contiguous() and z.is_contiguous()
