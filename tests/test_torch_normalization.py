"""The port's normalization layers (`nn/layers/normalization.py`) against
the JAX package.

BatchNormalization: the training forward (batch mean and biased
variance), the new running state (``decay * old + (1 - decay) *
batch``, the biased variance), the inference forward from the state, and
the gradients through the batch statistics, on NHWC, (B, T, C) and
(B, C) inputs; statistics in f32 under bf16. LocalResponseNormalization:
forward and gradients. Tolerances: f32 atol 1e-5, rtol 1e-4 (the same
math in other orders); the state atol 1e-6; bf16 outputs atol/rtol 2e-2
(one rounding to bf16 in the port, two in the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import check_layer, perturbed, to_torch
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu_torch.nn.layers import normalization as pnorm

SHAPES = {"nhwc": ((4, 5, 6, 3), JInputType.convolutional(5, 6, 3)),
          "rnn": ((3, 7, 4), JInputType.recurrent(4, 7)),
          "ff": ((6, 5), JInputType.feed_forward(5))}


def _x(shape, seed=2):
    rs = np.random.RandomState(seed)
    return (1.5 * rs.randn(*shape) + 0.7).astype("float32")


def _state(c, seed=4):
    rs = np.random.RandomState(seed)
    return {"mean": (0.2 * rs.randn(c)).astype("float32"),
            "var": (1.0 + rs.rand(c)).astype("float32")}


@pytest.mark.parametrize("layout", sorted(SHAPES))
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_forward_state_and_gradients(layout, train):
    shape, it = SHAPES[layout]
    kw = dict(decay=0.8, epsilon=1e-3)
    jl, pl = jnorm.BatchNormalization(**kw), pnorm.BatchNormalization(**kw)
    params, _ = perturbed(jl, it)
    state = _state(shape[-1])
    check_layer(jl, pl, params, _x(shape), state=state, train=train,
                tol=dict(atol=1e-5, rtol=1e-4))


def test_batch_norm_state_uses_the_biased_variance():
    x = _x((8, 3))
    pl = pnorm.BatchNormalization(decay=0.0)
    _, st = pl.apply({"gamma": torch.ones(3), "beta": torch.zeros(3)},
                     {"mean": torch.zeros(3), "var": torch.ones(3)},
                     torch.from_numpy(x), train=True)
    np.testing.assert_allclose(st["var"].numpy(), x.var(axis=0), rtol=1e-5)
    np.testing.assert_allclose(st["mean"].numpy(), x.mean(axis=0),
                               rtol=1e-5, atol=1e-6)
    assert st["mean"].dtype == st["var"].dtype == torch.float32


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_lock_gamma_beta(train):
    kw = dict(lock_gamma_beta=True, gamma_init=1.5, beta_init=-0.5)
    jl, pl = jnorm.BatchNormalization(**kw), pnorm.BatchNormalization(**kw)
    shape, it = SHAPES["nhwc"]
    params, state = jl.init(jax.random.PRNGKey(0), it)
    assert params == {}
    check_layer(jl, pl, {}, _x(shape), state=_state(3), train=train)


def test_batch_norm_bf16_statistics_in_f32():
    shape, it = SHAPES["nhwc"]
    jl, pl = jnorm.BatchNormalization(), pnorm.BatchNormalization()
    params, _ = perturbed(jl, it)
    x = _x(shape)
    st = _state(3)
    jy, jst = jl.apply(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jax.tree_util.tree_map(jnp.asarray, st),
        jnp.asarray(x, jnp.bfloat16), train=True)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          params.items()}
    y, pst = pl.apply(tp, to_torch(st), torch.from_numpy(x).to(torch.bfloat16),
                      train=True)
    assert y.dtype == torch.bfloat16
    assert pst["mean"].dtype == pst["var"].dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    for k in ("mean", "var"):
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-2, rtol=1e-2)


def test_batch_norm_init_matches_the_reference():
    it = JInputType.convolutional(4, 4, 5)
    jp, js = jnorm.BatchNormalization(gamma_init=2.0).init(
        jax.random.PRNGKey(0), it)
    pp, ps = pnorm.BatchNormalization(gamma_init=2.0).init(
        torch.Generator(), it)
    for a, b in ((jp, pp), (js, ps)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


@pytest.mark.parametrize("n", [3, 5, 4])
def test_local_response_normalization(n):
    kw = dict(n=n, k=1.0, alpha=0.1, beta=0.75)
    jl = jnorm.LocalResponseNormalization(**kw)
    pl = pnorm.LocalResponseNormalization(**kw)
    check_layer(jl, pl, {}, _x((2, 3, 4, 7)))
