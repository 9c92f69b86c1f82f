"""Every loss of the port's `nn/losses.py` against the JAX package's, on
the same random inputs, with and without a (B, T) mask.

Tolerance f32 atol 1e-6, rtol 1e-5: the same f32 arithmetic; XLA and
torch sum and evaluate log/exp in other orders and approximations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as JL
from deeplearning4j_tpu_torch.nn import losses as PL

TOL = dict(atol=1e-6, rtol=1e-5)
B, T, C = 3, 5, 6


def _labels(name, rs):
    if name == "sparse_mcxent":
        return rs.randint(0, C, (B, T)).astype("int32")
    if name in ("hinge", "squared_hinge"):
        return np.sign(rs.randn(B, T, C)).astype("float32")
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        return np.eye(C, dtype="float32")[rs.randint(0, C, (B, T))]
    if name in ("xent", "binary_crossentropy"):
        return (rs.rand(B, T, C) > 0.5).astype("float32")
    if name == "poisson":
        return rs.poisson(2.0, (B, T, C)).astype("float32")
    return rs.randn(B, T, C).astype("float32")


_ACTIVATION = {"xent": "sigmoid", "binary_crossentropy": "sigmoid",
               "mcxent": "softmax", "negativeloglikelihood": "softmax",
               "sparse_mcxent": "softmax", "kl_divergence": "softmax",
               "poisson": "softplus"}


def _both(name, activation, masked, weighted, seed=0):
    rs = np.random.RandomState(seed)
    labels = _labels(name, rs)
    preout = (2 * rs.randn(B, T, C)).astype("float32")
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 3:] = 0.0
        mask[2, :] = 0.0
    weights = rs.rand(C).astype("float32") if weighted else None
    j = JL.get_loss(name)(jnp.asarray(labels), jnp.asarray(preout),
                          activation,
                          mask=None if mask is None else jnp.asarray(mask),
                          weights=None if weights is None
                          else jnp.asarray(weights))
    p = PL.get_loss(name)(torch.from_numpy(labels), torch.from_numpy(preout),
                          activation,
                          mask=None if mask is None else torch.from_numpy(mask),
                          weights=None if weights is None
                          else torch.from_numpy(weights))
    return p, j


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(JL.LOSSES))
def test_loss_matches_jax(name, masked):
    p, j = _both(name, _ACTIVATION.get(name, "identity"), masked, False)
    assert p.dtype == torch.float32 and p.dim() == 0
    np.testing.assert_allclose(p.item(), float(j), **TOL)


@pytest.mark.parametrize("name", ["mse", "l2", "xent", "mcxent",
                                  "sparse_mcxent", "hinge"])
def test_weighted_losses_match_jax(name):
    p, j = _both(name, _ACTIVATION.get(name, "identity"), True, True, seed=1)
    np.testing.assert_allclose(p.item(), float(j), **TOL)


@pytest.mark.parametrize("activation", ["softmax", "sigmoid", "tanh"])
@pytest.mark.parametrize("masked", [False, True])
def test_mcxent_log_softmax_and_clipped_forms(activation, masked):
    """softmax -> log_softmax of the logits; any other activation -> log of
    the activation clipped to [1e-7, 1] (tanh goes negative: clipped)."""
    p, j = _both("mcxent", activation, masked, False, seed=2)
    np.testing.assert_allclose(p.item(), float(j), **TOL)


def test_mask_mean_divides_by_unmasked_count():
    per = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    mask = torch.tensor([[1.0, 0.0], [1.0, 1.0]])
    assert PL._apply_mask_and_mean(per, mask).item() == pytest.approx(8 / 3)
    # an all-masked batch divides by max(0, 1): zero, not NaN
    assert PL._apply_mask_and_mean(per, torch.zeros(2, 2)).item() == 0.0


def test_losses_table_and_lookup():
    assert sorted(PL.LOSSES) == sorted(JL.LOSSES)
    assert PL.get_loss("MCXENT") is PL.mcxent
    with pytest.raises(ValueError, match="Unknown loss"):
        PL.get_loss("nope")


def test_mcxent_gradient_matches_jax():
    import jax
    rs = np.random.RandomState(3)
    labels = np.eye(C, dtype="float32")[rs.randint(0, C, (B, T))]
    z = rs.randn(B, T, C).astype("float32")
    mask = np.ones((B, T), np.float32)
    mask[1, 2:] = 0.0
    gj = jax.grad(lambda zz: JL.mcxent(jnp.asarray(labels), zz, "softmax",
                                       mask=jnp.asarray(mask)))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    PL.mcxent(torch.from_numpy(labels), zt, "softmax",
              mask=torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gj), **TOL)
