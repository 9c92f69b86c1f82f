"""Loss functions.

Counterpart of the JAX package's `nn/losses.py` (DL4J's ILossFunction
family). Every loss is a function

    loss(labels, preout, activation, mask=None, weights=None) -> mean score

of the *pre-activation* output and the output activation, as in DL4J,
differentiated by autograd through the activation. A mask drops masked
elements from the mean: the sum over unmasked elements is divided by
their count, ``max(sum(mask), 1)``.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation

_EPS = 1e-7


def _apply_mask_and_mean(per_example, mask):
    """Per-example scores (B,) or (B, T) -> the mean score; masked-out
    elements contribute nothing and are not counted."""
    if mask is None:
        return per_example.mean()
    mask = mask.reshape(per_example.shape).to(per_example.dtype)
    total = (per_example * mask).sum()
    return total / mask.sum().clamp_min(1.0)


def _weighted(err, weights):
    return err * weights if weights is not None else err


def _act_name(activation):
    return None if callable(activation) else str(activation).lower()


def mse(labels, preout, activation="identity", mask=None, weights=None):
    out = get_activation(activation)(preout)
    err = _weighted((out - labels) ** 2, weights)
    return _apply_mask_and_mean(err.mean(-1), mask)


def mae(labels, preout, activation="identity", mask=None, weights=None):
    out = get_activation(activation)(preout)
    err = _weighted((out - labels).abs(), weights)
    return _apply_mask_and_mean(err.mean(-1), mask)


def l1(labels, preout, activation="identity", mask=None, weights=None):
    out = get_activation(activation)(preout)
    err = _weighted((out - labels).abs(), weights)
    return _apply_mask_and_mean(err.sum(-1), mask)


def l2(labels, preout, activation="identity", mask=None, weights=None):
    out = get_activation(activation)(preout)
    err = _weighted((out - labels) ** 2, weights)
    return _apply_mask_and_mean(err.sum(-1), mask)


def xent(labels, preout, activation="sigmoid", mask=None, weights=None):
    """Binary cross-entropy (DL4J LossBinaryXENT), from the logits when
    the output activation is sigmoid."""
    if _act_name(activation) == "sigmoid":
        z = preout      # max(z, 0) - z*y + log(1 + exp(-|z|))
        per = z.clamp_min(0) - z * labels + torch.log1p(torch.exp(-z.abs()))
    else:
        out = get_activation(activation)(preout).clamp(_EPS, 1.0 - _EPS)
        per = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    per = _weighted(per, weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


def mcxent(labels, preout, activation="softmax", mask=None, weights=None):
    """Multi-class cross-entropy / negative log likelihood (DL4J LossMCXENT
    / LossNegativeLogLikelihood), by log_softmax when the activation is
    softmax, else by the clipped activation."""
    if _act_name(activation) == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(get_activation(activation)(preout).clamp(_EPS, 1.0))
    per = -_weighted(labels * logp, weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


def sparse_mcxent(labels, preout, activation="softmax", mask=None,
                  weights=None):
    """MCXENT with integer class labels (DL4J LossSparseMCXENT)."""
    logp = torch.log_softmax(preout, dim=-1)
    labels = labels.to(torch.int64)
    per = -torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0]
    if weights is not None:
        per = per * weights[labels]
    return _apply_mask_and_mean(per, mask)


negativeloglikelihood = mcxent


def kl_divergence(labels, preout, activation="softmax", mask=None,
                  weights=None):
    out = get_activation(activation)(preout).clamp(_EPS, 1.0)
    lab = labels.clamp(_EPS, 1.0)
    per = _weighted(lab * (torch.log(lab) - torch.log(out)), weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


def poisson(labels, preout, activation="identity", mask=None, weights=None):
    out = get_activation(activation)(preout).clamp_min(_EPS)
    per = _weighted(out - labels * torch.log(out), weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


def cosine_proximity(labels, preout, activation="identity", mask=None,
                     weights=None):
    out = get_activation(activation)(preout)
    dot = (out * labels).sum(-1)
    norm = torch.linalg.vector_norm(out, dim=-1) \
        * torch.linalg.vector_norm(labels, dim=-1)
    return _apply_mask_and_mean(-dot / norm.clamp_min(_EPS), mask)


def hinge(labels, preout, activation="identity", mask=None, weights=None):
    # labels in {-1, +1}
    out = get_activation(activation)(preout)
    per = _weighted((1.0 - labels * out).clamp_min(0.0), weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


def squared_hinge(labels, preout, activation="identity", mask=None,
                  weights=None):
    out = get_activation(activation)(preout)
    per = _weighted((1.0 - labels * out).clamp_min(0.0) ** 2, weights)
    return _apply_mask_and_mean(per.sum(-1), mask)


LOSSES = {
    "mse": mse,
    "mae": mae,
    "l1": l1,
    "l2": l2,
    "xent": xent,
    "binary_crossentropy": xent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "sparse_mcxent": sparse_mcxent,
    "kl_divergence": kl_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
}


def get_loss(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]
