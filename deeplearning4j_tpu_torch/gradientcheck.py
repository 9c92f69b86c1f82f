"""Finite-difference gradient verification.

Counterpart of the JAX package's `gradientcheck.py` (DL4J
`gradientcheck/GradientCheckUtil.java`): autograd is the implementation
and central differences are the oracle, in float64, with the reference's
harness contract: up to `max_per_param` entries of each parameter chosen
by a seeded numpy RandomState, each entry's relative error
|a - n| / (|a| + |n|) (0 when |a - n| < `min_abs_error`) under
`max_rel_error`. Parameters are visited in the reference's order (dict
keys sorted, as JAX flattens them) and named by their key path joined
with "/" (the reference's `path_key` naming), so a seed picks the same
entries in both packages and names them alike. The check runs on the
model's device; nets with dropout should be checked without it, as DL4J
requires (the loss is the inference-mode score).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updaters import tree_leaves, tree_map

DEFAULT_EPS = 1e-5
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8


@dataclasses.dataclass
class GradientCheckResult:
    passed: bool
    max_rel_error: float
    worst_param: str
    n_params_checked: int
    failures: list


def _rel_error(a: float, n: float, min_abs: float) -> float:
    if abs(a - n) < min_abs:
        return 0.0
    denom = abs(a) + abs(n)
    return abs(a - n) / denom if denom > 0 else 0.0


def _leaves_with_path(tree, path=()):
    """(path, leaf) in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def _set_leaf(tree, path, value):
    """A shallow copy of `tree` with the leaf at `path` replaced."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _set_leaf(tree[path[0]], path[1:], value)
    return out


def check_gradients(model, features, labels, *,
                    eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    max_per_param: int = 32,
                    features_mask=None, labels_mask=None,
                    seed: int = 12345,
                    print_results: bool = False) -> GradientCheckResult:
    """Compare autograd gradients of the model's score with central finite
    differences, in float64 on the model's device. For a ComputationGraph
    `features`, `labels` and the masks are tuples (one per input or
    output) or single arrays."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    dev = model.device
    f64 = torch.float64

    def to64(a):
        return torch.as_tensor(np.asarray(a)).to(dev, f64)

    def mask(m):
        return None if m is None else torch.as_tensor(np.asarray(m)).to(dev)

    is_graph = isinstance(model, ComputationGraph)
    if is_graph:
        def tup(v, fn):
            if v is None:
                return None
            return tuple(fn(a) for a in (v if isinstance(v, (tuple, list))
                                         else (v,)))
        x, y = tup(features, to64), tup(labels, to64)
        fm, lm = tup(features_mask, mask), tup(labels_mask, mask)
    else:
        x, y = to64(features), to64(labels)
        fm, lm = mask(features_mask), mask(labels_mask)
    params64 = tree_map(lambda t: t.detach().to(f64), model.params)
    state64 = tree_map(lambda t: t.detach().to(f64)
                       if t.is_floating_point() else t, model.state)

    saved = model._compute_dtype, model._param_dtype
    model._compute_dtype = model._param_dtype = f64
    try:
        def loss_fn(p):
            loss, _ = model._score_fn(p, state64, x, y, fm, lm, False)
            return loss

        leaves = list(_leaves_with_path(params64))
        live = tree_map(lambda t: t.clone().requires_grad_(True), params64)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(live), tree_leaves(live),
                                        allow_unused=True)
        rs = np.random.RandomState(seed)
        failures = []
        worst = ("", 0.0)
        checked = 0
        with torch.no_grad():
            for (path, leaf), g in zip(leaves, grads):
                name = "/".join(path)          # the reference's path_key
                a_grad = (torch.zeros_like(leaf) if g is None else g).cpu() \
                    .numpy()
                leaf_np = leaf.cpu().numpy()
                size = leaf_np.size
                idxs = np.arange(size) if size <= max_per_param else \
                    rs.choice(size, max_per_param, replace=False)
                for flat_i in idxs:
                    i = np.unravel_index(flat_i, leaf_np.shape)
                    orig = leaf_np[i]

                    def perturbed(v):
                        pl = leaf_np.copy()
                        pl[i] = v
                        return _set_leaf(params64, path,
                                         torch.from_numpy(pl).to(dev))

                    lp = float(loss_fn(perturbed(orig + eps)))
                    lm_ = float(loss_fn(perturbed(orig - eps)))
                    numeric = (lp - lm_) / (2 * eps)
                    analytic = float(a_grad[i])
                    rel = _rel_error(analytic, numeric, min_abs_error)
                    checked += 1
                    if rel > worst[1]:
                        worst = (f"{name}[{i}]", rel)
                    if rel > max_rel_error:
                        failures.append((f"{name}[{i}]", analytic, numeric,
                                         rel))
    finally:
        model._compute_dtype, model._param_dtype = saved
    if print_results:
        print(f"gradient check: {checked} entries, worst {worst[0]} rel "
              f"{worst[1]:.3e}, {len(failures)} failures")
    return GradientCheckResult(passed=not failures, max_rel_error=worst[1],
                               worst_param=worst[0],
                               n_params_checked=checked, failures=failures)
