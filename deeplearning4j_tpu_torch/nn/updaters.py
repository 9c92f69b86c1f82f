"""Updaters (optimizers) and learning-rate schedules.

Counterpart of the JAX package's `nn/updaters.py`: the same config
dataclasses (a saved `configuration.json` names its updater), and the
optimizer math written by hand, without `torch.optim`, to follow the
reference's optax 0.2.6 transformations in their order of operations:
where eps goes, bias correction by the step count, schedules evaluated at
the transformation's own count, weight decay on every leaf.

A transformation is a pair of functions over nested dicts of tensors,
`init(params) -> state` and `update(updates, state, params) ->
(updates, state)`. The state is a nested dict in optax's own state-dict
layout (a chain is ``{"0": ..., "1": ...}``, a named state its field
names, an empty state ``{}``), so `updaterState.bin` is a plain encoding
of it and moves between the packages. Counts are int32 scalars.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, NamedTuple, Optional

import torch


# ---------------------------------------------------------------- schedules
@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base LR schedule config (DL4J ISchedule). `fn()` gives the schedule
    as a function of an int32 count tensor -> an f32 tensor."""

    def fn(self) -> Callable:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value: float

    def fn(self):
        return lambda count: torch.full_like(count, self.value,
                                             dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    initial: float
    decay_rate: float
    step: int

    def fn(self):
        """lr * decay^floor(iter/step)."""
        return lambda count: self.initial * self.decay_rate \
            ** torch.div(count, self.step, rounding_mode="floor").float()


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    initial: float
    gamma: float

    def fn(self):
        """lr * gamma^iter."""
        return lambda count: self.initial * self.gamma ** count.float()


@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    initial: float
    gamma: float
    power: float = 1.0

    def fn(self):
        """lr / (1 + gamma*iter)^power."""
        return lambda count: self.initial \
            / (1.0 + self.gamma * count.float()) ** self.power


@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    initial: float
    power: float
    max_iter: int

    def fn(self):
        """lr * (1 - iter/maxIter)^power (optax.polynomial_schedule to 0)."""
        return _polynomial(self.initial, 0.0, self.power, self.max_iter)


@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    initial: float
    gamma: float
    step_size: int

    def fn(self):
        """lr / (1 + exp(-gamma*(iter-stepSize)))."""
        return lambda count: self.initial / (1.0 + torch.exp(
            -self.gamma * (count - self.step_size).float()))


@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    peak: float
    warmup_steps: int
    total_steps: int
    end_value: float = 0.0

    def fn(self):
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, total, end)."""
        warm = _polynomial(0.0, self.peak, 1, self.warmup_steps)
        decay_steps = self.total_steps - self.warmup_steps
        if not decay_steps > 0:
            raise ValueError(f"WarmupCosineSchedule needs total_steps > "
                             f"warmup_steps, got {self.total_steps} <= "
                             f"{self.warmup_steps}")
        alpha = 0.0 if self.peak == 0.0 else self.end_value / self.peak

        def cosine(count):
            c = torch.clamp_max(count.float(), float(decay_steps))
            decayed = (1 - alpha) * (0.5 * (1 + torch.cos(
                math.pi * c / decay_steps))) + alpha
            return self.peak * decayed

        def schedule(count):
            return torch.where(count < self.warmup_steps, warm(count),
                               cosine(count - self.warmup_steps))
        return schedule


def _polynomial(init_value, end_value, power, transition_steps):
    """optax.polynomial_schedule (transition_begin 0)."""
    if transition_steps <= 0:
        return lambda count: torch.full_like(count, init_value,
                                             dtype=torch.float32)

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


# ------------------------------------------------------------- tree helpers
def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves of nested dicts of one structure; the
    result's keys come in sorted order, as a JAX tree map leaves them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in sorted-key order (the order JAX flattens a dict in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _count(like):
    return torch.zeros((), dtype=torch.int32, device=_device_of(like))


def _device_of(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _safe_increment(count):
    top = torch.iinfo(torch.int32).max
    return torch.where(count < top, count + 1, count)


def _bias_correction(moment, decay, count):
    """moment / (1 - decay^count). decay^count is taken in f32 for f32 and
    narrower moments, as optax's jnp power of a weak float and an int32
    count gives it, and in f64 for f64 moments: the reference trains in
    f64 only under JAX's x64 mode, where that power is f64."""
    corr = {}

    def scale(t):
        wide = torch.promote_types(torch.float32, t.dtype)
        if wide not in corr:
            corr[wide] = 1 - decay ** count.to(wide)
        return t / corr[wide].to(t.dtype)
    return tree_map(scale, moment)


def _moment(updates, moments, decay, order):
    return tree_map(lambda g, t: (1 - decay) * (g ** order) + decay * t,
                    updates, moments)


class Transform(NamedTuple):
    """One gradient transformation: `init(params) -> state`,
    `update(updates, state, params) -> (updates, state)`."""
    init: Callable
    update: Callable


def identity() -> Transform:
    return Transform(lambda params: {},
                     lambda updates, state, params=None: (updates, state))


def chain(*transforms: Transform) -> Transform:
    """optax.chain: state ``{"0": s0, "1": s1, ...}``."""
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(updates, state, params=None):
        new = {}
        for i, t in enumerate(transforms):
            updates, new[str(i)] = t.update(updates, state[str(i)], params)
        return updates, new
    return Transform(init, update)


def masked_all(inner: Transform) -> Transform:
    """optax.masked with the mask ``True`` (every leaf), as optax.lars
    applies it: state ``{"inner_state": ...}``."""
    def update(updates, state, params=None):
        updates, inner_state = inner.update(updates, state["inner_state"],
                                            params)
        return updates, {"inner_state": inner_state}
    return Transform(lambda params: {"inner_state": inner.init(params)},
                     update)


def scale(step_size: float) -> Transform:
    return Transform(lambda params: {},
                     lambda updates, state, params=None: (
                         tree_map(lambda g: step_size * g, updates), state))


def scale_by_schedule(step_size_fn: Callable) -> Transform:
    """The schedule at this transformation's own count, then count + 1."""
    def update(updates, state, params=None):
        step = step_size_fn(state["count"])
        updates = tree_map(lambda g: step.to(g.dtype) * g, updates)
        return updates, {"count": _safe_increment(state["count"])}
    return Transform(lambda params: {"count": _count(params)}, update)


def scale_by_learning_rate(lr) -> Transform:
    """-lr * updates (optax flips the sign here)."""
    if callable(lr):
        return scale_by_schedule(lambda count: -lr(count))
    return scale(-lr)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(updates, state, params=None):
        new_trace = tree_map(lambda g, t: g + decay * t, updates,
                             state["trace"])
        if nesterov:
            updates = tree_map(lambda g, t: g + decay * t, updates, new_trace)
        else:
            updates = new_trace
        return updates, {"trace": new_trace}
    return Transform(
        lambda params: {"trace": tree_map(torch.zeros_like, params)}, update)


def _zeros_state(params, *names):
    return {n: tree_map(torch.zeros_like, params) for n in names}


def scale_by_adam(b1: float, b2: float, eps: float,
                  nesterov: bool = False) -> Transform:
    """Adam's scaling, eps outside the square root, bias-corrected by the
    incremented count; `nesterov` is optax's Nadam form."""
    def init(params):
        return {"count": _count(params), **_zeros_state(params, "mu", "nu")}

    def update(updates, state, params=None):
        mu = _moment(updates, state["mu"], b1, 1)
        nu = _moment(updates, state["nu"], b2, 2)
        count = _safe_increment(state["count"])
        if nesterov:
            mu_hat = tree_map(
                lambda m, g: b1 * m + (1 - b1) * g,
                _bias_correction(mu, b1, _safe_increment(count)),
                _bias_correction(updates, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        updates = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat,
                           nu_hat)
        return updates, {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


def scale_by_amsgrad(b1: float, b2: float, eps: float) -> Transform:
    def init(params):
        return {"count": _count(params),
                **_zeros_state(params, "mu", "nu", "nu_max")}

    def update(updates, state, params=None):
        mu = _moment(updates, state["mu"], b1, 1)
        nu = _moment(updates, state["nu"], b2, 2)
        count = _safe_increment(state["count"])
        mu_hat = _bias_correction(mu, b1, count)
        nu_max = tree_map(torch.maximum, state["nu_max"],
                          _bias_correction(nu, b2, count))
        updates = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat,
                           nu_max)
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "nu_max": nu_max}
    return Transform(init, update)


def scale_by_adamax(b1: float, b2: float, eps: float) -> Transform:
    def init(params):
        return {"count": _count(params), **_zeros_state(params, "mu", "nu")}

    def update(updates, state, params=None):
        count = _safe_increment(state["count"])
        mu = _moment(updates, state["mu"], b1, 1)
        nu = tree_map(lambda g, t: torch.maximum(g.abs() + eps, b2 * t),
                      updates, state["nu"])
        mu_hat = _bias_correction(mu, b1, count)
        updates = tree_map(lambda m, v: m / v, mu_hat, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float, eps: float) -> Transform:
    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(updates, state, params=None):
        sos = tree_map(lambda g, t: g * g + t, updates,
                       state["sum_of_squares"])
        updates = tree_map(
            lambda t, g: torch.where(t > 0, torch.rsqrt(t + eps),
                                     torch.zeros_like(t)) * g, sos, updates)
        return updates, {"sum_of_squares": sos}
    return Transform(init, update)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    def update(updates, state, params=None):
        e_g = _moment(updates, state["e_g"], rho, 2)
        updates = tree_map(
            lambda g, cur, prev: torch.sqrt(prev + eps) / torch.sqrt(cur + eps)
            * g, updates, e_g, state["e_x"])
        e_x = _moment(updates, state["e_x"], rho, 2)
        return updates, {"e_g": e_g, "e_x": e_x}
    return Transform(lambda params: _zeros_state(params, "e_g", "e_x"),
                     update)


def scale_by_rms(decay: float, eps: float) -> Transform:
    def update(updates, state, params=None):
        nu = _moment(updates, state["nu"], decay, 2)
        updates = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates)
        return updates, {"nu": nu}
    return Transform(lambda params: _zeros_state(params, "nu"), update)


def scale_by_trust_ratio(trust_coefficient: float,
                         eps: float = 0.0) -> Transform:
    def update(updates, state, params):
        norms = iter(zip(*leaf_norms(params, updates)))

        def scaled(u, p):
            p_norm, u_norm = next(norms)
            ratio = trust_coefficient * p_norm / (u_norm + eps)
            zero = (p_norm == 0.0) | (u_norm == 0.0)
            return u * torch.where(zero, torch.ones_like(ratio), ratio)
        return tree_map(scaled, updates, params), state
    return Transform(lambda params: {}, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """updates + weight_decay * params on every leaf (no mask)."""
    return Transform(lambda params: {},
                     lambda updates, state, params: (
                         tree_map(lambda g, p: g + weight_decay * p,
                                  updates, params), state))


def set_to_zero() -> Transform:
    return Transform(lambda params: {},
                     lambda updates, state, params=None: (
                         tree_map(torch.zeros_like, updates), state))


def clip(max_delta: float) -> Transform:
    return Transform(lambda params: {},
                     lambda updates, state, params=None: (
                         tree_map(lambda g: g.clamp(-max_delta, max_delta),
                                  updates), state))


_NORM_HOOK = threading.local()


@contextlib.contextmanager
def global_norm_hook(fn: Callable, leaf_fn: Optional[Callable] = None):
    """Inside the block `global_norm(updates)` is `fn(updates)` and
    `leaf_norms(*trees)` is `leaf_fn(*trees)`: a sharded update
    (`parallel/plan.py`) measures whole leaves from their pieces."""
    prev = (getattr(_NORM_HOOK, "fn", None),
            getattr(_NORM_HOOK, "leaf", None))
    _NORM_HOOK.fn, _NORM_HOOK.leaf = fn, leaf_fn
    try:
        yield
    finally:
        _NORM_HOOK.fn, _NORM_HOOK.leaf = prev


def leaf_norms(*trees) -> list:
    """Per tree, the norm of each of its leaves (tree_leaves order)."""
    hook = getattr(_NORM_HOOK, "leaf", None)
    if hook is not None:
        return hook(*trees)
    return [[torch.linalg.vector_norm(t) for t in tree_leaves(tree)]
            for tree in trees]


def global_norm(updates) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, summed leaf by leaf in
    the reference's order."""
    hook = getattr(_NORM_HOOK, "fn", None)
    if hook is not None:
        return hook(updates)
    total = sum((g * g).sum() for g in tree_leaves(updates))
    return torch.sqrt(torch.as_tensor(total))


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every leaf by max_norm / ||g|| when ||g|| >= max_norm. The
    decision stays on the device: no host sync."""
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(
            lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype))
                                  * max_norm), updates), state
    return Transform(lambda params: {}, update)


def _masked(tree, labels, label):
    """`tree` with every leaf not labelled `label` replaced by an empty
    subtree (optax's MaskedNode, which its state dict writes as {})."""
    if isinstance(tree, dict):
        return {k: _masked(tree[k], labels[k], label) for k in tree}
    return tree if labels == label else {}


def _merge(like, labels, by_label):
    """Each leaf of `like` taken from the tree of its own label."""
    if isinstance(like, dict):
        return {k: _merge(like[k], labels[k],
                          {lab: t[k] for lab, t in by_label.items()})
                for k in sorted(like)}
    return by_label[labels]


def multi_transform(transforms: dict, labels) -> Transform:
    """optax.multi_transform: each leaf goes through the transformation of
    its label (`labels` is a tree of label strings shaped like the
    params). Each transformation sees only its own leaves, so a global
    clip inside one measures only them. State ``{"inner_states": {label:
    {"inner_state": ...}}}`` in `transforms`' order, optax's layout."""
    def init(params):
        return {"inner_states": {
            lab: {"inner_state": tx.init(_masked(params, labels, lab))}
            for lab, tx in transforms.items()}}

    def update(updates, state, params=None):
        inner, by_label = {}, {}
        for lab, tx in transforms.items():
            by_label[lab], s = tx.update(
                _masked(updates, labels, lab),
                state["inner_states"][lab]["inner_state"],
                None if params is None else _masked(params, labels, lab))
            inner[lab] = {"inner_state": s}
        return _merge(updates, labels, by_label), {"inner_states": inner}
    return Transform(init, update)


def apply_updates(params, updates):
    """params += updates, leaf by leaf in place (optax.apply_updates,
    which returns new arrays; the port updates its master weights where
    they lie). Call under torch.no_grad()."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))


# ---------------------------------------------------------------- updaters
@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config (DL4J IUpdater). `transform()` is the
    counterpart of the reference's `to_optax()`."""
    learning_rate: float = 1e-3
    schedule: Optional[Schedule] = None

    def _lr(self):
        if self.schedule is not None:
            return self.schedule.fn()
        return self.learning_rate

    def transform(self) -> Transform:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    def transform(self):
        return chain(identity(), scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def transform(self):
        return chain(trace(self.momentum, nesterov=True),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class Momentum(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def transform(self):
        return chain(trace(self.momentum),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class AdamW(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 1e-2

    def transform(self):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class AMSGrad(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return chain(scale_by_amsgrad(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon,
                                   nesterov=True),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    learning_rate: float = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return chain(scale_by_adamax(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def transform(self):
        return chain(scale_by_rss(0.1, self.epsilon),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """DL4J AdaDelta carries no learning rate: the update is the
    RMS(dx)/RMS(g) ratio itself, an effective LR of 1.0."""
    learning_rate: float = 1.0
    rho: float = 0.95
    epsilon: float = 1e-6

    def transform(self):
        return chain(add_decayed_weights(0.0),
                     scale_by_adadelta(self.rho, self.epsilon),
                     scale_by_learning_rate(self._lr()))


@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: float = 1e-1
    decay: float = 0.95
    epsilon: float = 1e-8

    def transform(self):
        return chain(scale_by_rms(self.decay, self.epsilon),
                     scale_by_learning_rate(self._lr()), identity())


@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen params (DL4J NoOp updater, used by FrozenLayer)."""

    def transform(self):
        return set_to_zero()


@dataclasses.dataclass(frozen=True)
class Lars(Updater):
    """Layer-wise adaptive rate scaling (optax.lars: trust coefficient
    0.001, eps 0)."""
    learning_rate: float = 1.0
    momentum: float = 0.9
    weight_decay: float = 0.0

    def transform(self):
        return chain(masked_all(add_decayed_weights(self.weight_decay)),
                     masked_all(scale_by_trust_ratio(0.001)),
                     scale_by_learning_rate(self._lr()),
                     trace(self.momentum))


UPDATERS = {
    "sgd": Sgd,
    "nesterovs": Nesterovs,
    "momentum": Momentum,
    "adam": Adam,
    "adamw": AdamW,
    "amsgrad": AMSGrad,
    "nadam": Nadam,
    "adamax": AdaMax,
    "adagrad": AdaGrad,
    "adadelta": AdaDelta,
    "rmsprop": RmsProp,
    "noop": NoOp,
    "lars": Lars,
}


def get_updater(spec: Any) -> Updater:
    """Resolve an updater from an Updater instance, name, or (name, lr)."""
    if isinstance(spec, Updater):
        return spec
    if isinstance(spec, str):
        return UPDATERS[spec.lower()]()
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return UPDATERS[str(spec[0]).lower()](learning_rate=float(spec[1]))
    raise ValueError(f"Cannot resolve updater from {spec!r}")


def build_optimizer(updater: Any, grad_clip_norm: Optional[float] = None,
                    grad_clip_value: Optional[float] = None) -> Transform:
    """The final chain, as the reference builds it: elementwise clip, then
    global-norm clip, then the updater (a bare updater when neither clip
    is set, so the state layout is the reference's)."""
    tx = get_updater(updater).transform()
    parts = []
    if grad_clip_value is not None:
        parts.append(clip(grad_clip_value))
    if grad_clip_norm is not None:
        parts.append(clip_by_global_norm(grad_clip_norm))
    parts.append(tx)
    return chain(*parts) if len(parts) > 1 else tx
