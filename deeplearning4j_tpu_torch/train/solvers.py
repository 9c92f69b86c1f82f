"""Full-batch optimizers: line search, conjugate gradient, L-BFGS.

Counterpart of the JAX package's `train/solvers.py` (DL4J
`optimize/solvers/`: `BackTrackLineSearch.java:64` (Armijo backtracking
with ALF=1e-4 sufficient decrease and a step cap), `LineGradientDescent`,
`ConjugateGradient.java:40` (Polak-Ribiere gamma = max(dgg/gg, 0) with
automatic restart), `LBFGS.java:39` (two-loop recursion over an m-deep
history)).

The loss and gradient of the FULL batch are one function of the flat
parameter vector (`_flat_loss_fn`): autograd runs through views of that
vector (`util/params.flat_views`) into the container's `_score_fn`, in
inference mode as in the reference, on the network's device. The line
search and direction logic is host control flow, copied from the
reference; each function evaluation is fetched to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.util import params as param_util


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _flat_loss_fn(net, x, y) -> Callable:
    """flat params -> (loss, flat gradient), both on the network's device,
    for the full batch (x, y)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    template = net.params
    state = net.state
    is_graph = isinstance(net, ComputationGraph)

    def value_and_grad(flat: torch.Tensor):
        flat = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            p = param_util.flat_views(flat, template)
            if is_graph:
                loss, _ = net._score_fn(p, state, (x,), (y,), None, None,
                                        False, None)
            else:
                loss, _ = net._score_fn(p, state, x, y, None, None, False,
                                        None)
            (grad,) = torch.autograd.grad(loss, flat)
        return loss.detach(), grad

    return value_and_grad


class BackTrackLineSearch:
    """Armijo backtracking along a search direction
    (BackTrackLineSearch.java:64 semantics: sufficient-decrease constant
    ALF=1e-4, step-norm cap, geometric backtracking)."""

    ALF = 1e-4

    def __init__(self, value_and_grad: Callable, max_iterations: int = 5,
                 step_max: float = 100.0):
        self.value_and_grad = value_and_grad
        self.max_iterations = max_iterations
        self.step_max = step_max

    def optimize(self, flat, f0, g0, direction) \
            -> Tuple[float, torch.Tensor, float]:
        """Returns (step, new_flat, new_loss). direction is a DESCENT
        direction (the step moves along +direction)."""
        slope = _dot(g0, direction)
        if slope >= 0:           # not a descent direction: fall back
            direction = -g0
            slope = _dot(g0, direction)
            if slope >= 0:       # zero gradient
                return 0.0, flat, float(f0)
        dnorm = float(torch.linalg.vector_norm(direction))
        if dnorm > self.step_max:
            direction = direction * (self.step_max / dnorm)
            slope *= self.step_max / dnorm
        step = 1.0
        best = (0.0, flat, float(f0))
        for _ in range(self.max_iterations):
            cand = flat + step * direction
            f_new, _ = self.value_and_grad(cand)
            f_new = float(f_new)
            if np.isfinite(f_new) and \
                    f_new <= float(f0) + self.ALF * step * slope:
                return step, cand, f_new
            if np.isfinite(f_new) and f_new < best[2]:
                best = (step, cand, f_new)
            step *= 0.5
        return best


@dataclasses.dataclass
class _SolverResult:
    scores: List[float]
    iterations: int

    @property
    def final_score(self) -> float:
        return self.scores[-1]


def _full_batch(net, data):
    """(features, labels) on the network's device in its compute dtype."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import as_input, as_labels
    if isinstance(data, tuple):
        x, y = data
    elif isinstance(data, DataSet):
        x, y = data.features, data.labels
    else:
        raise ValueError("solver needs (features, labels) or a DataSet")
    return (as_input(x, net.device, net._compute_dtype),
            as_labels(y, net.device, net._compute_dtype))


class _FullBatchSolver:
    """Shared driver: build the full-batch value_and_grad, iterate
    directions + line searches until tolerance/max_iterations."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6,
                 max_line_search_iterations: int = 8):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.max_line_search_iterations = max_line_search_iterations

    def _direction(self, g, state: dict) -> torch.Tensor:
        raise NotImplementedError

    def optimize(self, net, data) -> _SolverResult:
        x, y = _full_batch(net, data)
        vg = _flat_loss_fn(net, x, y)
        flat = param_util.params_to_flat(net.params).detach()
        ls = BackTrackLineSearch(vg, self.max_line_search_iterations)
        state: dict = {}
        scores = []
        f0, g = vg(flat)
        scores.append(float(f0))
        it = 0
        for it in range(1, self.max_iterations + 1):
            direction = self._direction(g, state)
            step, flat, f_new = ls.optimize(flat, f0, g, direction)
            if step == 0.0:
                break
            f_prev = float(f0)
            f0, g = vg(flat)
            scores.append(float(f0))
            state["last_step"] = step
            if abs(f_prev - float(f0)) < self.tolerance * max(1.0, abs(f_prev)):
                break
        net.set_params_flat(flat)
        net._score = scores[-1]
        return _SolverResult(scores=scores, iterations=it)


class LineGradientDescent(_FullBatchSolver):
    """Steepest descent + backtracking line search
    (LineGradientDescent.java)."""

    def _direction(self, g, state):
        return -g


class ConjugateGradient(_FullBatchSolver):
    """Nonlinear CG, Polak-Ribiere with max(gamma, 0) restart
    (ConjugateGradient.java:40,73-77)."""

    def _direction(self, g, state):
        g_last = state.get("g_last")
        d_last = state.get("d_last")
        if g_last is None:
            d = -g
        else:
            gg = _dot(g_last, g_last)
            dgg = _dot(g - g_last, g)
            gamma = max(dgg / max(gg, 1e-12), 0.0)   # gamma=0 -> restart
            d = -g + gamma * d_last
        state["g_last"] = g
        state["d_last"] = d
        return d


class LBFGS(_FullBatchSolver):
    """Limited-memory BFGS via the two-loop recursion (LBFGS.java:39);
    history depth m=10 like the reference default."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6,
                 max_line_search_iterations: int = 8, m: int = 10):
        super().__init__(max_iterations, tolerance,
                         max_line_search_iterations)
        self.m = m

    def _direction(self, g, state):
        s_hist: List = state.setdefault("s", [])
        y_hist: List = state.setdefault("y", [])
        if "g_last" in state and "x_delta" in state:
            s = state["x_delta"]
            yv = g - state["g_last"]
            sy = _dot(s, yv)
            if sy > 1e-10:          # curvature condition
                s_hist.append(s)
                y_hist.append(yv)
                if len(s_hist) > self.m:
                    s_hist.pop(0)
                    y_hist.pop(0)
        q = g
        alphas = []
        for s, yv in zip(reversed(s_hist), reversed(y_hist)):
            rho = 1.0 / _dot(yv, s)
            a = rho * _dot(s, q)
            alphas.append((a, rho, s, yv))
            q = q - a * yv
        if y_hist:
            s, yv = s_hist[-1], y_hist[-1]
            q = q * (_dot(s, yv) / _dot(yv, yv))
        for a, rho, s, yv in reversed(alphas):
            b = rho * _dot(yv, q)
            q = q + (a - b) * s
        state["g_last"] = g
        return -q

    def optimize(self, net, data):
        # the base loop doesn't expose x between steps; the (s, y) history
        # needs x deltas, so LBFGS runs its own copy of the loop
        x, y = _full_batch(net, data)
        vg = _flat_loss_fn(net, x, y)
        flat = param_util.params_to_flat(net.params).detach()
        ls = BackTrackLineSearch(vg, self.max_line_search_iterations)
        state: dict = {}
        scores = []
        f0, g = vg(flat)
        scores.append(float(f0))
        it = 0
        for it in range(1, self.max_iterations + 1):
            direction = self._direction(g, state)
            step, new_flat, f_new = ls.optimize(flat, f0, g, direction)
            if step == 0.0:
                break
            state["x_delta"] = new_flat - flat
            flat = new_flat
            f_prev = float(f0)
            f0, g = vg(flat)
            scores.append(float(f0))
            if abs(f_prev - float(f0)) < self.tolerance * max(1.0, abs(f_prev)):
                break
        net.set_params_flat(flat)
        net._score = scores[-1]
        return _SolverResult(scores=scores, iterations=it)
