"""The port's full-batch solvers (`train/solvers.py`) against the JAX
package's.

- The reference's checks (tests/test_solvers.py): Armijo's condition on
  ||x||^2, convergence of the three solvers on logistic regression with
  non-increasing scores, L-BFGS ahead of steepest descent, CG on a graph.
- The same f64 network and data through both packages' solvers: the
  score sequences agree within 1e-10 (relative) for the first 5
  iterations, and the iteration counts match; the flat function's
  gradient equals autograd's through the parameter tree.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.train import solvers as jsolvers
from deeplearning4j_tpu.util.serialization import load_model as jax_load
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves
from deeplearning4j_tpu_torch.train import (
    BackTrackLineSearch, ConjugateGradient, LBFGS, LineGradientDescent,
)
from deeplearning4j_tpu_torch.train import solvers
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, save_model,
)

CROSS = 1e-10       # f64 scores across packages, relative


def _blob_data(n=200, d=6, k=3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // k, d)
                        for i in range(k)]).astype("float32")
    Y = np.eye(k, dtype="float32")[np.repeat(np.arange(k), n // k)]
    return X, Y


def _conf(hidden=None, seed=0, dtype="float32"):
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(1e-2))
         .dtype(dtype).list())
    if hidden:
        b = b.layer(DenseLayer(n_out=hidden, activation="tanh"))
    return (b.layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def _logreg(seed=0, dtype="float32"):
    return MultiLayerNetwork(_conf(None, seed, dtype), device="cpu").init()


def _mlp(seed=0, dtype="float32"):
    return MultiLayerNetwork(_conf(12, seed, dtype), device="cpu").init()


# -------------------------------------------------- the reference's checks
def test_backtrack_line_search_sufficient_decrease():
    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = torch.sum(x * x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g
    x0 = torch.full((5,), 3.0)
    f0, g0 = vg(x0)
    ls = BackTrackLineSearch(vg, max_iterations=10)
    step, x1, f1 = ls.optimize(x0, f0, g0, -g0)
    assert step > 0
    slope = float(torch.dot(g0, -g0))
    assert f1 <= float(f0) + ls.ALF * step * slope
    assert f1 < float(f0)
    # not a descent direction: falls back to -g; a zero gradient: no step
    step2, _, _ = ls.optimize(x0, f0, g0, g0)
    assert step2 > 0
    assert ls.optimize(torch.zeros(5), *vg(torch.zeros(5)),
                       torch.zeros(5))[0] == 0.0


@pytest.mark.parametrize("solver_cls",
                         [LineGradientDescent, ConjugateGradient, LBFGS])
def test_solvers_converge_logreg(solver_cls):
    X, Y = _blob_data()
    net = _logreg()
    before = net.score(DataSet(X, Y))
    res = solver_cls(max_iterations=60).optimize(net, (X, Y))
    assert res.final_score < 0.3 * before, res.scores[:5] + res.scores[-3:]
    assert net.evaluate((X, Y)).accuracy() > 0.93
    assert np.all(np.diff(res.scores) <= 1e-6), res.scores
    assert net.score() == res.final_score


def test_lbfgs_beats_gradient_descent_iterations():
    X, Y = _blob_data(seed=3)
    r_gd = LineGradientDescent(max_iterations=25).optimize(_mlp(seed=5),
                                                           (X, Y))
    r_lb = LBFGS(max_iterations=25).optimize(_mlp(seed=5), (X, Y))
    assert r_lb.final_score < r_gd.final_score, \
        (r_lb.final_score, r_gd.final_score)


def test_cg_works_on_graph():
    X, Y = _blob_data()
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(1)
                      .updater(Sgd(1e-2)))
         .add_inputs("in").set_input_types(InputType.feed_forward(6)))
    g.add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "d")
    g.set_outputs("out")
    net = ComputationGraph(g.build(), device="cpu").init()
    res = ConjugateGradient(max_iterations=40).optimize(net, DataSet(X, Y))
    assert res.final_score < res.scores[0] * 0.5
    assert net.evaluate(DataSet(X, Y)).accuracy() > 0.9


def test_a_solver_refuses_other_data():
    with pytest.raises(ValueError, match="features, labels"):
        LBFGS().optimize(_logreg(), [1, 2, 3])


# ------------------------------------------------------ against the reference
@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["LineGradientDescent", "ConjugateGradient",
                                  "LBFGS"])
@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_f64_score_sequences_match_the_reference(name, model, tmp_path,
                                                 x64):
    X, Y = _blob_data(seed=3)
    X, Y = X.astype("float64"), Y.astype("float64")
    net = (_logreg if model == "logreg" else _mlp)(seed=5, dtype="float64")
    path = save_model(net, str(tmp_path / "m.zip"))
    mine = getattr(solvers, name)(max_iterations=8).optimize(
        load_model(path, device="cpu"), (X, Y))
    ref = getattr(jsolvers, name)(max_iterations=8).optimize(
        jax_load(path), (X, Y))
    assert mine.iterations == ref.iterations
    a, b = np.asarray(mine.scores[:6]), np.asarray(ref.scores[:6])
    assert len(a) == len(b) == 6
    np.testing.assert_allclose(a, b, rtol=CROSS, atol=0)


def test_the_flat_function_is_autograd_through_the_tree():
    X, Y = _blob_data()
    net = _mlp(dtype="float64")
    x = torch.from_numpy(X.astype("float64"))
    y = torch.from_numpy(Y.astype("float64"))
    vg = solvers._flat_loss_fn(net, x, y)
    loss, g = vg(net.params_flat())
    live = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
            for k, v in net.params.items()}
    with torch.enable_grad():
        want, _ = net._score_fn(live, net.state, x, y, None, None, False)
        grads = torch.autograd.grad(want, tree_leaves(live))
    assert float(loss) == float(want.detach())
    assert torch.equal(g, torch.cat([t.reshape(-1) for t in grads]))
