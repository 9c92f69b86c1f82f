"""The port's manifold package (`manifold/*`) against the JAX package's.

- Every non-slow case of `tests/test_bhtsne.py` and the t-SNE case of
  `tests/test_apps.py` run against the port on the CPU
  (`_torch_reference_cases.port_cases`); `test_apps.py`'s Barnes-Hut case
  is rewritten here, its compiled-memory check (XLA's memory analysis)
  replaced by a `TorchDispatchMode` that records every tensor the tiled
  gradient makes: none may exceed tile x N elements (so none reaches the
  reference's bound of N^2 / 2). The slow wall-clock case has a
  counterpart at N = 10,000 without the timing: Barnes-Hut's Z within 2 %
  of a blocked exact Z, its visits under 0.03 N^2.
- The pieces: `_hbeta` and `_binary_search_perplexity` within 1e-5
  relative; `_tsne_grad` and `_tiled_forces` (with and without pad rows,
  and on the reference's own `_build_sparse_p` edges) with the gradient
  within 1e-5 of its largest |value| and the KL within 1e-5 relative;
  `_knn_affinity_tile` with equal neighbour sets (the data has no row
  whose k-th and (k+1)-th distances lie within 1e-5 relative, which the
  test asserts) and p within 1e-5; `PySpTree` and `bh_repulsion`
  (native, below its OpenMP threshold, and Python) bitwise.
- The fits start from the reference's init Y (bitwise the same numpy).
  A one-ulp change of the reference's own input moves its Y by 3e-3 to
  0.27 of max |Y| within 10 iterations, so the first 10 iterations are
  held with the gradient a shared input: `Tsne` and `BarnesHutTsne` at
  theta 0 on the reference's gradients stay within 1e-4 of the largest
  |Y| (each step's P and gradient checked on the reference's Y); at theta
  0.5 on the reference's edges, bitwise. The full fits' final KL within
  5 % of the reference's, at 600 points, where the reference's own KL
  moves less than that under a one-ulp change (checked).
- Without CUDA the default device raises; ``device="cpu"`` runs; theta > 0
  without the native library takes the exact path, as the reference.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu.manifold import (
    BarnesHutTsne as RBH, Tsne as RTsne, bhtsne as rbh, sptree as rsp,
    tsne as rts,
)
from deeplearning4j_tpu_torch import native as pnative
from deeplearning4j_tpu_torch.manifold import (
    BarnesHutTsne, Tsne, bhtsne as pbh, sptree as psp, tsne as pts,
)

_DEV = (("BarnesHutTsne(", "BarnesHutTsne(device='cpu', "),
        (" Tsne(", " Tsne(device='cpu', "))
_BHTSNE = port_cases("tests/test_bhtsne.py", names=(
    "_brute_repulsion", "test_sptree_structure_invariants",
    "test_bh_repulsion_matches_bruteforce_small_theta",
    "test_native_and_python_trees_agree",
    "test_bh_visits_scale_sub_quadratically",
    "test_bh_tsne_separates_clusters_and_tracks_exact_kl",
    "test_sptree_preserves_duplicate_multiplicity"), extra_subs=_DEV)
_APPS = port_cases("tests/test_apps.py", names=(
    "_three_blobs", "test_tsne_separates_blobs"), extra_subs=_DEV)
REFERENCE_CASES = [(m, n) for m in ("bhtsne", "apps")
                   for n in sorted(vars(_BHTSNE if m == "bhtsne" else _APPS))
                   if n.startswith("test_")]
_three_blobs = _APPS._three_blobs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of iterations of tiny ops: one CPU thread keeps them out
    of OpenMP regions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("module,name", REFERENCE_CASES)
def test_reference_case(module, name, request):
    run_case(_BHTSNE if module == "bhtsne" else _APPS, name, request)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close_grad(ours, theirs, tol=1e-5):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert np.abs(ours - theirs).max() <= tol * np.abs(theirs).max()


def _sqdist(X):
    d2 = ((X[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    return d2.astype(np.float32)


def _exact_conditional(d2, perplexity):
    """The reference's 50-step precision bisection, row-wise, in f64
    numpy: the exact conditional probabilities of distance rows `d2`."""
    d2 = np.asarray(d2, np.float64)
    target = np.log(perplexity)
    beta = np.ones(len(d2))
    lo, hi = np.full(len(d2), -np.inf), np.full(len(d2), np.inf)
    for _ in range(50):
        p = np.exp(-d2 * beta[:, None])
        s = np.maximum(p.sum(1), 1e-12)
        h = np.log(s) + beta * (d2 * p).sum(1) / s
        high = h > target
        lo, hi = np.where(high, beta, lo), np.where(high, hi, beta)
        beta = np.where(np.isinf(hi), beta * 2,
                        np.where(np.isinf(lo), beta / 2, (lo + hi) / 2))
    p = np.exp(-d2 * beta[:, None])
    return p / np.maximum(p.sum(1), 1e-12)[:, None]


def _exact_joint_p(X, perplexity):
    d2 = ((X[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, 1e12)
    P = _exact_conditional(d2, perplexity)
    np.fill_diagonal(P, 0.0)
    return (P + P.T) / (P + P.T).sum()


def _exact_edge_p(X, dst, perplexity):
    """Exact p_ij / (2N) of the edge list (src repeating each row k
    times, `dst` its neighbours)."""
    n = len(X)
    nbr = dst.reshape(n, -1)
    d2 = ((X[:, None].astype(np.float64) - X[nbr]) ** 2).sum(-1)
    return (_exact_conditional(d2, perplexity) / (2.0 * n)).reshape(-1)


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("beta", [1e-3, 0.5, 1.0, 7.0])
def test_hbeta_is_the_references(beta):
    rs = np.random.RandomState(0)
    d2 = (rs.rand(40) * 20).astype(np.float32)
    h, p = pts._hbeta(_t(d2), beta)
    rh, rp = rts._hbeta(d2, np.float32(beta))
    assert float(h) == pytest.approx(float(rh), rel=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n,d,perplexity", [(60, 4, 5.0), (150, 8, 20.0),
                                            (90, 30, 29.0)])
def test_binary_search_perplexity_is_the_references(n, d, perplexity):
    import jax.numpy as jnp
    X = np.random.RandomState(n).randn(n, d).astype(np.float32)
    d2 = _sqdist(X)
    np.fill_diagonal(d2, 1e12)
    ours = pts._binary_search_perplexity(_t(d2), np.log(perplexity))
    theirs = np.asarray(rts._binary_search_perplexity(
        jnp.asarray(d2), jnp.float32(np.log(perplexity))))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours.sum(1).numpy(), 1.0, rtol=1e-5)


def _close_to_reference(ours, theirs, exact, tol=1e-5):
    """The port's value within `tol` of the reference's largest |value|;
    or, where `exact` (an f64 evaluation independent of both packages)
    shows the reference itself off by more than that, the port within
    `tol` of `exact`: the distance expansion cancels (|y|^2 against d^2),
    so at some scales the reference lies 5e-5 from the exact value."""
    ours, theirs, exact = (np.asarray(a, np.float64)
                           for a in (ours, theirs, exact))
    slack = tol * np.abs(theirs).max()
    gap = np.abs(ours - theirs).max()
    if gap <= slack:
        return
    ref_err, our_err = (np.abs(a - exact).max() for a in (theirs, ours))
    assert ref_err > slack and our_err <= slack, (gap, ref_err, our_err,
                                                  slack)


def _exact_tsne_grad(Y, P):
    """The exact t-SNE gradient and KL in f64 numpy, written from the
    formulas: 4 (diag(rowsum PQ) - PQ) Y with PQ = (P - Q) * num."""
    Y, P = np.asarray(Y, np.float64), np.asarray(P, np.float64)
    num = 1.0 / (1.0 + ((Y[:, None] - Y[None]) ** 2).sum(-1))
    np.fill_diagonal(num, 0.0)
    Q = np.maximum(num / max(num.sum(), 1e-12), 1e-12)
    PQ = (P - Q) * num
    grad = 4.0 * (np.diag(PQ.sum(1)) - PQ) @ Y
    return grad, (P * np.log(np.maximum(P, 1e-12) / Q)).sum()


def _exact_tiled_forces(Y, src, dst, p, n_valid):
    """The tiled gradient's value in f64 numpy without tiles: repulsion
    over every pair of the first `n_valid` rows, attraction over the
    edges; the pad rows' gradient is 0."""
    Y, p = np.asarray(Y, np.float64), np.asarray(p, np.float64)
    Yv = Y[:n_valid]
    num = 1.0 / (1.0 + ((Yv[:, None] - Yv[None]) ** 2).sum(-1))
    np.fill_diagonal(num, 0.0)
    z = max(num.sum(), 1e-12)
    n2 = num * num
    frep = Yv * n2.sum(1)[:, None] - n2 @ Yv
    dy = Y[src] - Y[dst]
    num_e = 1.0 / (1.0 + (dy * dy).sum(1))
    f_e = (p * num_e)[:, None] * dy
    fatt = np.zeros_like(Y)
    np.add.at(fatt, src, f_e)
    np.add.at(fatt, dst, -f_e)
    grad = np.zeros_like(Y)
    grad[:n_valid] = 4.0 * (fatt[:n_valid] - frep / z)
    kl = (p * np.log(np.maximum(p, 1e-12) / np.maximum(num_e / z, 1e-12)))
    return grad, kl.sum()


@pytest.mark.parametrize("n,scale", [(50, 1.0), (200, 1e-3), (120, 8.0),
                                     (90, 1e-4)])
def test_tsne_grad_is_the_references(n, scale):
    rs = np.random.RandomState(n)
    Y = (rs.randn(n, 2) * scale).astype(np.float32)
    P = rs.rand(n, n).astype(np.float32)
    np.fill_diagonal(P, 0.0)
    P = (P + P.T) / (P + P.T).sum()
    grad, kl = pts._tsne_grad(_t(Y), _t(P))
    rgrad, rkl = rts._tsne_grad(Y, P)
    exact, exact_kl = _exact_tsne_grad(Y, P)
    _close_to_reference(grad.numpy(), rgrad, exact)
    _close_to_reference(kl.numpy(), rkl, exact_kl)


@pytest.mark.parametrize("rows,k", [((0, 64), 30), ((100, 164), 12),
                                    ((250, 300), 45)])
def test_knn_affinity_tile_is_the_references(rows, k):
    import jax.numpy as jnp
    X = np.random.RandomState(7).randn(300, 10).astype(np.float32)
    rows = np.arange(*rows)
    d2 = _sqdist(X)[rows]
    d2[np.arange(len(rows)), rows] = np.inf
    kth = np.sort(d2, 1)[:, k - 1:k + 1]
    assert np.all(kth[:, 1] - kth[:, 0] > 1e-5 * kth[:, 1]), \
        "a row's k-th and (k+1)-th neighbours nearly tie: pick other data"
    target = np.float32(np.log(k / 3.0))
    idx, p = pbh._knn_affinity_tile(_t(X), rows, k, target)
    ridx, rp = rbh._knn_affinity_tile(jnp.asarray(X), jnp.asarray(rows), k,
                                      jnp.float32(target))
    ridx, rp = np.asarray(ridx), np.asarray(rp)
    for i in range(len(rows)):        # by (distance, index): ties reorder
        ours = sorted(zip(d2[i, idx[i].numpy()], idx[i].numpy()))
        theirs = sorted(zip(d2[i, ridx[i]], ridx[i]))
        assert ours == theirs
        o = dict(zip(idx[i].numpy(), p[i].numpy()))
        np.testing.assert_allclose([o[j] for j in ridx[i]], rp[i],
                                   rtol=1e-5, atol=1e-7)


def _edges(n, k, seed):
    rs = np.random.RandomState(seed)
    src = np.repeat(np.arange(n), k)
    dst = rs.randint(0, n, n * k)
    p = (rs.rand(n * k) / (n * k)).astype(np.float32)
    return src, dst, p


@pytest.mark.parametrize("n,n_valid,tile,scale", [
    (256, 256, 32, 1.0), (256, 250, 64, 3.0), (300, 290, 100, 0.01)])
def test_tiled_forces_is_the_references(n, n_valid, tile, scale):
    import jax.numpy as jnp
    rs = np.random.RandomState(n_valid)
    Y = (rs.randn(n, 2) * scale).astype(np.float32)
    Y[n_valid:] = 1e6                          # the fit's pad rows
    src, dst, p = _edges(n_valid, 6, n)
    grad, kl = pbh._tiled_forces(_t(Y), _t(src), _t(dst), n // tile, _t(p),
                                 n_valid)
    rgrad, rkl = rbh._tiled_forces(jnp.asarray(Y), jnp.asarray(src),
                                   jnp.asarray(dst), n // tile,
                                   jnp.asarray(p), jnp.int32(n_valid))
    _close_grad(grad[:n_valid], np.asarray(rgrad)[:n_valid])
    assert np.all(np.asarray(rgrad)[n_valid:] == 0.0)
    assert torch.all(grad[n_valid:] == 0.0)
    assert float(kl) == pytest.approx(float(rkl), rel=1e-5)


@pytest.mark.parametrize("perplexity", [5.0, 15.0])
def test_sparse_p_and_its_forces_are_the_references(perplexity):
    """The reference's `_build_sparse_p` edges against the port's, then
    both packages' forces on the reference's edges."""
    import jax.numpy as jnp
    X, _ = _three_blobs(n_per=40)
    rs_, rd, rv = RBH(perplexity=perplexity, tile_rows=32)._build_sparse_p(
        X, perplexity)
    ps, pd, pv = BarnesHutTsne(perplexity=perplexity, tile_rows=32,
                               device="cpu")._build_sparse_p(X, perplexity)
    assert np.array_equal(ps, rs_)
    k = len(rd) // len(X)
    ordered = np.empty_like(pv)
    for i in range(len(X)):
        sl = slice(i * k, (i + 1) * k)
        assert set(pd[sl]) == set(rd[sl])
        o = dict(zip(pd[sl], pv[sl]))
        ordered[sl] = [o[j] for j in rd[sl]]
    _close_to_reference(ordered, rv, _exact_edge_p(X, rd, perplexity))
    Y = np.random.RandomState(3).randn(len(X), 2).astype(np.float32)
    grad, kl = pbh._tiled_forces(_t(Y), _t(rs_), _t(rd), 4, _t(rv), len(X))
    rgrad, rkl = rbh._tiled_forces(jnp.asarray(Y), jnp.asarray(rs_),
                                   jnp.asarray(rd), 4, jnp.asarray(rv),
                                   jnp.int32(len(X)))
    _close_grad(grad, rgrad)
    assert float(kl) == pytest.approx(float(rkl), rel=1e-5)


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.sizes += [t.numel() for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)]
        return out


def test_barnes_hut_tsne_scales_with_tiled_memory():
    """test_apps.py's Barnes-Hut case: separation like the exact version,
    KL falling after early exaggeration, and every tensor of one gradient
    evaluation at N = 1024, tile 64 within tile x N elements."""
    X, y = _three_blobs(n_per=40)
    bh = BarnesHutTsne(perplexity=10, max_iter=300, tile_rows=32, seed=0,
                       device="cpu")
    Y = bh.fit_transform(X)
    assert Y.shape == (120, 2)
    assert np.isfinite(bh.kl_divergence_)
    cents = np.stack([Y[y == c].mean(0) for c in range(3)])
    intra = np.mean([np.linalg.norm(Y[y == c] - cents[c], axis=1).mean()
                     for c in range(3)])
    inter = np.mean([np.linalg.norm(cents[a] - cents[b])
                     for a in range(3) for b in range(a + 1, 3)])
    assert inter > 2 * intra, (inter, intra)
    post = bh.kl_history_[2:]
    assert post and all(k <= bh.kl_history_[1] + 1e-6 for k in post), \
        bh.kl_history_

    n, k, tile = 1024, 8, 64
    Yb = _t(np.random.RandomState(0).randn(n, 2).astype(np.float32))
    src, dst, p = _edges(n, k, 0)
    with _Sizes() as mode:
        grad, _ = pbh._tiled_forces(Yb, _t(src), _t(dst), n // tile, _t(p), n)
    assert grad.shape == (n, 2)
    assert max(mode.sizes) == tile * n < n * n // 2, max(mode.sizes)


def test_barnes_hut_z_at_10k_tracks_the_exact_z():
    """test_bhtsne.py's slow wall-clock case without the timing."""
    rs = np.random.RandomState(5)
    n = 10_000
    Y = (rs.randn(n, 2) * 5).astype(np.float32)
    _, z_bh, visits = psp.bh_repulsion(Y, theta=0.5)
    z_np = 0.0
    for s in range(0, n, 2000):
        d2 = ((Y[s:s + 2000, None, :] - Y[None, :, :]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        idx = np.arange(s, min(s + 2000, n))
        num[np.arange(len(idx)), idx] = 0.0
        z_np += num.sum()
    assert abs(z_bh - z_np) / z_np < 0.02
    assert visits < 0.03 * n * n


# ------------------------------------------------------------ the sp-tree
@pytest.mark.parametrize("n,dim,theta", [(200, 2, 0.5), (256, 3, 0.3),
                                         (150, 1, 0.0)])
def test_native_bh_repulsion_is_bitwise_the_references(n, dim, theta):
    assert pnative.available()
    Y = np.random.RandomState(n).randn(n, dim).astype(np.float32)
    before = pnative.CALLS["bh_repulsion_f32"]
    neg, z, visits = psp.bh_repulsion(Y, theta)
    assert pnative.CALLS["bh_repulsion_f32"] == before + 1
    rneg, rz, rvisits = rsp.bh_repulsion(Y, theta)
    assert np.array_equal(neg, rneg) and z == rz and visits == rvisits


@pytest.mark.parametrize("n,dim,theta", [(300, 2, 0.5), (120, 3, 0.2),
                                         (64, 4, 0.5)])
def test_python_sptree_is_bitwise_the_references(n, dim, theta):
    Y = np.random.RandomState(n + dim).randn(n, dim).astype(np.float32)
    Y[5] = Y[6]                                # a merged duplicate
    ours, theirs = psp.PySpTree(Y), rsp.PySpTree(Y)
    assert ours.count == theirs.count and ours.hw == theirs.hw
    assert ours.child_base == theirs.child_base
    assert all(np.array_equal(a, b) for a, b in zip(ours.com, theirs.com))
    neg, z, visits = ours.repulsion(theta)
    rneg, rz, rvisits = theirs.repulsion(theta)
    assert np.array_equal(neg, rneg) and z == rz and visits == rvisits
    if dim > 3:               # past the native gate: the Python tree
        assert psp.bh_repulsion(Y, theta)[2] == visits


# ------------------------------------------------------------------- fits
def test_init_embedding_is_bitwise_the_references():
    X, _ = _three_blobs(n_per=30)
    for pca in (True, False):
        ours = BarnesHutTsne(use_pca_init=pca, seed=4, device="cpu")
        theirs = RBH(use_pca_init=pca, seed=4)
        assert np.array_equal(ours._init_embedding(X),
                              theirs._init_embedding(X))
        assert np.array_equal(
            pts._init_embedding(X, 2, pca, 4), theirs._init_embedding(X))


def _recorder(module, name, log):
    real = getattr(module, name)

    def rec(*args):
        out = real(*args)
        log.append([np.asarray(a) if not isinstance(a, torch.Tensor)
                    else a.clone() for a in args] + [np.asarray(out[0])])
        return out
    return rec


def _replayer(module, name, log, grads):
    """Hands the port's loop the reference's gradients, in order, and
    records what the loop passed in."""
    real = getattr(module, name)

    def replay(*args):
        _, kl = real(*args)
        log.append([a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args])
        return torch.tensor(np.array(grads[len(log) - 1])), kl
    return replay


@pytest.mark.parametrize("case", ["tsne", "bh_theta0"])
def test_ten_iterations_on_the_references_gradients(case, monkeypatch):
    """Ten iterations with the gradient a shared input: a one-ulp change of
    the reference's own X moves its Y by 3e-3 to 0.27 of max |Y| within
    ten iterations (the gains' sign test amplifies ulps), so the port's
    loop is held on the reference's gradients. Each step's Y within 1e-4
    of max |Y|, the exaggerated P within 1e-5, and the port's gradient at
    the reference's Y within the gradient's bound."""
    X, _ = _three_blobs(n_per=30)
    if case == "tsne":
        rmod, pmod, name = rts, pts, "_tsne_grad"
        make = (lambda m: (RTsne if m is rts else Tsne)(
            max_iter=10, perplexity=10, seed=0,
            **({} if m is rts else {"device": "cpu"})))
    else:
        rmod, pmod, name = rbh, pbh, "_tiled_forces"
        make = (lambda m: (RBH if m is rbh else BarnesHutTsne)(
            max_iter=10, perplexity=10, theta=0.0, tile_rows=32, seed=1,
            **({} if m is rbh else {"device": "cpu"})))
    ref_log, port_log = [], []
    monkeypatch.setattr(rmod, name, _recorder(rmod, name, ref_log))
    rY = np.asarray(make(rmod).fit_transform(X))
    grads = [r[-1] for r in ref_log]
    real = getattr(pmod, name)
    monkeypatch.setattr(pmod, name, _replayer(pmod, name, port_log, grads))
    Y = make(pmod).fit_transform(X)
    assert len(port_log) == len(ref_log) == 10
    if case == "tsne":
        p_exact = _exact_joint_p(X, 10.0)
    else:
        p_exact = _exact_edge_p(X, ref_log[0][2], 10.0)
    big = np.abs(rY).max()
    assert np.abs(Y - rY).max() <= 1e-4 * big
    for ours, theirs in zip(port_log, ref_log):
        n = len(X)
        yo, yr = ours[0].numpy()[:n], theirs[0][:n]
        assert np.abs(yo - yr).max() <= 1e-4 * max(np.abs(yr).max(), 1e-30)
        po, pr = ours[1 if case == "tsne" else 4], theirs[
            1 if case == "tsne" else 4]
        _close_to_reference(po.numpy(), pr, p_exact * 12.0)  # exaggerated
        if case == "bh_theta0":
            assert np.array_equal(ours[2].numpy(), theirs[2])
        args = [_t(a) for a in theirs[:-1]]
        if case == "tsne":
            exact, _ = _exact_tsne_grad(*theirs[:2])
        else:
            args[3], args[5] = int(theirs[3]), int(theirs[5])
            exact, _ = _exact_tiled_forces(*(theirs[i] for i in (0, 1, 2, 4)),
                                           int(theirs[5]))
        grad, _ = real(*args)
        _close_to_reference(grad.numpy(), theirs[-1], exact)


def test_ten_barnes_hut_iterations_are_bitwise_on_the_references_edges():
    """theta > 0: the host loop over the native tree, given the reference's
    affinity graph, is bitwise the reference's."""
    X, _ = _three_blobs(n_per=30)
    kw = dict(max_iter=10, perplexity=10, theta=0.5, seed=1)
    ref = RBH(**kw)
    edges = ref._build_sparse_p(X, 10.0)
    assert np.array_equal(
        BarnesHutTsne(device="cpu", **kw)._fit_barnes_hut(X, *edges),
        ref._fit_barnes_hut(X, *edges))


FIT_CASES = {
    "tsne": (lambda **kw: Tsne(device="cpu", **kw), RTsne,
             dict(perplexity=30, seed=0)),
    "bh_theta0": (lambda **kw: BarnesHutTsne(device="cpu", **kw), RBH,
                  dict(perplexity=30, theta=0.0, tile_rows=64, seed=1)),
    "bh_theta05": (lambda **kw: BarnesHutTsne(device="cpu", **kw), RBH,
                   dict(perplexity=30, theta=0.5, seed=1)),
}


@pytest.fixture(scope="module")
def reference_fits():
    """600 points: at the reference tests' 90 their own final KL moves by
    up to 3x when half of X moves by one ulp; here such a move stays
    within 5 %, which this fixture checks."""
    X, _ = _three_blobs(n_per=200)
    nudged = np.where(np.random.RandomState(0).rand(*X.shape) < 0.5,
                      np.nextafter(X, np.inf), X).astype(np.float32)
    out = {}
    for case, (_, ref, kw) in FIT_CASES.items():
        kls = []
        for data in (X, nudged):
            est = ref(max_iter=300, **kw)
            est.fit_transform(data)
            kls.append(est.kl_divergence_)
        assert abs(kls[1] - kls[0]) <= 0.05 * abs(kls[0]), (case, kls)
        out[case] = kls[0]
    return X, out


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_full_fit_kl_is_within_5_percent_of_the_reference(case,
                                                           reference_fits):
    X, kls = reference_fits
    port, _, kw = FIT_CASES[case]
    est = port(max_iter=300, **kw)
    Y = est.fit_transform(X)
    assert Y.shape == (600, 2) and np.all(np.isfinite(Y))
    assert abs(est.kl_divergence_ - kls[case]) <= 0.05 * abs(kls[case])


def test_theta_without_native_takes_the_exact_path(monkeypatch, caplog):
    X, _ = _three_blobs(n_per=20)
    exact = BarnesHutTsne(perplexity=8, theta=0.0, max_iter=20,
                          device="cpu").fit_transform(X)
    monkeypatch.setattr(pnative, "available", lambda: False)
    with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch"):
        est = BarnesHutTsne(perplexity=8, theta=0.5, max_iter=20,
                            device="cpu")
        Y = est.fit_transform(X)
    assert np.array_equal(Y, exact)
    assert not hasattr(est, "cells_visited_")
    assert "exact device-tiled repulsion" in caplog.text


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
@pytest.mark.parametrize("cls", [Tsne, BarnesHutTsne])
def test_default_device_is_cuda_and_raises_without_it(cls):
    with pytest.raises(RuntimeError, match="CUDA"):
        cls()
    assert cls(device="cpu").device.type == "cpu"
