"""The port's clustering package (`clustering/*`) against the JAX package's.

- Every non-slow clustering case of `tests/test_apps.py` and both server
  cases of `tests/test_server_cli.py` run against the port
  (`_torch_reference_cases.port_cases`; k-means on the CPU).
- The host modules give the reference's answers bitwise: `VPTree` (both
  metrics), `KDTree`, `RandomProjectionLSH`, `RandomProjection` and
  `jl_target_dim` (the same RandomState seeds, the same numpy).
- The server answers every request with the reference server's JSON and
  status, rejections and answers after a rebuild included, and each
  package's client works against the other's server.
- k-means: the seeded centers, the fitted centers, `iterations_done` and
  `predict` bitwise, `inertia` within 1e-6 relative; the data of each
  case has no near-tie row (two nearest centers within 1e-5 relative),
  which the test asserts. The points go to the device once a fit.
- Without CUDA the default device raises; ``device="cpu"`` runs.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu import clustering as rcl
from deeplearning4j_tpu.clustering import randomprojection as rrp
from deeplearning4j_tpu_torch import clustering as pcl
from deeplearning4j_tpu_torch.clustering import kmeans as pkm
from deeplearning4j_tpu_torch.clustering import randomprojection as prp

_APPS = port_cases("tests/test_apps.py", names=(
    "_three_blobs", "test_kmeans_recovers_blobs",
    "test_vptree_matches_bruteforce", "test_kdtree_matches_bruteforce",
    "test_lsh_finds_close_neighbors",
    "test_random_projection_preserves_distances"),
    extra_subs=(("KMeansClustering(", "KMeansClustering(device='cpu', "),))
_SERVER = port_cases("tests/test_server_cli.py", names=(
    "test_nn_server_round_trip", "test_nn_server_rejects_bad_requests"))
REFERENCE_CASES = [(m, n) for m in ("apps", "server")
                   for n in sorted(vars(_APPS if m == "apps" else _SERVER))
                   if n.startswith("test_")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one CPU thread keeps them out of OpenMP regions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("module,name", REFERENCE_CASES)
def test_reference_case(module, name, request):
    run_case(_APPS if module == "apps" else _SERVER, name, request)


def _blobs(n_per, d, n_blobs, seed, spread=8.0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_blobs, d) * spread
    return np.concatenate([centers[i] + rs.randn(n_per, d)
                           for i in range(n_blobs)]).astype(np.float32)


# ------------------------------------------------------------ host trees
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_vptree_is_bitwise_the_reference(metric, k):
    X = _blobs(40, 8, 3, 0)
    ours, theirs = pcl.VPTree(X, metric=metric, seed=3), \
        rcl.VPTree(X, metric=metric, seed=3)

    def walk(node):
        if node is None:
            return None
        return (node.index, node.threshold, walk(node.inside),
                walk(node.outside))
    assert walk(ours.root) == walk(theirs.root)
    rs = np.random.RandomState(1)
    for q in list(rs.randn(6, 8).astype(np.float32) * 4) + [X[7]]:
        assert ours.knn(q, k) == theirs.knn(q, k)


@pytest.mark.parametrize("d,k", [(2, 1), (3, 4), (6, 9)])
def test_kdtree_is_bitwise_the_reference(d, k):
    X = _blobs(50, d, 3, 2)
    ours, theirs = pcl.KDTree(X), rcl.KDTree(X)
    rs = np.random.RandomState(2)
    for q in rs.randn(8, d).astype(np.float32) * 5:
        assert ours.knn(q, k) == theirs.knn(q, k)
        assert ours.nn(q) == theirs.nn(q)


@pytest.mark.parametrize("bits,tables,seed", [(8, 6, 0), (16, 4, 3),
                                              (4, 2, 5)])
def test_lsh_is_bitwise_the_reference(bits, tables, seed):
    X = _blobs(60, 12, 3, 4)
    ours = pcl.RandomProjectionLSH(bits, tables, seed).fit(X)
    theirs = rcl.RandomProjectionLSH(bits, tables, seed).fit(X)
    assert np.array_equal(ours._planes, theirs._planes)
    assert [dict(t) for t in ours._tables] == \
        [dict(t) for t in theirs._tables]
    rs = np.random.RandomState(seed)
    for q in list(X[:3]) + list(rs.randn(3, 12).astype(np.float32) * 9):
        assert ours.query(q, 5) == theirs.query(q, 5)


@pytest.mark.parametrize("target,seed", [(4, 0), (32, 7), (100, 1)])
def test_random_projection_is_bitwise_the_reference(target, seed):
    X = _blobs(30, 64, 2, 5)
    ours = prp.RandomProjection(target, seed)
    theirs = rrp.RandomProjection(target, seed)
    assert np.array_equal(ours.transform(X), theirs.transform(X))
    assert np.array_equal(ours.fit(X[:5])._proj, theirs.fit(X[:5])._proj)


@pytest.mark.parametrize("n,eps", [(10, 0.1), (1000, 0.3), (70000, 0.5)])
def test_jl_target_dim_is_the_references(n, eps):
    assert prp.jl_target_dim(n, eps) == rrp.jl_target_dim(n, eps)


# ---------------------------------------------------------------- server
def _call(port, method, route, payload=None):
    url = f"http://127.0.0.1:{port}{route}"
    data = None if payload is None else (
        payload if isinstance(payload, bytes) else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _session(port, dim, rs):
    """One fixed sequence of requests: reads, rejections, inserts past the
    rebuild threshold, then reads again."""
    out = [_call(port, "GET", "/health"),
           _call(port, "GET", "/nope"),
           _call(port, "POST", "/knn", {"index": 3, "k": 4}),
           _call(port, "POST", "/knn", {"index": 999, "k": 1}),
           _call(port, "POST", "/knn", {"k": 1}),
           _call(port, "POST", "/knn", b"{not json"),
           _call(port, "POST", "/knnnew",
                 {"arr": rs.randn(dim).tolist(), "k": 6}),
           _call(port, "POST", "/knnnew", {"arr": [1.0, 2.0], "k": 2}),
           _call(port, "POST", "/insert", {"arr": [0.0] * (dim + 1)}),
           _call(port, "POST", "/other", {})]
    for _ in range(5):                  # threshold 4: one rebuild, one extra
        out.append(_call(port, "POST", "/insert",
                         {"arr": rs.randn(dim).tolist()}))
    out += [_call(port, "GET", "/health"),
            _call(port, "POST", "/knn", {"index": 30, "k": 3}),
            _call(port, "POST", "/knn", {"index": 34, "k": 5}),
            _call(port, "POST", "/knnnew",
                  {"arr": rs.randn(dim).tolist(), "k": 8})]
    return out


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_server_answers_are_the_reference_servers(metric):
    pts = _blobs(10, 5, 3, 6)
    answers = []
    for pkg in (pcl, rcl):
        with pkg.NearestNeighborsServer(pts, port=0, metric=metric,
                                        rebuild_threshold=4) as server:
            answers.append(_session(server.port, 5,
                                    np.random.RandomState(9)))
            assert len(server._extra) == 1 and len(server.points) == 34
    assert answers[0] == answers[1]
    codes = [c for c, _ in answers[0]]
    assert codes.count(400) == 5 and codes.count(404) == 2


@pytest.mark.parametrize("server_pkg,client_pkg", [(pcl, rcl), (rcl, pcl)])
def test_each_client_talks_to_the_other_server(server_pkg, client_pkg):
    rs = np.random.RandomState(0)
    pts = rs.randn(64, 8).astype(np.float32)
    q = rs.randn(8).astype(np.float32)
    with server_pkg.NearestNeighborsServer(pts, port=0) as server:
        client = client_pkg.NearestNeighborsClient(port=server.port)
        assert client.health() == {"status": "ok", "points": 64, "dim": 8}
        res = client.knn_new(q, k=5)
        assert [r["index"] for r in res] == \
            list(np.argsort(np.linalg.norm(pts - q, axis=1))[:5])
        assert client.insert(q) == 64
        assert client.knn(64, k=1)[0]["index"] == 64


# ---------------------------------------------------------------- k-means
KMEANS_CASES = {
    "three_blobs_k3": (lambda: _blobs(50, 8, 3, 0), 3, 1, 100),
    "three_blobs_k1": (lambda: _blobs(50, 8, 3, 0), 1, 1, 100),
    "five_blobs_k5": (lambda: _blobs(40, 16, 5, 2), 5, 4, 100),
    "six_blobs_k4": (lambda: _blobs(30, 3, 6, 3, spread=6.0), 4, 0, 100),
    "wide_k8_two_steps": (lambda: _blobs(25, 64, 8, 5), 8, 2, 2),
}


def _no_near_ties(X, centers):
    d = np.sort(np.linalg.norm(X[:, None] - centers[None], axis=-1), 1)
    if d.shape[1] > 1:
        assert np.all(d[:, 1] - d[:, 0] > 1e-5 * d[:, 1]), \
            "the case's data has a near-tie row: pick other data"


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_kmeans_is_the_reference(case):
    make, k, seed, iters = KMEANS_CASES[case]
    X = make()
    ours = pcl.KMeansClustering(k=k, seed=seed, max_iterations=iters,
                                device="cpu")
    theirs = rcl.KMeansClustering(k=k, seed=seed, max_iterations=iters)
    assert np.array_equal(ours._init_centers(X, np.random.RandomState(seed)),
                          theirs._init_centers(X, np.random.RandomState(seed)))
    ours.fit(X)
    theirs.fit(X)
    _no_near_ties(X, theirs.centers)
    assert np.array_equal(ours.centers, theirs.centers)
    assert ours.iterations_done == theirs.iterations_done
    Q = np.concatenate([X, _blobs(10, X.shape[1], 2, 11)])
    _no_near_ties(Q, theirs.centers)
    assert np.array_equal(ours.predict(Q), theirs.predict(Q))
    assert ours.inertia(Q) == pytest.approx(theirs.inertia(Q), rel=1e-6)


def test_kmeans_assign_is_the_references():
    from deeplearning4j_tpu.clustering.kmeans import _assign as r_assign
    X = _blobs(30, 10, 4, 8)
    C = X[[0, 40, 80, 119]]
    ri, rd = r_assign(X, C)
    pi, pd = pkm._assign(torch.as_tensor(X), torch.as_tensor(C))
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    # squared distances: the expansion cancels to ~1e-7 of |x|^2 on two
    # BLASes, which the square root blows up near 0 (a center's own row)
    np.testing.assert_allclose(pd.numpy() ** 2, np.asarray(rd) ** 2,
                               rtol=1e-5, atol=1e-6 * (X ** 2).sum(1).max())
    zero = pkm._assign(torch.as_tensor(C), torch.as_tensor(C))[1]
    assert torch.all(zero >= 0) and torch.all(torch.isfinite(zero))


def test_kmeans_moves_the_points_once_a_fit(monkeypatch):
    seen = []
    real = pkm._assign

    def spy(points, centers):
        seen.append(points)
        return real(points, centers)
    monkeypatch.setattr(pkm, "_assign", spy)
    km = pcl.KMeansClustering(k=3, seed=1, device="cpu").fit(
        _blobs(20, 4, 3, 0))
    assert len(seen) == km.iterations_done > 1
    assert all(p is seen[0] for p in seen)


def test_kmeans_rejects_other_distances():
    with pytest.raises(ValueError):
        pcl.KMeansClustering(k=2, distance="cosine", device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
def test_kmeans_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        pcl.KMeansClustering(k=2)
    km = pcl.KMeansClustering(k=2, device="cpu")
    assert km.device.type == "cpu"
    assert isinstance(km.fit(_blobs(10, 3, 2, 0)).centers, np.ndarray)
