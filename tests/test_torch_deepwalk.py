"""The port's graph package (`graph/`: Graph, random walks, DeepWalk)
against the JAX package's, on the CPU.

- The graph cases of `tests/test_apps.py` run against the port
  (`_torch_reference_cases.port_cases`), the trainer's default device
  mapped to the CPU.
- Uniform, weighted and node2vec-biased walks from the same seed are the
  reference's, walk for walk.
- DeepWalk's tables (negative sampling and hierarchical softmax) end
  within 1e-5 relative (max |delta| / max |table|) of the reference's
  after three or more batches of the same walks.
"""
import numpy as np
import pytest
import torch

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu.graph import DeepWalk as JDeepWalk
from deeplearning4j_tpu.graph import Graph as JGraph
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
from deeplearning4j_tpu_torch.util import platform

FIT_REL_TOL = 1e-5

# clustering and manifold are a later slice: their imports are left out
_LATER = (("""from deeplearning4j_tpu_torch.clustering import (
    KDTree, KMeansClustering, RandomProjection, RandomProjectionLSH, VPTree,
)""", ""), ("from deeplearning4j_tpu_torch.manifold import Tsne", ""))
_APPS = port_cases("tests/test_apps.py", names=(
    "test_graph_and_walks", "test_deepwalk_embeds_components_apart"),
    extra_subs=_LATER)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The trainers' CPU steps are many tiny ops, and some of them (the
    gathers, the log-sigmoids) enter an OpenMP region on every call at
    the default thread count: tens of milliseconds apiece when the test
    workers oversubscribe the host's cores. One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_default(monkeypatch):
    from deeplearning4j_tpu_torch.embeddings import sequencevectors

    def resolve(device=None):
        return platform.resolve_device("cpu" if device is None else device)
    monkeypatch.setattr(sequencevectors, "resolve_device", resolve)


@pytest.mark.parametrize("name", ["test_deepwalk_embeds_components_apart",
                                  "test_graph_and_walks"])
def test_reference_graph_case(name, request, cpu_default):
    run_case(_APPS, name, request)


def _edges(n=40, m=120, seed=0):
    rs = np.random.RandomState(seed)
    edges = [(i, (i + 1) % n, 1.0 + rs.rand()) for i in range(n)]
    for _ in range(m):
        a, b = rs.randint(0, n, 2)
        if a != b:
            edges.append((int(a), int(b), float(0.5 + rs.rand() * 2)))
    return edges


@pytest.mark.parametrize("kw", [{}, {"weighted": True},
                                {"p": 0.5, "q": 2.0}],
                         ids=["uniform", "weighted", "node2vec"])
def test_random_walks_are_the_references(kw):
    edges = _edges()
    a = Graph.from_edges(edges)
    b = JGraph.from_edges(edges)
    assert a.num_edges() == b.num_edges()
    assert [a.neighbors(v) for v in range(a.n_vertices)] == \
        [b.neighbors(v) for v in range(b.n_vertices)]
    wa = list(a.random_walks(walk_length=12, walks_per_vertex=2, seed=3,
                             **kw))
    wb = list(b.random_walks(walk_length=12, walks_per_vertex=2, seed=3,
                             **kw))
    assert wa == wb and len(wa) == 80


@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
def test_deepwalk_tables_are_the_references(hs, monkeypatch):
    from deeplearning4j_tpu_torch.embeddings import sequencevectors as psv
    steps = []
    for name in ("_sg_ns_step", "_sg_hs_step"):
        fn = getattr(psv, name)
        monkeypatch.setattr(psv, name, lambda *a, _f=fn: (
            steps.append(1), _f(*a))[1])
    edges = [e[:2] for e in _edges(30, 60, seed=1)]
    kw = dict(layer_size=16, window=4, walk_length=10, walks_per_vertex=1,
              batch_size=128, seed=2,
              **({"negative": 0, "use_hierarchic_softmax": True}
                 if hs else {}))
    a = DeepWalk(**kw).fit_graph(Graph.from_edges(edges), device="cpu")
    b = JDeepWalk(**kw).fit_graph(JGraph.from_edges(edges))
    assert len(steps) >= 3
    assert a.vocab.words() == b.vocab.words()
    for mine, theirs in ((a.vectors, b.vectors), (a.w_out, b.w_out),
                         (a.syn1, b.syn1)):
        theirs = np.asarray(theirs)
        assert np.abs(mine - theirs).max() <= \
            FIT_REL_TOL * max(np.abs(theirs).max(), 1e-30)
    assert a.verts_nearest(0, 3) == b.verts_nearest(0, 3)
