"""The port's utility iterators (`data/utility_iterators.py` and
`BenchmarkDataSetIterator`) against the JAX package's, class by class,
on the same seeded numpy inputs (`tests/test_data.py`'s cases): every
scenario runs once per package and the yielded batches must be bitwise
equal. `save_dataset`/`load_dataset` files move between the packages.
"""
import types

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jdataset
from deeplearning4j_tpu.data import iterator as jiterator
from deeplearning4j_tpu.data import utility_iterators as jutil
from deeplearning4j_tpu_torch.data import dataset as pdataset
from deeplearning4j_tpu_torch.data import iterator as piterator
from deeplearning4j_tpu_torch.data import utility_iterators as putil

PKGS = {
    "reference": types.SimpleNamespace(u=jutil, it=jiterator, ds=jdataset),
    "port": types.SimpleNamespace(u=putil, it=piterator, ds=pdataset),
}


def _blobs(n=16, f=3, c=2, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, f).astype("float32"),
            np.eye(c, dtype="float32")[rs.randint(0, c, n)])


def _arrays(items):
    out = []
    for b in items:
        if hasattr(b, "features_masks"):
            out.append(tuple(np.array(a) for a in (*b.features, *b.labels)))
        else:
            out.append(tuple(None if a is None else np.array(a) for a in (
                b.features, b.labels, b.features_mask, b.labels_mask)))
    return out


def _mds(m, n=6):
    return [m.ds.MultiDataSet((np.full((2, 3), i, np.float32),),
                              (np.full((2, 1), i, np.float32),), None, None)
            for i in range(n)]


class AddOne:
    def preprocess(self, ds):
        return type(ds)(ds.features + 1, ds.labels)


# ------------------------------------------------------------- scenarios
def early_termination(m, tmp):
    X, Y = _blobs()
    it = m.u.EarlyTerminationDataSetIterator(
        m.it.ArrayDataSetIterator(X, Y, batch_size=3), 2)
    with pytest.raises(ValueError):
        m.u.EarlyTerminationDataSetIterator(it, 0)
    return list(it) + list(it)


def multiple_epochs(m, tmp):
    X, Y = _blobs()
    src = m.it.ArrayDataSetIterator(X, Y, batch_size=4, shuffle=True, seed=2)
    return list(m.u.MultipleEpochsIterator(src, 3))


def splitter(m, tmp):
    X, Y = _blobs(n=20)
    split = m.u.DataSetIteratorSplitter(
        m.it.ArrayDataSetIterator(X, Y, batch_size=4), total_batches=5,
        ratio=0.6)
    with pytest.raises(ValueError):
        m.u.DataSetIteratorSplitter(split.source, 5, 1.0)
    return (list(split.train_iterator) + list(split.test_iterator)
            + list(split.train_iterator))


def sampling(m, tmp):
    X, Y = _blobs()
    it = m.u.SamplingDataSetIterator(m.ds.DataSet(X, Y), batch_size=5,
                                     total_batches=3, seed=9)
    return list(it) + list(it)


def iterator_wrapper(m, tmp):
    X, Y = _blobs()
    gen = (m.ds.DataSet(X[i:i + 4], Y[i:i + 4]) for i in range(0, 16, 4))
    it = m.u.IteratorDataSetIterator(gen)
    it.set_pre_processor(AddOne())
    return list(it) + list(it)


def async_multi(m, tmp):
    return list(m.u.AsyncMultiDataSetIterator(_mds(m), queue_size=2))


def reconstruction(m, tmp):
    X, _ = _blobs()
    it = m.u.ReconstructionDataSetIterator(
        m.it.ArrayDataSetIterator(X, np.zeros((16, 1), np.float32),
                                  batch_size=4))
    out = list(it)
    for ds in out:
        np.testing.assert_array_equal(ds.features, ds.labels)
    assert it.batch_size() == 4
    return out


def benchmark_reuses_one_batch(m, tmp):
    it = m.it.BenchmarkDataSetIterator((8, 4), n_labels=3, n_batches=5)
    out = list(it)
    assert len(out) == 5 and all(b is out[0] for b in out)
    X, Y = _blobs()
    it2 = m.u.BenchmarkDataSetIterator(m.ds.DataSet(X, Y), 2)
    with pytest.raises(ValueError):
        m.it.BenchmarkDataSetIterator()
    return out + list(it2)


def multi_dataset_family(m, tmp):
    src = m.u.IteratorMultiDataSetIterator(iter(_mds(m)))
    early = list(m.u.EarlyTerminationMultiDataSetIterator(src, 2))
    split = m.u.MultiDataSetIteratorSplitter(src, total_batches=6, ratio=0.5)
    wrapped = list(m.u.MultiDataSetWrapperIterator(src))
    single = list(m.u.SingletonMultiDataSetIterator(_mds(m)[3]))
    bad = m.ds.MultiDataSet((np.zeros((1, 2)), np.zeros((1, 2))),
                            (np.zeros((1, 1)),), None, None)
    with pytest.raises(ValueError, match="single-input"):
        list(m.u.MultiDataSetWrapperIterator([bad]))
    return (list(src) + early + list(split.train_iterator)
            + list(split.test_iterator) + wrapped + single)


def typed_pair_iterators(m, tmp):
    pairs = [(np.full(3, i), np.eye(2)[i % 2]) for i in range(5)]
    f = list(m.u.FloatsDataSetIterator(pairs, batch_size=2))
    d = list(m.u.DoublesDataSetIterator(pairs, batch_size=5))
    i16 = list(m.u.INDArrayDataSetIterator(
        [(np.zeros(3, np.int16), np.zeros(2, np.int16))], 1))
    gen = ((np.full(2, i), np.eye(2)[i % 2]) for i in range(4))
    g = m.u.FloatsDataSetIterator(gen, batch_size=2)
    assert f[0].features.dtype == np.float32
    assert d[0].features.dtype == np.float64
    assert i16[0].features.dtype == np.int16
    return f + d + i16 + list(g) + list(g)


def list_rebatch(m, tmp):
    singles = [m.ds.DataSet(np.full((1, 2), i, "float32"),
                            np.eye(3, dtype="float32")[[i % 3]])
               for i in range(7)]
    pairs = [m.ds.DataSet(np.full((2, 2), i, "float32"),
                          np.eye(3, dtype="float32")[[i % 3, (i + 1) % 3]])
             for i in range(4)]
    return (list(m.u.ListDataSetIterator(singles, batch=3))
            + list(m.u.ListDataSetIterator(pairs, batch=3)))


def pre_processor_combinators(m, tmp):
    ds = m.ds.DataSet(np.zeros((2, 2), "float32"),
                      np.zeros((2, 1), "float32"))
    assert m.u.DummyPreProcessor().preprocess(ds) is ds
    out = m.u.CombinedPreProcessor(AddOne(), m.u.DummyPreProcessor(),
                                   AddOne()).preprocess(ds)
    mds = m.ds.MultiDataSet((np.ones((1, 2), "float32"),),
                            (np.zeros((1, 1), "float32"),), None, None)

    class Triple:
        def preprocess(self, x):
            return type(x)(tuple(f * 3 for f in x.features), x.labels)
    mout = m.u.CombinedMultiDataSetPreProcessor(Triple()).preprocess(mds)
    return [out, mout]


def workspaces_shield(m, tmp):
    X = np.arange(8, dtype="float32").reshape(4, 2)
    Y = np.eye(2, dtype="float32")[[0, 1, 0, 1]]
    out = list(m.u.WorkspacesShieldDataSetIterator(
        m.it.ArrayDataSetIterator(X, Y, batch_size=2)))
    out[0].features[0, 0] = 99.0
    assert X[0, 0] == 0.0
    return out


def async_shield(m, tmp):
    X, Y = _blobs()
    shield = m.u.AsyncShieldDataSetIterator(
        m.it.ArrayDataSetIterator(X, Y, batch_size=4))
    assert shield.async_supported is False
    shield.set_pre_processor(AddOne())
    assert shield.batch_size() == 4
    return list(shield)


def moving_window(m, tmp):
    ds = m.ds.DataSet(np.arange(10, dtype="float32")[:, None],
                      np.arange(10, dtype="float32")[:, None])
    return (list(m.u.MovingWindowBaseDataSetIterator(ds, window=4, stride=3))
            + list(m.u.MovingWindowBaseDataSetIterator(ds, window=5)))


def file_split(m, tmp):
    files = []
    for i in range(3):
        ds = m.ds.DataSet(np.full((2, 2), i, "float32"),
                          np.eye(2, dtype="float32"),
                          None if i else np.ones((2, 2), "float32"))
        p = str(tmp / f"ds{i}.npz")
        m.u.save_dataset(ds, p)
        files.append(p)
    out = list(m.u.FileSplitDataSetIterator(files))
    assert m.u.load_dataset(files[1]).features_mask is None
    return out


def joint_parallel(m, tmp):
    def src(vals):
        X = np.asarray(vals, "float32")[:, None]
        Y = np.eye(2, dtype="float32")[np.zeros(len(vals), int)]
        return m.it.ArrayDataSetIterator(X, Y, batch_size=1)
    out = []
    for mode in (m.u.InequalityHandling.PASS,
                 m.u.InequalityHandling.STOP_EVERYONE,
                 m.u.InequalityHandling.RESET):
        out += list(m.u.JointParallelDataSetIterator(
            src([1, 2]), src([10, 20, 30, 40, 50]), inequality=mode))
        out += list(m.u.JointParallelDataSetIterator(
            src([1, 2]), src([3, 4]), inequality=mode))
    with pytest.raises(ValueError):
        m.u.JointParallelDataSetIterator()
    return out


SCENARIOS = [early_termination, multiple_epochs, splitter, sampling,
             iterator_wrapper, async_multi, reconstruction,
             benchmark_reuses_one_batch, multi_dataset_family,
             typed_pair_iterators, list_rebatch, pre_processor_combinators,
             workspaces_shield, async_shield, moving_window, file_split,
             joint_parallel]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario, tmp_path):
    got = {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _arrays(scenario(m, d))
    assert len(got["port"]) == len(got["reference"])
    for a, b in zip(got["port"], got["reference"]):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_saved_datasets_cross_packages(writer, reader, tmp_path):
    rs = np.random.RandomState(4)
    w, r = PKGS[writer], PKGS[reader]
    ds = w.ds.DataSet(rs.randn(3, 4, 2).astype("float32"),
                      rs.randn(3, 4, 5).astype("float64"),
                      np.ones((3, 4), "float32"), None)
    p = str(tmp_path / "one.npz")
    w.u.save_dataset(ds, p)
    back = r.u.load_dataset(p)
    assert type(back).__module__.startswith(r.ds.__name__.rsplit(".", 1)[0])
    for key in ("features", "labels", "features_mask"):
        np.testing.assert_array_equal(getattr(back, key), getattr(ds, key))
        assert getattr(back, key).dtype == getattr(ds, key).dtype
    assert back.labels_mask is None
    with open(p, "rb") as f:
        written = f.read()
    q = str(tmp_path / "two.npz")
    r.u.save_dataset(back, q)
    with open(q, "rb") as f:
        assert f.read() == written


def test_device_callbacks_place_batches_round_robin():
    import torch
    X, Y = _blobs()
    it = piterator.ArrayDataSetIterator(X, Y, batch_size=2)
    cb = putil.InterleavedDataSetCallback(["cpu", "meta"])
    placed = [cb.call(ds) for ds in it]
    assert [b.features.device.type for b in placed] == ["cpu", "meta"] * 4
    assert all(isinstance(b.labels, torch.Tensor) for b in placed)
    np.testing.assert_array_equal(placed[0].features.numpy(), X[:2])
    one = putil.DefaultCallback("cpu").call(next(iter(it)))
    assert one.features.device.type == "cpu" and one.features_mask is None
    assert putil.DataSetCallback().call(one) is one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            putil.DefaultCallback().call(next(iter(it)))
