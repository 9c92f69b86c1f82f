"""The port's shard format (`data/shards.py`) against the JAX package's.

Every scenario runs once per package on the same seeded numpy records
(`tests/test_etl.py`'s cases): it asserts the reference's expectations
and returns what it read, and the two packages' returns must be equal,
arrays bitwise. The files themselves are compared byte for byte, and each
package reads the shards the other wrote.
"""
import json
import os
import types

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jdataset
from deeplearning4j_tpu.data import iterator as jiterator
from deeplearning4j_tpu.data import shards as jshards
from deeplearning4j_tpu_torch.data import dataset as pdataset
from deeplearning4j_tpu_torch.data import iterator as piterator
from deeplearning4j_tpu_torch.data import shards as pshards

PKGS = {
    "reference": types.SimpleNamespace(
        shards=jshards, DataSet=jdataset.DataSet,
        ArrayDataSetIterator=jiterator.ArrayDataSetIterator),
    "port": types.SimpleNamespace(
        shards=pshards, DataSet=pdataset.DataSet,
        ArrayDataSetIterator=piterator.ArrayDataSetIterator),
}


def _image_data(n=90, h=8, w=8, c=1, classes=5, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    Y = np.eye(classes, dtype="float32")[rs.randint(0, classes, n)]
    return X, Y


def _write(m, d, X, Y, shard_records=32, batch=30):
    return m.shards.write_shards(
        m.ArrayDataSetIterator(X, Y, batch_size=batch, drop_last=False), d,
        shard_records=shard_records)


def _arrays(batches):
    return [(np.array(b.features), None if b.labels is None
             else np.array(b.labels)) for b in batches]


# ------------------------------------------------------------- scenarios
def roundtrip(m, d):
    X, Y = _image_data()
    _write(m, d, X, Y)
    got = list(m.shards.ShardDataSetIterator(d, batch_size=30))
    assert len(got) == 3
    for i, ds in enumerate(got):
        np.testing.assert_array_equal(ds.features, X[i * 30:(i + 1) * 30])
        assert ds.features.dtype == np.uint8
        np.testing.assert_array_equal(ds.labels, Y[i * 30:(i + 1) * 30])
        assert ds.labels.dtype == np.float32
    return _arrays(got)


def footer_and_compact_labels(m, d):
    X, Y = _image_data(n=70)
    _write(m, d, X, Y, shard_records=32)
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    assert index["num_classes"] == 5
    assert np.dtype(index["labels"]["dtype"]) == np.int32
    assert [s["records"] for s in index["shards"]] == [32, 32, 6]
    footer = m.shards.read_footer(os.path.join(d, index["shards"][0]["file"]))
    assert footer["records"] == 32
    assert tuple(footer["features"]["shape"]) == (8, 8, 1)
    return index, footer


def crosses_boundaries_and_ragged_tail(m, d):
    X, Y = _image_data(n=100)
    _write(m, d, X, Y, shard_records=32)
    got = list(m.shards.ShardDataSetIterator(d, batch_size=48,
                                             drop_last=False))
    assert [b.features.shape[0] for b in got] == [48, 48, 4]
    np.testing.assert_array_equal(got[1].features, X[48:96])
    np.testing.assert_array_equal(got[2].features, X[96:])
    return _arrays(got)


def noncompact_labels_verbatim(m, d):
    rs = np.random.RandomState(3)
    X = rs.randn(40, 6).astype("float32")
    Y = rs.randn(40, 2).astype("float32")
    m.shards.write_shards(m.ArrayDataSetIterator(X, Y, batch_size=20), d)
    got = list(m.shards.ShardDataSetIterator(d, batch_size=20))
    np.testing.assert_array_equal(got[0].features, X[:20])
    np.testing.assert_array_equal(got[0].labels, Y[:20])
    return _arrays(got)


def reiterate_replays(m, d):
    X, Y = _image_data(n=100)
    _write(m, d, X, Y)
    it = m.shards.ShardDataSetIterator(d, batch_size=25, shuffle=True, seed=3)
    e0 = [np.array(b.features) for b in it]
    e1 = [np.array(b.features) for b in it]
    assert not all(np.array_equal(a, b) for a, b in zip(e0, e1))
    it2 = m.shards.ShardDataSetIterator(d, batch_size=25)
    it2.seek(it2.n_batches)
    assert list(it2) == []
    assert len(list(it2)) == 4
    return e0, e1


def mixed_label_kinds(m, d):
    X, Y = _image_data(n=20)
    soft = np.full((10, 5), 0.2, dtype=np.float32)
    with pytest.raises(ValueError, match="compact_labels=False") as err:
        m.shards.write_shards(iter([m.DataSet(X[:10], Y[:10]),
                                    m.DataSet(X[10:], soft)]),
                              os.path.join(d, "mixed"))
    d2 = os.path.join(d, "soft_first")
    m.shards.write_shards(iter([m.DataSet(X[:10], soft),
                                m.DataSet(X[10:], Y[10:])]), d2)
    got = list(m.shards.ShardDataSetIterator(d2, batch_size=10,
                                             drop_last=False))
    np.testing.assert_array_equal(got[0].labels, soft)
    np.testing.assert_array_equal(got[1].labels, Y[10:])
    return str(err.value), _arrays(got)


def empty_set_stream_state(m, d):
    with m.shards.ShardWriter(d):
        pass
    it = m.shards.ShardDataSetIterator(d, batch_size=8)
    state = it.stream_state()
    assert state["shard_file"] is None and state["record_offset"] == 0
    assert list(it) == []
    return state


def schema_mismatch(m, d):
    w = m.shards.ShardWriter(d)
    w.add(np.zeros((4, 4), np.uint8), np.int32(1))
    with pytest.raises(ValueError, match="schema mismatch") as e1:
        w.add(np.zeros((5, 4), np.uint8), np.int32(0))
    with pytest.raises(ValueError, match="cannot mix") as e2:
        w.add(np.zeros((4, 4), np.uint8))
    return str(e1.value), str(e2.value)


def crash_leaves_no_index(m, d):
    with pytest.raises(RuntimeError, match="boom"):
        with m.shards.ShardWriter(d, shard_records=4) as w:
            for i in range(6):
                w.add(np.full((2, 2), i, np.uint8), np.int32(0))
            raise RuntimeError("boom")
    assert not os.path.exists(os.path.join(d, "index.json"))
    with pytest.raises(FileNotFoundError):
        m.shards.ShardDataSetIterator(d, batch_size=2)
    return sorted(os.listdir(d))


def closed_and_aborted_guards(m, d):
    w = m.shards.ShardWriter(os.path.join(d, "s"), shard_records=4)
    w.add(np.zeros((2, 2), np.uint8), np.int32(0))
    idx = w.close()
    assert w.close() == idx
    with pytest.raises(RuntimeError, match="closed"):
        w.add(np.zeros((2, 2), np.uint8), np.int32(0))
    with pytest.raises(RuntimeError, match="closed"):
        w.add_batch(np.zeros((1, 2, 2), np.uint8), np.zeros((1,), np.int32))
    assert idx["n_records"] == 1
    w2 = m.shards.ShardWriter(os.path.join(d, "s2"), shard_records=4)
    with pytest.raises(RuntimeError, match="boom"):
        with w2:
            w2.add(np.zeros((2, 2), np.uint8), np.int32(0))
            raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="aborted") as err:
        w2.close()
    return idx, str(err.value)


def seek_tell_stream_state(m, d):
    X, Y = _image_data(n=120)
    _write(m, d, X, Y)
    it = m.shards.ShardDataSetIterator(d, batch_size=30, shuffle=True, seed=7)
    it.reset()
    full = [np.array(b.features) for b in it]
    it2 = m.shards.ShardDataSetIterator(d, batch_size=30, shuffle=True,
                                        seed=7)
    it2.reset()
    states = [it2.stream_state()]
    it2.seek(2)
    assert it2.tell() == 2
    states.append(it2.stream_state())
    tail = [np.array(b.features) for b in it2]
    states.append(it2.stream_state())
    assert len(tail) == 2
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(a, b)
    assert it2.batches_read == 2
    return states, full, tail


def add_and_add_batch(m, d):
    """Per-record and per-batch appends, unlabeled records, a small
    shard size: every file of the directory."""
    rs = np.random.RandomState(11)
    X = rs.randn(23, 3, 2).astype("float32")
    with m.shards.ShardWriter(os.path.join(d, "a"), shard_records=5,
                              prefix="part") as w:
        for x in X[:7]:
            w.add(x)
        w.add_batch(X[7:])
    with m.shards.ShardWriter(os.path.join(d, "b"), shard_records=6) as w:
        w.add_batch(X[:10], np.arange(10, dtype=np.int64))
        w.num_classes = 10
        for i, x in enumerate(X[10:]):
            w.add(x, np.int64(i))
    got_a = list(m.shards.ShardDataSetIterator(os.path.join(d, "a"),
                                               batch_size=4, drop_last=False))
    got_b = list(m.shards.ShardDataSetIterator(os.path.join(d, "b"),
                                               batch_size=4))
    assert got_a[0].labels is None and got_b[0].labels.shape == (4, 10)
    return _arrays(got_a), _arrays(got_b)


SCENARIOS = [roundtrip, footer_and_compact_labels,
             crosses_boundaries_and_ragged_tail, noncompact_labels_verbatim,
             reiterate_replays, mixed_label_kinds, empty_set_stream_state,
             schema_mismatch, crash_leaves_no_index,
             closed_and_aborted_guards, seek_tell_stream_state,
             add_and_add_batch]


def _equal(a, b, path="result"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, path


def _tree_bytes(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario, tmp_path):
    """The port behaves as the reference, result for result, and writes
    the same bytes."""
    results = {}
    for name, m in PKGS.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        results[name] = scenario(m, d)
    _equal(results["reference"], results["port"])
    assert _tree_bytes(str(tmp_path / "port")) \
        == _tree_bytes(str(tmp_path / "reference"))


@pytest.mark.parametrize("kind", ["uint8_onehot", "float_regression",
                                  "unlabeled", "int_ids"])
@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_each_package_reads_the_others_shards(kind, writer, reader, tmp_path):
    rs = np.random.RandomState(5)
    if kind == "uint8_onehot":
        X, Y = _image_data(n=77, h=5, w=4, c=3, classes=7, seed=5)
    elif kind == "float_regression":
        X = rs.randn(77, 6).astype("float32")
        Y = rs.randn(77, 2).astype("float64")
    elif kind == "unlabeled":
        X, Y = rs.randn(77, 2, 3).astype("float16"), None
    else:
        X = rs.randint(0, 50, (77, 4)).astype(np.int32)
        Y = rs.randint(0, 9, 77).astype(np.int64)
    d = str(tmp_path / "s")
    w = PKGS[writer]
    w.shards.write_shards(w.ArrayDataSetIterator(X, Y, batch_size=11), d,
                          shard_records=16)
    streams = []
    for m in (PKGS[reader], PKGS[writer]):
        it = m.shards.ShardDataSetIterator(d, batch_size=10, shuffle=True,
                                           seed=4, drop_last=False)
        it.seek(3)
        streams.append((it.stream_state(), _arrays(it),
                        it.stream_state(), _arrays(it)))
    _equal(streams[0], streams[1])
    whole = np.concatenate([f for f, _ in streams[0][3]])
    np.testing.assert_array_equal(np.sort(whole, axis=None),
                                  np.sort(X, axis=None))


def test_label_rules_match_reference():
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 6, 13).astype(np.int32)
    np.testing.assert_array_equal(pshards.one_hot_labels(ids, 6),
                                  jshards.one_hot_labels(ids, 6))
    for raw, nc in ((ids, 6), (ids, None), (ids.astype(np.float32), 6),
                    (ids.reshape(13, 1), 6), (None, 6)):
        a, b = pshards.decode_labels(raw, nc), jshards.decode_labels(raw, nc)
        _equal(a, b)
    for shuffle in (False, True):
        for epoch in range(3):
            np.testing.assert_array_equal(
                pshards.epoch_order(9, shuffle, 4, epoch),
                jshards.epoch_order(9, shuffle, 4, epoch))
    for args in ((100, 30, True), (100, 30, False), (20, 30, True),
                 (0, 5, True)):
        assert pshards.epoch_batches(*args) == jshards.epoch_batches(*args)
