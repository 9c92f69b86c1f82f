"""The port's multi-process ring (`data/pipeline.py`) against the JAX
package's in-process shard stream, and fit over the ring against fit
over memory.

Mirrors `tests/test_etl.py`'s ring cases at small sizes (2 spawned
workers, shards of a few hundred records, widths of a few pixels):

- the ring's batches are bitwise the reference `ShardDataSetIterator`'s,
  in order, across re-iteration and an abandoned epoch;
- a loader that raises, a worker that dies and a closed ring surface as
  errors in the consumer, and `close()` unlinks every segment;
- `DL4J_CUDA_ETL_WORKERS=0` runs the same stream in-process, with the
  same position semantics;
- fit over the ring (copy=False and copy=True; scan_steps=3,
  accumulate_steps=2, prefetch on and off) is bitwise the port's fit
  over the same batches from memory, and within 1e-5 of the reference's
  fit on the same zip (f32 Adam).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.iterator import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.data.records import (
    ImageRecordReader as JImageRecordReader,
    RecordReaderDataSetIterator as JRecordReaderIt,
)
from deeplearning4j_tpu.data.shards import (
    ShardDataSetIterator as JShardIt, write_shards as jwrite_shards,
)
from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.data import pipeline
from deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator, ExistingDataSetIterator,
)
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.pipeline import (
    MultiProcessDataSetIterator, ShardBatchLoader, etl_workers,
)
from deeplearning4j_tpu_torch.data.records import (
    ImageRecordReader, RecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.data.shards import (
    ShardDataSetIterator, write_shards,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.serialization import load_model


def _image_data(n=90, h=8, w=8, c=1, classes=5, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randint(0, 256, (n, h, w, c), dtype=np.uint8)
    Y = np.eye(classes, dtype="float32")[rs.randint(0, classes, n)]
    return X, Y


def _write(tmp_path, X, Y, shard_records=32, batch=30):
    d = str(tmp_path / "shards")
    write_shards(ArrayDataSetIterator(X, Y, batch_size=batch,
                                      drop_last=False),
                 d, shard_records=shard_records)
    return d


def _copies(batches):
    return [(np.array(b.features, copy=True), np.array(b.labels, copy=True))
            for b in batches]


def _assert_stream(got, ref):
    assert len(got) == len(ref)
    for (f, l), r in zip(got, ref):
        np.testing.assert_array_equal(f, np.asarray(r.features))
        np.testing.assert_array_equal(l, np.asarray(r.labels))
        assert f.dtype == np.asarray(r.features).dtype
        assert l.dtype == np.asarray(r.labels).dtype


def _shm_names(pipe):
    return [s.name for s in pipe._shms]


def _shm_exists(name):
    return os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))


# ------------------------------------------------------------------ stream
@pytest.mark.parametrize("copy", [True, False])
def test_ring_is_bitwise_the_reference_stream(copy, tmp_path):
    X, Y = _image_data(n=300, seed=2)
    d = _write(tmp_path, X, Y, shard_records=64)
    jd = str(tmp_path / "ref")
    jwrite_shards(JArrayIt(X, Y, batch_size=30, drop_last=False), jd,
                  shard_records=64)
    ref = JShardIt(jd, batch_size=32, shuffle=True, seed=9)
    with MultiProcessDataSetIterator(
            ShardBatchLoader(d, 32, shuffle=True, seed=9), num_workers=2,
            copy=copy) as pipe:
        assert pipe.view_batches is (not copy)
        _assert_stream(_copies(pipe), list(ref))        # epoch 0
        names = _shm_names(pipe)
        assert names and all(_shm_exists(n) for n in names)
        assert pipe.ring_bytes == 4 * 32 * (64 + 5 * 4)
        # an exhausted pass re-iterates into the NEXT epoch's order
        ref2 = list(ref)
        seen = []
        for i, b in enumerate(pipe):
            seen.append((np.array(b.features, copy=True),
                         np.array(b.labels, copy=True)))
            if i == 1:
                break
        _assert_stream(seen, ref2[:2])
        # an abandoned epoch must not corrupt the next one
        pipe.reset()
        ref.reset()
        _assert_stream(_copies(pipe), list(ref))
        stats = pipe.stats
        assert sum(stats["batches"].values()) == 9 + 2 + 9
        assert set(stats["batches"]) <= {"0", "1"}
        assert stats["fetch_wait_count"] == 20
        assert stats["fetch_wait_s"] >= 0.0
        assert all(v >= 0.0 for v in stats["decode_s"].values())
    assert not any(_shm_exists(n) for n in names)
    assert all(not p.is_alive() for p in pipe._procs)


def test_worker_error_surfaces(tmp_path):
    X, Y = _image_data(n=64)
    d = _write(tmp_path, X, Y, shard_records=32)
    loader = ShardBatchLoader(d, 32)
    loader.shard_dir = str(tmp_path / "missing")    # workers will fail
    with MultiProcessDataSetIterator(loader, num_workers=1) as pipe:
        with pytest.raises(RuntimeError, match="ETL worker 0 failed"):
            list(pipe)


def test_dead_worker_surfaces_and_close_releases(tmp_path):
    X, Y = _image_data(n=128)
    d = _write(tmp_path, X, Y, shard_records=32)
    pipe = MultiProcessDataSetIterator(ShardBatchLoader(d, 16),
                                       num_workers=1, slots=2)
    it = iter(pipe)
    next(it)
    names = _shm_names(pipe)
    os.kill(pipe._procs[0].pid, signal.SIGKILL)
    pipe._procs[0].join(timeout=10)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="all ETL workers exited"):
        for _ in it:
            pass
    assert time.monotonic() - t0 < 30
    pipe.close()
    assert not any(_shm_exists(n) for n in names)


def test_closed_ring_raises_on_reuse(tmp_path):
    X, Y = _image_data(n=64)
    d = _write(tmp_path, X, Y, shard_records=32)
    pipe = MultiProcessDataSetIterator(ShardBatchLoader(d, 32),
                                       num_workers=1)
    with pipe:
        next(iter(pipe))
    with pytest.raises(RuntimeError, match="pipeline is closed"):
        next(iter(pipe))


def test_ring_creation_failure_names_the_bytes(tmp_path, monkeypatch):
    X, Y = _image_data(n=64)
    d = _write(tmp_path, X, Y, shard_records=32)

    def full(fd, offset, length):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(os, "posix_fallocate", full)
    pipe = MultiProcessDataSetIterator(ShardBatchLoader(d, 32),
                                       num_workers=1, slots=3)
    with pytest.raises(MemoryError, match=f"needs {pipe.ring_bytes} bytes"):
        next(iter(pipe))
    assert pipe._shms == [] or not any(_shm_exists(n)
                                       for n in _shm_names(pipe))
    assert not pipe._procs


def test_kill_switch_runs_the_same_stream_in_process(tmp_path, monkeypatch):
    X, Y = _image_data(n=100)
    d = _write(tmp_path, X, Y)
    jd = str(tmp_path / "ref")
    jwrite_shards(JArrayIt(X, Y, batch_size=30, drop_last=False), jd,
                  shard_records=32)
    ref = list(JShardIt(jd, batch_size=16, shuffle=True, seed=5,
                        drop_last=False))
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "0")
    with MultiProcessDataSetIterator(
            ShardBatchLoader(d, 16, shuffle=True, seed=5,
                             drop_last=False)) as pipe:
        assert pipe._workers_n == 0 and not pipe._procs
        assert pipe.ring_bytes == 0
        _assert_stream(_copies(pipe), ref)
        assert pipe.stats["batches"] == {"inproc": len(ref)}
        pipe.reset()
        assert len(list(pipe)) == len(ref)
    monkeypatch.delenv("DL4J_CUDA_ETL_WORKERS")
    with MultiProcessDataSetIterator(ShardBatchLoader(d, 16)) as p2:
        assert p2._workers_n == 0               # auto: below the floor
        assert len(list(p2)) == 100 // 16


def test_position_parity_sync_vs_workers(tmp_path):
    X, Y = _image_data(n=200, seed=6)
    d = _write(tmp_path, X, Y, shard_records=64)
    streams = {}
    for w in (0, 2):
        with MultiProcessDataSetIterator(
                ShardBatchLoader(d, 20, shuffle=True, seed=5),
                num_workers=w) as pipe:
            seq = []
            it = iter(pipe)
            for _ in range(3):
                seq.append(np.array(next(it).features, copy=True))
            del it
            assert pipe.tell() == 3
            seq += [np.array(b.features, copy=True) for b in pipe]
            assert pipe.tell() == pipe.n_batches
            seq += [np.array(b.features, copy=True) for b in pipe]
            # seek surface: exact-end pin, then the remainder from 2
            assert pipe.stream_state() == {"epoch": 1, "next_batch": 10}
            pipe.seek(pipe.n_batches)
            assert list(pipe) == [] and pipe._epoch == 1
            pipe.seek(8)
            seq += [np.array(b.features, copy=True) for b in pipe]
            with pytest.raises(IndexError):
                pipe.seek(pipe.n_batches + 1)
            streams[w] = seq
    assert len(streams[0]) == 2 * (200 // 20) + 2
    for a, b in zip(streams[0], streams[2]):
        np.testing.assert_array_equal(a, b)
    e0 = np.sort(np.concatenate(streams[0][:10]), axis=None)
    np.testing.assert_array_equal(e0, np.sort(X, axis=None))


def test_etl_workers_auto_rule(monkeypatch):
    for k in ("DL4J_CUDA_ETL_WORKERS", "DL4J_CUDA_ETL_MIN_RECORDS",
              "DL4J_CUDA_ETL_RING_SLOTS", "DL4J_TPU_ETL_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    assert etl_workers(100) == 0
    assert etl_workers(10_000) == min(4, os.cpu_count() or 1)
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "")
    assert etl_workers(10_000) >= 1
    monkeypatch.setenv("DL4J_CUDA_ETL_MIN_RECORDS", "50")
    assert etl_workers(100) >= 1
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")     # not the port's
    assert etl_workers(10_000) >= 1
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "0")
    assert etl_workers(10_000) == 0
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "3")
    assert etl_workers(None) == 3
    monkeypatch.setenv("DL4J_CUDA_ETL_RING_SLOTS", "7")
    assert MultiProcessDataSetIterator(
        _FakeLoader(), num_workers=2)._slots_n == 7


class _FakeLoader:
    def spec(self):
        return {"features": ((2, 3), "<f4"), "labels": None,
                "n_batches": 1, "batch_size": 2}


def test_mp_start_method_knob(monkeypatch):
    monkeypatch.delenv("DL4J_CUDA_ETL_MP_START", raising=False)
    assert pipeline._mp_context().get_start_method() == "spawn"
    monkeypatch.setenv("DL4J_CUDA_ETL_MP_START", "forkserver")
    assert pipeline._mp_context().get_start_method() == "forkserver"


def _png_tree(tmp_path, n_per_class=30, classes=2, hw=10):
    from PIL import Image
    rs = np.random.RandomState(0)
    root = tmp_path / "imgs"
    for ci in range(classes):
        d = root / f"class{ci}"
        d.mkdir(parents=True)
        for i in range(n_per_class):
            arr = rs.randint(0, 256, (hw, hw), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i:03d}.png")
    return str(root)


def test_image_delegation_parity(tmp_path, monkeypatch):
    """File-backed image readers delegate to the ring (2 workers): the
    batches are the in-process decode's and the reference's."""
    root = _png_tree(tmp_path)

    def batches(workers):
        monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", workers)
        rr = ImageRecordReader(10, 10, 1).initialize(root)
        it = RecordReaderDataSetIterator(rr, batch_size=16, label_index=-1,
                                         num_classes=rr.num_labels())
        try:
            out = _copies(it)
            assert (it._mp_pipe is not None) is (workers != "0")
            # a second pass restarts the epoch from the first file
            again = _copies(it)
            _assert_stream(again, [DataSet(f, l) for f, l in out])
            return out
        finally:
            if it._mp_pipe:
                it._mp_pipe.close()

    inproc = batches("0")
    piped = batches("2")
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")
    jrr = JImageRecordReader(10, 10, 1).initialize(root)
    ref = list(JRecordReaderIt(jrr, batch_size=16, label_index=-1,
                               num_classes=jrr.num_labels()))
    assert len(piped) == len(inproc) == 4   # 60 images / b16, ragged tail
    _assert_stream(inproc, ref)
    _assert_stream(piped, ref)
    assert inproc[0][0].dtype == np.uint8


# ------------------------------------------------------- fit over the ring
N, F, C, B = 240, 5, 3, 40


def _blobs():
    rs = np.random.RandomState(4)
    X = rs.randn(N, F).astype("float32")
    Y = np.eye(C, dtype="float32")[rs.randint(0, C, N)]
    return X, Y


@pytest.fixture(scope="module")
def fit_setup(tmp_path_factory):
    """One reference MLP zip, its shards, and the reference's fit of each
    mode on the same batches."""
    tmp = tmp_path_factory.mktemp("ringfit")
    X, Y = _blobs()
    d = str(tmp / "shards")
    write_shards(ArrayDataSetIterator(X, Y, batch_size=B), d,
                 shard_records=64)
    conf = (JNNC.Builder().seed(2).updater(jupd.Adam(1e-2)).list()
            .layer(jff.DenseLayer(n_out=8, activation="relu"))
            .layer(jff.OutputLayer(n_out=C, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(F)).build())
    jnet = JMLN(conf).init()
    rs = np.random.RandomState(8)
    jnet.set_params_flat(np.asarray(jnet.params_flat())
                         + rs.randn(jnet.num_params()).astype("float32")
                         * 0.05)
    zip_path = str(tmp / "mlp.zip")
    jax_save(jnet, zip_path)
    ref = {}
    for mode, kw in MODES.items():
        j = JMLN(conf).init()
        j.set_params_flat(np.asarray(jnet.params_flat()))
        j.fit(JArrayIt(X, Y, batch_size=B), epochs=2, **kw)
        ref[mode] = np.asarray(j.params_flat())
    return {"X": X, "Y": Y, "dir": d, "zip": zip_path, "ref": ref}


MODES = {
    "per_call": {},
    "scan3": {"scan_steps": 3},
    "accumulate2": {"accumulate_steps": 2},
    "no_prefetch": {"prefetch": False},
    "no_prefetch_scan3": {"prefetch": False, "scan_steps": 3},
}


def _port_fit(zip_path, source, **kw):
    net = load_model(zip_path, device="cpu")
    net.fit(source, epochs=2, **kw)
    return net.params_flat().numpy()


@pytest.mark.parametrize("copy", [False, True], ids=["views", "copies"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fit_over_the_ring_equals_fit_over_memory(mode, copy, fit_setup):
    s = fit_setup
    kw = MODES[mode]
    mem = _port_fit(s["zip"], ArrayDataSetIterator(s["X"], s["Y"],
                                                   batch_size=B), **kw)
    with MultiProcessDataSetIterator(ShardBatchLoader(s["dir"], B),
                                     num_workers=2, copy=copy) as pipe:
        ring = _port_fit(s["zip"], pipe, **kw)
        assert pipe._copy is copy               # restored after the fit
        assert sum(pipe.stats["batches"].values()) == 2 * N // B
    np.testing.assert_array_equal(ring, mem)
    np.testing.assert_allclose(ring, s["ref"][mode], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [{"scan_steps": 3}, {"accumulate_steps": 2},
                                {}], ids=["scan3", "accumulate2", "per_call"])
def test_graph_fit_over_the_ring_equals_fit_over_memory(kw, fit_setup,
                                                        monkeypatch):
    """ComputationGraph over ring views, prefetch on and off."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        GraphBuilder, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    s = fit_setup
    conf = (GraphBuilder(NeuralNetConfiguration.Builder().seed(3)
                         .updater(Adam(1e-2)))
            .add_inputs("in").set_input_types(InputType.feed_forward(F))
            .add_layer("h", pff.DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("out", pff.OutputLayer(n_out=C, activation="softmax",
                                              loss="mcxent"), "h")
            .set_outputs("out").build())
    for prefetch in ("1", "0"):
        monkeypatch.setenv("DL4J_CUDA_FIT_PREFETCH", prefetch)
        mem = ComputationGraph(conf, device="cpu").init()
        mem.fit(ExistingDataSetIterator(
            list(ShardDataSetIterator(s["dir"], B))), epochs=2, **kw)
        with MultiProcessDataSetIterator(ShardBatchLoader(s["dir"], B),
                                         num_workers=2, copy=False) as pipe:
            net = ComputationGraph(conf, device="cpu").init()
            net.fit(pipe, epochs=2, **kw)
            assert pipe._copy is False
        assert torch.equal(net.params_flat(), mem.params_flat()), prefetch
