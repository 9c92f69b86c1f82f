"""The port's prefetching iterators (`data/async_iterator.py`) against
the JAX package's: the same batches in the same order, reset between
epochs, an exception in the worker raised in the consumer, depth 0
synchronous, `async_supported = False` passed through, the host check
run on the worker; and fit with prefetch bitwise equal to fit without.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.async_iterator import (
    AsyncDataSetIterator as JAsync, prefetch_iterable as jprefetch,
)
from deeplearning4j_tpu.data.iterator import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu_torch.data import async_iterator as pasync
from deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator, DataSetIterator,
)
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves


def _arrays(n=40):
    rs = np.random.RandomState(1)
    return (rs.randn(n, 3).astype("float32"),
            rs.randint(0, 2, (n, 2)).astype("float32"))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_same_batches_in_order_as_the_reference_over_two_epochs(depth):
    x, y = _arrays()
    pit = pasync.AsyncDataSetIterator(
        ArrayDataSetIterator(x, y, batch_size=8, shuffle=True),
        queue_size=depth)
    jit = JAsync(JArrayIt(x, y, batch_size=8, shuffle=True),
                 queue_size=depth, device_put=False)
    for _ in range(2):
        got = [(np.asarray(d.features), np.asarray(d.labels)) for d in pit]
        want = [(np.asarray(d.features), np.asarray(d.labels)) for d in jit]
        assert len(got) == len(want) == 5
        for (gf, gl), (wf, wl) in zip(got, want):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)
        pit.reset()
        jit.reset()


def test_prefetch_iterable_order_transform_and_depth_zero():
    assert list(pasync.prefetch_iterable(range(7), lambda i: i * i, 2)) == \
        list(jprefetch(range(7), lambda i: i * i, 2))
    before = threading.active_count()
    sync = pasync.prefetch_iterable(iter(range(3)), None, 0)
    assert list(sync) == [0, 1, 2]
    assert threading.active_count() == before     # no worker thread


def test_worker_exception_is_raised_in_the_consumer():
    def source():
        yield 1
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for item in pasync.prefetch_iterable(source(), None, 2):
            got.append(item)
    assert got == [1]


def test_host_check_runs_on_the_worker_and_passthrough():
    x, y = _arrays(16)
    seen = []
    it = pasync.AsyncDataSetIterator(ArrayDataSetIterator(x, y, batch_size=8),
                                     check=lambda ds: seen.append(
                                         threading.current_thread().name))
    batches = list(it)
    assert len(batches) == 2 and all(b._host_checked for b in batches)
    assert seen == ["etl-prefetch"] * 2

    def bad(ds):
        raise ValueError("ids out of range")

    with pytest.raises(ValueError, match="out of range"):
        list(pasync.AsyncDataSetIterator(
            ArrayDataSetIterator(x, y, batch_size=8), check=bad))

    class Shielded(DataSetIterator):
        async_supported = False

        def __iter__(self):
            return iter(["raw"])

    assert list(pasync.AsyncDataSetIterator(Shielded())) == ["raw"]


def test_env_knobs(monkeypatch):
    monkeypatch.delenv("DL4J_CUDA_PREFETCH_DEPTH", raising=False)
    monkeypatch.delenv("DL4J_CUDA_FIT_PREFETCH", raising=False)
    assert pasync.prefetch_depth() == 2 and pasync.fit_prefetch_enabled()
    monkeypatch.setenv("DL4J_CUDA_PREFETCH_DEPTH", "0")
    monkeypatch.setenv("DL4J_CUDA_FIT_PREFETCH", "0")
    assert pasync.prefetch_depth() == 0
    assert not pasync.fit_prefetch_enabled()
    monkeypatch.setenv("DL4J_CUDA_FIT_PREFETCH", "false")   # only "0"
    assert pasync.fit_prefetch_enabled()


def test_fit_with_prefetch_equals_fit_without():
    lm = dict(vocab_size=24, seq_length=8, n_layers=1, n_embd=16, n_heads=2,
              attention_impl="flash", block_size=8, seed=4)
    rs = np.random.RandomState(2)
    seq = rs.randint(0, 24, (16, 9))
    X, Y = seq[:, :8, None].astype("float32"), np.eye(24)[seq[:, 1:]]
    nets = []
    for prefetch in (True, False):
        net = model_by_name("TransformerLM", **lm).init(device="cpu")
        net.fit((X, Y), batch_size=4, epochs=2, prefetch=prefetch)
        nets.append(net)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(nets[0].params), tree_leaves(nets[1].params)))
    # an out-of-range id is refused on the prefetch thread
    X[3, 2, 0] = 99
    with pytest.raises(ValueError, match="token ids"):
        nets[0].fit((X, Y), batch_size=4, scan_steps=2)
