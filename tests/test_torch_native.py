"""The port's native host library (`native/`) against the JAX package's.

- Every case of `tests/test_native.py` runs against the port: the
  framework-neutral ones compiled from that file with the port's imports
  (`_torch_reference_cases.port_cases`), the two that touch a network or
  the JAX encoder rewritten here (the native codec against the port's
  torch encoder and the reference's; the rank path of
  `SharedGradientsTrainer` picks the native codec for a model on the CPU).
- Both libraries are built from the same sources with the same g++ flags
  and share this process (each loaded RTLD_LOCAL): every native entry
  point gives bitwise the reference library's output on the same seeded
  inputs (sizes below the OpenMP thresholds, where a reduction's order is
  fixed; the HogWild trainer at `n_threads=1`).
- With both libraries switched off, the numpy twins give bitwise the
  reference's twins.
- `native.CALLS` counts the calls into the library by C function.
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.native import ndarray as jnd
from deeplearning4j_tpu_torch import native as pnative
from deeplearning4j_tpu_torch.native import ndarray as pnd

_REF = port_cases("tests/test_native.py", names=(
    "test_codec_round_trip_and_top_k_selection",
    "test_encoding_handler_native_backend",
    "test_hogwild_skipgram_learns_topic_structure",
    "test_native_backend_rejects_unsupported_modes",
    "test_ns_table_never_contains_out_of_vocab_ids",
    "test_ndarray_gemm_matches_numpy_all_transposes",
    "test_ndarray_transforms_reductions_broadcasts",
    "test_ndarray_im2col_col2im_adjoint_and_equivalence",
    "test_ndarray_random_and_distance_kernels",
    "test_ndarray_edge_semantics_match_across_backends",
    "test_ndarray_argmax_empty_raises_and_rdiv_exact",
    "test_native_csv_parser_matches_python_and_falls_back",
    "TestNativeTokenizer",
    "test_word2vec_native_vocab_matches_python_pass",
    "test_native_tokenizer_fs_gs_rs_us_separators",
    "test_native_encoder_empty_vocab_keep_oov"))
REFERENCE_CASES = sorted(n for n in vars(_REF) if n.startswith("test_"))

#: the reference's tokenizer cases, as a class of this module
TestNativeTokenizer = _REF.TestNativeTokenizer


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case(name, request):
    run_case(_REF, name, request)


def test_both_libraries_build_and_load_side_by_side():
    assert pnative.available() and jnative.available()
    info = pnative.BUILD_INFO
    assert info["abi"] == 1 and "-march=native" in info["flags"]
    assert info["path"].endswith(".so") and "dl4jtpu_native-" in info["path"]
    # two files, two handles: neither library's symbols bind the other's
    assert pnative.get_lib().cdll._name != jnative.get_lib()._name
    assert pnative.get_lib().cdll._handle != jnative.get_lib()._handle


def test_the_build_key_names_the_sources_flags_compiler_and_cpu(
        monkeypatch):
    key = pnative.build_key()
    assert len(key) == 16 and key == pnative.build_key()
    monkeypatch.setattr(pnative, "_cpu_model", lambda: "another cpu")
    assert pnative.build_key() != key
    monkeypatch.undo()
    monkeypatch.setattr(pnative, "FLAG_VARIANTS", ((),))
    assert pnative.build_key() != key


def test_the_cache_directory_knob(monkeypatch, tmp_path):
    import os
    want = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(pnative.__file__))), "..", "build", "native")
    assert os.path.samefile(pnative.cache_dir(), os.path.normpath(want))
    monkeypatch.setenv("DL4J_CUDA_NATIVE_CACHE", str(tmp_path / "n"))
    assert pnative.cache_dir() == str(tmp_path / "n")
    assert (tmp_path / "n").is_dir()


def test_calls_count_each_c_function():
    pnative.reset_calls()
    a = pnd.HostNDArray(np.ones((3, 4), np.float32))
    a.mmul(a, transpose_b=True)
    a.tanh()
    a.tanh()
    assert pnative.CALLS["gemm_f32"] == 1
    assert pnative.CALLS["transform_f32"] == 2
    assert "dot_f32" not in pnative.CALLS


# ------------------------------------------------------ bitwise, library
def _rs(seed):
    return np.random.RandomState(seed)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32 if a.itemsize == 4
                                             else np.uint64),
                                      b.view(np.uint32 if b.itemsize == 4
                                             else np.uint64))
    else:
        np.testing.assert_array_equal(a, b)


def _gemm(nd):
    rs = _rs(0)
    A = rs.randn(37, 23).astype("float32")
    B = rs.randn(23, 41).astype("float32")
    out = []
    for ta in (False, True):
        for tb in (False, True):
            a = A.T.copy() if ta else A
            b = B.T.copy() if tb else B
            out.append(nd.HostNDArray(a).mmul(nd.HostNDArray(b),
                                              transpose_a=ta,
                                              transpose_b=tb,
                                              alpha=0.75).numpy())
    return out


def _blas1(nd):
    rs = _rs(1)
    x = rs.randn(1000).astype("float32")
    y = rs.randn(1000).astype("float32")
    hy = nd.HostNDArray(y.copy())
    nd.HostNDArray(x).axpy(0.5, hy)
    return [np.float32(nd.HostNDArray(x).dot(nd.HostNDArray(y))),
            np.float32(nd.HostNDArray(x).norm2()), hy.numpy()]


TRANSFORMS = ("exp", "log", "tanh", "sigmoid", "relu", "sqrt", "abs", "neg",
              "square", "add_scalar", "mul_scalar", "pow_scalar",
              "clip_min", "clip_max", "sign", "reciprocal")


def _transforms(nd):
    rs = _rs(2)
    x = rs.randn(19, 31).astype("float32") * 3
    x[0, :3] = (np.nan, np.inf, 0.0)
    a = nd.HostNDArray(x)
    pos = nd.HostNDArray(np.abs(x) + 0.1)
    return [a._transform(n, 1.7).numpy() for n in TRANSFORMS] + \
        [pos._transform(n, 0.5).numpy() for n in ("log", "sqrt",
                                                 "pow_scalar")] + \
        [a.clip(-0.5, 0.25).numpy()]


def _binary(nd):
    rs = _rs(3)
    x = rs.randn(19, 31).astype("float32")
    y = rs.randn(19, 31).astype("float32") + 0.01
    v = rs.randn(31).astype("float32") + 0.01
    a = nd.HostNDArray(x)
    out = [a._binary(n, nd.HostNDArray(y)).numpy()
           for n in ("add", "sub", "mul", "div", "max", "min")]
    out += [a.broadcast_row(n, v).numpy()
            for n in ("add", "sub", "mul", "div", "max", "min")]
    out += [(a + 1.5).numpy(), (a - 2.0).numpy(), (a * 3.0).numpy(),
            (a / 7.0).numpy(), (10.0 - a).numpy(), (6.0 / (a + 9.0)).numpy()]
    return out


def _reductions(nd):
    rs = _rs(4)
    a = nd.HostNDArray(rs.randn(29, 37).astype("float32"))
    out = []
    for name in ("sum", "mean", "max", "min", "norm2"):
        out.append(np.float32(a._reduce(name, None)))
        for axis in (0, 1):
            out.append(a._reduce(name, axis).numpy())
    out += [a.argmax(axis=0), a.argmax(axis=1), a.argmax(axis=None)]
    return out


def _conv(nd):
    rs = _rs(5)
    img = rs.randn(3, 11, 9).astype("float32")
    cols = nd.im2col(img, 3, 3, 2, 2, 1, 1)
    back = nd.col2im(rs.randn(*cols.shape).astype("float32"), 3, 11, 9, 3,
                     3, 2, 2, 1, 1)
    return [cols, back]


def _random(nd):
    return [nd.HostNDArray.rand(5000, seed=7, lo=-2.0, hi=3.0).numpy(),
            nd.HostNDArray.randn(5001, seed=9, mean=1.0, std=2.0).numpy()]


def _distance(nd):
    rs = _rs(6)
    X = rs.randn(64, 17).astype("float32")
    Q = rs.randn(9, 17).astype("float32")
    b = rs.randint(0, 256, (13, 28, 28)).astype(np.uint8)
    return [nd.pairwise_sqdist(X, Q), nd.scale_u8(b, 1 / 255.0),
            nd.scale_u8(b, 0.5, -3.0)]


OPS = {"gemm_all_transposes": _gemm, "dot_nrm2_axpy": _blas1,
       "transforms": _transforms, "binary_and_broadcast": _binary,
       "reductions": _reductions, "im2col_col2im": _conv,
       "random": _random, "distance_and_scale_u8": _distance}


@pytest.mark.parametrize("op", sorted(OPS))
def test_ndarray_ops_are_bitwise_the_reference_library(op):
    assert pnative.available() and jnative.available()
    pnative.reset_calls()
    with np.errstate(all="ignore"):
        ours, theirs = OPS[op](pnd), OPS[op](jnd)
    assert sum(pnative.CALLS.values()) > 0
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _same(a, b)


@pytest.fixture
def both_twins():
    """Both libraries reported unavailable: the numpy twins run."""
    saved = [(m, m._lib, m._build_failed) for m in (pnative, jnative)]
    for m in (pnative, jnative):
        m._lib, m._build_failed = None, True
    yield
    for m, lib, failed in saved:
        m._lib, m._build_failed = lib, failed


@pytest.mark.parametrize("op", sorted(OPS))
def test_numpy_twins_are_the_references_twins(op, both_twins):
    assert not pnative.available() and not jnative.available()
    with np.errstate(all="ignore"):
        ours, theirs = OPS[op](pnd), OPS[op](jnd)
    for a, b in zip(ours, theirs):
        _same(a, b)


def _bh(native):
    rs = _rs(8)
    Y = rs.randn(200, 2).astype(np.float32)
    neg = np.zeros_like(Y)
    stats = (ctypes.c_int64 * 1)()
    z = native.get_lib().bh_repulsion_f32(
        Y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 200, 2,
        ctypes.c_float(0.5),
        neg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), stats)
    return neg, z, int(stats[0])


def test_barnes_hut_repulsion_is_bitwise_the_reference_library():
    (a, za, va), (b, zb, vb) = _bh(pnative), _bh(jnative)
    _same(a, b)
    assert za == zb and va == vb > 0


def test_csv_parse_is_bitwise_the_reference_library(tmp_path):
    from deeplearning4j_tpu.data.records import parse_numeric_csv as jcsv
    from deeplearning4j_tpu_torch.data.records import parse_numeric_csv
    rs = _rs(9)
    M = rs.randn(300, 7) * 10.0 ** rs.randint(-30, 30, (300, 7))
    p = tmp_path / "m.csv"
    p.write_text("a,b,c,d,e,f,g\n" + "\n".join(
        ";".join(repr(float(v)) for v in r) for r in M) + "\n")
    ours = parse_numeric_csv(str(p), ";", skip_lines=1)
    _same(ours, jcsv(str(p), ";", skip_lines=1))
    assert ours.shape == (300, 7)
    bad = tmp_path / "bad.csv"
    bad.write_text("1;2\n3;x\n")
    assert parse_numeric_csv(str(bad), ";") is None


def test_tokenizer_counts_and_encode_are_the_reference_library():
    from deeplearning4j_tpu.text.native_tokenizer import (
        NativeCorpusEncoder as J,
    )
    from deeplearning4j_tpu_torch.text.native_tokenizer import (
        NativeCorpusEncoder as P,
    )
    rs = _rs(10)
    words = ["Alpha", "beta,", "GAMMA!", "delta", "e1ps", "(zeta)", "eta;"]
    docs = [" ".join(rs.choice(words, rs.randint(0, 12))) for _ in range(60)]
    for common in (True, False):
        ours = P(common_preprocess=common).count_or_none(docs)
        assert ours == J(common_preprocess=common).count_or_none(docs)
        vocab = {w: i * 3 for i, w in enumerate(sorted(ours))}
        for keep in (False, True):
            a = P(common).encode_or_none(docs, vocab, keep_oov=keep)
            b = J(common).encode_or_none(docs, vocab, keep_oov=keep)
            assert len(a) == len(b) == len(docs)
            for x, y in zip(a, b):
                _same(x, y)


def test_codec_is_bitwise_the_reference_library():
    rs = _rs(11)
    g = (rs.randn(5000) * 1e-2).astype(np.float32)
    g[rs.choice(5000, 90, replace=False)] *= 100
    for thr, cap in ((0.1, 200), (0.0, 37), (1e-3, 5000)):
        ours = pnative.threshold_encode(g, thr, cap)
        theirs = jnative.threshold_encode(g, thr, cap)
        for a, b in zip(ours, theirs):
            _same(a, b)
        dense = rs.randn(5000).astype(np.float32)
        _same(pnative.decode_accumulate(dense, ours[0], ours[1]),
              jnative.decode_accumulate(dense, theirs[0], theirs[1]))


def test_hogwild_skipgram_is_bitwise_the_reference_library_one_thread():
    """`sg_ns_train` at n_threads=1 on the same tables, corpus, table and
    seed: the same tables and loss, bit for bit."""
    rs = _rs(12)
    V, D = 50, 16
    syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rs.rand(V, D) * 0.01).astype(np.float32)
    corpus = rs.randint(0, V, 2000).astype(np.int32)
    offsets = np.array([0, 700, 1300, 2000], np.int64)
    table = rs.randint(0, V, 10000).astype(np.int32)
    out = []
    for lib in (pnative, jnative):
        a, b = syn0.copy(), syn1.copy()
        loss = lib.sg_ns_train(a, b, corpus, offsets, 4, 5, table, 0.025,
                               1e-4, 2000, seed=5, n_threads=1)
        out.append((a, b, loss))
    _same(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] and np.isfinite(out[0][2])
    assert not np.array_equal(out[0][0], syn0)


# ------------------------------------------------ rewritten reference cases
def test_codec_matches_the_torch_and_reference_encoders():
    """The native host codec and the port's torch encoder (and the
    reference's XLA one) agree on selection, values and residual."""
    import jax.numpy as jnp
    import torch
    from deeplearning4j_tpu.parallel.encoding import (
        threshold_encode_values as jvalues,
    )
    from deeplearning4j_tpu_torch.parallel.encoding import (
        threshold_encode_values,
    )
    g = _rs(1).randn(512).astype("float32")
    t_idx, t_vals, t_res = threshold_encode_values(torch.from_numpy(g), 0.8,
                                                   64)
    j_idx, _, j_res = jvalues(jnp.asarray(g), 0.8, 64)
    n_idx, n_vals, n_res = pnative.threshold_encode(g, 0.8, 64)
    valid = t_idx.numpy() >= 0
    assert set(t_idx.numpy()[valid].tolist()) == set(n_idx.tolist())
    assert set(np.asarray(j_idx)[np.asarray(j_idx) >= 0].tolist()) \
        == set(n_idx.tolist())
    order = np.argsort(n_idx)
    np.testing.assert_array_equal(
        n_vals[order], t_vals.numpy()[valid][np.argsort(
            t_idx.numpy()[valid])])
    np.testing.assert_allclose(t_res.numpy(), n_res, atol=1e-7)
    np.testing.assert_allclose(np.asarray(j_res), n_res, atol=1e-7)


def test_encoding_handler_native_backend_is_the_references():
    """`EncodingHandler(backend="native")`: the reference's messages,
    residual and adaptive threshold at every step, host tensors of the
    sent elements only; "jax", the reference's name of the device codec,
    is the port's "torch"."""
    import torch
    from deeplearning4j_tpu.parallel.encoding import EncodingHandler as J
    from deeplearning4j_tpu_torch.parallel.encoding import EncodingHandler
    with pytest.raises(ValueError, match="backend"):
        EncodingHandler(backend="cuda")
    ours = EncodingHandler(threshold=1e-3, boundary=0.05, backend="native")
    theirs = J(threshold=1e-3, boundary=0.05, backend="native")
    rs = _rs(13)
    pnative.reset_calls()
    for _ in range(4):
        g = (rs.randn(3000) * 1e-3).astype(np.float32)
        a = ours.encode(torch.from_numpy(g))
        b = theirs.encode(g)
        assert isinstance(a[0], torch.Tensor) and a[0].device.type == "cpu"
        assert len(a[0]) == len(b[0]) and (a[0] >= 0).all()
        _same(a[0].numpy(), b[0])
        _same(a[1].numpy(), b[1])
        assert a[2] == b[2]
        _same(ours._residual.numpy(), np.asarray(theirs._residual))
        assert ours.threshold == pytest.approx(theirs.threshold, rel=1e-6)
        assert ours.last_sparsity == theirs.last_sparsity
    assert pnative.CALLS["threshold_encode_f32"] == 4


def test_shared_gradients_rank_path_uses_native_codec():
    """The rank (socket) trainer of a model on the CPU picks the native
    codec when the library is built; a rank whose model is on the card,
    and the in-process simulation, stay on the device codec."""
    import socket
    import types

    import torch

    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel.shared import (
        SharedGradientsTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.transport import SocketTransport
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2))
            .list().layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with SocketTransport(rank=0, n_workers=1, base_port=port) as tr:
        t = SharedGradientsTrainer(net, n_workers=1, rank=0, transport=tr)
        assert t.handlers[0].backend == "native"
        x = _rs(14).rand(8, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[_rs(15).randint(0, 2, 8)]
        pnative.reset_calls()
        t.fit((x, y), epochs=1, batch_size=8)
        assert pnative.CALLS["threshold_encode_f32"] == 1
    loop = SharedGradientsTrainer(net, n_workers=2)
    assert [h.backend for h in loop.handlers] == ["torch", "torch"]
    on_card = types.SimpleNamespace(params={}, device=torch.device("cuda"))
    card = SharedGradientsTrainer(on_card, n_workers=2, rank=0,
                                  transport=object())
    assert [h.backend for h in card.handlers] == ["torch", "torch"]


def test_hogwild_skipgram_is_its_plain_version_one_thread():
    """`sg_ns_train` at n_threads=1 against `sg_ns_train_plain` (the same
    stream of windows and negatives in float64): tables within 1e-5 of
    their largest entry, the loss within 1e-5 relative."""
    rs = _rs(16)
    V, D = 20, 8
    syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rs.rand(V, D) * 0.05).astype(np.float32)
    corpus = rs.randint(0, V, 150).astype(np.int32)
    offsets = np.array([0, 60, 150], np.int64)
    table = rs.randint(0, V, 1000).astype(np.int32)
    a, b = syn0.copy(), syn1.copy()
    loss = pnative.sg_ns_train(a, b, corpus, offsets, 3, 4, table, 0.05,
                               1e-4, 150, seed=3, n_threads=1)
    pa, pb = syn0.astype(np.float64), syn1.astype(np.float64)
    plain = pnative.sg_ns_train_plain(pa, pb, corpus, offsets, 3, 4, table,
                                      0.05, 1e-4, 150, seed=3)
    for got, want in ((a, pa), (b, pb)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert loss == pytest.approx(plain, rel=1e-5)
    assert np.abs(pa - syn0).max() > 1e-3


def test_hogwild_thread_count_does_not_outlive_the_epoch():
    """The trainer's `omp_set_num_threads(n_threads)` set the calling
    thread's OpenMP count for every later parallel region of the runtime:
    the native library's (k-means seeding, the Barnes-Hut tree) and
    torch's where it shares libgomp. The wrapper puts it back."""
    lib = pnative.get_lib()
    get_max = getattr(lib.cdll, "omp_get_max_threads", None)
    if get_max is None:
        pytest.skip("the native library was built without OpenMP")
    rs = _rs(17)
    V, D = 20, 8
    syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = np.zeros((V, D), np.float32)
    corpus = rs.randint(0, V, 150).astype(np.int32)
    table = rs.randint(0, V, 1000).astype(np.int32)
    before = (get_max(), torch.get_num_threads())
    # start from 2 threads, so a count the epoch left at 1 shows
    lib.cdll.omp_set_num_threads(2)
    torch.set_num_threads(2)
    try:
        assert (get_max(), torch.get_num_threads()) == (2, 2)
        pnative.sg_ns_train(syn0, syn1, corpus, np.array([0, 150], np.int64),
                            3, 4, table, 0.05, 1e-4, 150, seed=3, n_threads=1)
        assert (get_max(), torch.get_num_threads()) == (2, 2)
    finally:
        lib.cdll.omp_set_num_threads(before[0])
        torch.set_num_threads(before[1])
