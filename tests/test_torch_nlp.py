"""The port's text pipeline and embedding trainers (`text/`,
`embeddings/`) against the JAX package's, on the CPU.

- The cases of `tests/test_nlp.py` and the text cases of
  `tests/test_cjk_iterators.py` run against the port
  (`_torch_reference_cases.port_cases`), with the trainers' default
  device mapped to the CPU.
- From the same seeded corpora both packages build the same
  vocabularies (words, counts, order), Huffman codes and points, unigram
  tables, and sample the same id batches and negatives: equal exactly.
- Each device step (skip-gram and CBOW, negative sampling and
  hierarchical softmax, GloVe's AdaGrad step) on batches whose rows
  repeat is within 1e-6 (f32, absolute, on tables of magnitude <= 1) of
  the reference's functional step after one step: a repeated row's
  gradient is computed from the tables before the step's updates.
- Word2Vec (SG/CBOW x NS/HS), ParagraphVectors (tables, label vectors,
  `infer_vector`), GloVe and `SparkWord2Vec` end within 1e-5 relative
  (max |delta| / max |table|) of the reference after three or more
  batches from the same `initial_syn0`/`initial_syn1neg`; the native
  HogWild backend at `n_threads=1` is bitwise the reference's.
- Word-vector text files are read both ways; the vectorizers and the
  CJK tokenizers give the reference's outputs.
- A fit that asks for no device raises without CUDA.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_reference_cases import case_names, port_cases, run_case
from deeplearning4j_tpu import embeddings as J
from deeplearning4j_tpu import text as JT
from deeplearning4j_tpu.embeddings import glove as jglove
from deeplearning4j_tpu.embeddings import sequencevectors as jsv
from deeplearning4j_tpu_torch import embeddings as P
from deeplearning4j_tpu_torch import text as PT
from deeplearning4j_tpu_torch.embeddings import glove as pglove
from deeplearning4j_tpu_torch.embeddings import sequencevectors as psv
from deeplearning4j_tpu_torch.util import platform

STEP_TOL = 1e-6
FIT_REL_TOL = 1e-5

_NLP = port_cases("tests/test_nlp.py")
_CJK = port_cases("tests/test_cjk_iterators.py", names=(
    "test_chinese_tokenizer_lexicon_longest_match",
    "test_chinese_tokenizer_bigrams_without_lexicon",
    "test_japanese_tokenizer_script_boundaries",
    "test_korean_tokenizer_strips_particles",
    "test_cjk_feeds_vectorizer_pipeline"))

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


_CPU_DEFAULT = ("deeplearning4j_tpu_torch.embeddings.sequencevectors",
                "deeplearning4j_tpu_torch.embeddings.glove",
                "deeplearning4j_tpu_torch.embeddings.distributed",
                "deeplearning4j_tpu_torch.nn.multilayer")


@pytest.fixture
def cpu_default(monkeypatch):
    """The reference's cases call fit() without a device: map the
    default to the CPU in the modules that resolve it."""
    import importlib

    def resolve(device=None):
        return platform.resolve_device("cpu" if device is None else device)
    for mod in _CPU_DEFAULT:
        monkeypatch.setattr(importlib.import_module(mod), "resolve_device",
                            resolve)


@pytest.mark.parametrize("name", case_names(_NLP))
def test_reference_nlp_case(name, request, cpu_default):
    run_case(_NLP, name, request)


@pytest.mark.parametrize("name", case_names(_CJK))
def test_reference_cjk_case(name, request, cpu_default):
    run_case(_CJK, name, request)


def test_fit_without_cuda_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is the card")
    corpus = ["a b c d e", "b c d e f"]
    for model in (P.Word2Vec(layer_size=4), P.Glove(layer_size=4),
                  P.ParagraphVectors(layer_size=4),
                  P.SparkWord2Vec(layer_size=4)):
        src = [(f"d{i}", s) for i, s in enumerate(corpus)] \
            if isinstance(model, P.ParagraphVectors) else corpus
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.fit(src)
        assert len(model.vocab) == 0        # raised before any work
    w = P.Word2Vec(layer_size=4, min_count=1).fit(corpus, device="cpu")
    assert w.device == torch.device("cpu") and w.vectors.shape == (6, 4)


# ------------------------------------------------------------- corpora
def _zipf_corpus(n_sent=12, length=10, n_words=25, seed=0):
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    words = [f"w{i}" for i in range(n_words)]
    return [" ".join(rs.choice(words, length, p=p)) for _ in range(n_sent)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------- vocab and sampling
def test_vocab_huffman_and_unigram_table_are_the_references():
    corpus = _zipf_corpus(40, 12, 60, seed=1)
    for min_count in (1, 3):
        a = P.Word2Vec(min_count=min_count, use_hierarchic_softmax=True)
        b = J.Word2Vec(min_count=min_count, use_hierarchic_softmax=True)
        a.build_vocab(iter(corpus))
        b.build_vocab(iter(corpus))
        assert a.vocab.words() == b.vocab.words()
        for va, vb in zip(a.vocab.vocab_words(), b.vocab.vocab_words()):
            assert (va.word, va.count, va.index, va.codes, va.points) == \
                (vb.word, vb.count, vb.index, vb.codes, vb.points)
        np.testing.assert_array_equal(a.vocab.unigram_table(),
                                      b.vocab.unigram_table())
        assert a.vocab.max_code_length() == b.vocab.max_code_length()
    # the native counting pass (a list source) gives the same vocabulary
    a, b = P.Word2Vec(min_count=2), J.Word2Vec(min_count=2)
    a.build_vocab(corpus)
    b.build_vocab(corpus)
    assert a._native_counts(corpus) is not None
    assert [(w, a.vocab.count_of(w)) for w in a.vocab.words()] == \
        [(w, b.vocab.count_of(w)) for w in b.vocab.words()]


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
@pytest.mark.parametrize("subsampling", [0.0, 1e-2])
def test_sampled_id_batches_are_the_references(algo, subsampling):
    corpus = _zipf_corpus(10, 14, 30, seed=2)
    kw = dict(min_count=1, window=3, batch_size=32, seed=5,
              elements_learning_algorithm=algo, subsampling=subsampling)
    a, b = P.Word2Vec(**kw), J.Word2Vec(**kw)
    a.build_vocab(iter(corpus))
    b.build_vocab(iter(corpus))
    ra, rb = np.random.RandomState(9), np.random.RandomState(9)
    ba, bb = list(a._batches(corpus, ra)), list(b._batches(corpus, rb))
    assert len(ba) == len(bb) >= 3
    for x, y in zip(ba, bb):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    # the negative draws that follow are the same too
    table = a.vocab.unigram_table()
    np.testing.assert_array_equal(ra.choice(len(a.vocab), (64, 5), p=table),
                                  rb.choice(len(b.vocab), (64, 5), p=table))


# ---------------------------------------------------------- device steps
V, D, N, K, L, W = 12, 8, 24, 4, 5, 6


def _step_inputs(seed):
    rs = np.random.RandomState(seed)
    w_in = ((rs.rand(V, D) - 0.5)).astype(np.float32)
    w_out = ((rs.rand(V, D) - 0.5)).astype(np.float32)
    syn1 = ((rs.rand(V - 1, D) - 0.5)).astype(np.float32)
    # few ids for many rows: every id repeats within the batch
    centers = rs.randint(0, 4, N).astype(np.int32)
    targets = rs.randint(0, 5, (N, 1 + K)).astype(np.int32)
    labels = np.zeros((N, 1 + K), np.float32)
    labels[:, 0] = 1.0
    points = rs.randint(0, V - 1, (N, L)).astype(np.int32)
    codes = rs.randint(0, 2, (N, L)).astype(np.float32)
    mask = (rs.rand(N, L) < 0.8).astype(np.float32)
    ctx_ids = rs.randint(0, 5, (N, W)).astype(np.int32)
    ctx_mask = (rs.rand(N, W) < 0.7).astype(np.float32)
    ctx_mask[:, 0] = 1.0
    ctx_mask[3] = 0.0                   # a row with an empty window
    return dict(w_in=w_in, w_out=w_out, syn1=syn1, centers=centers,
                targets=targets, labels=labels, points=points, codes=codes,
                mask=mask, ctx_ids=ctx_ids, ctx_mask=ctx_mask)


STEPS = {
    "sg_ns": (("w_in", "w_out"), ("centers", "targets", "labels")),
    "sg_hs": (("w_in", "syn1"), ("centers", "points", "codes", "mask")),
    "cbow_hs": (("w_in", "syn1"), ("ctx_ids", "ctx_mask", "points",
                                   "codes", "mask")),
    "cbow_ns": (("w_in", "w_out"), ("ctx_ids", "ctx_mask", "targets",
                                    "labels")),
}


def _t(a):
    a = torch.from_numpy(np.array(a))
    return a.long() if a.dtype == torch.int32 else a


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_device_step_is_the_references_functional_step(step, seed):
    x = _step_inputs(seed)
    tables, args = STEPS[step]
    lr = np.float32(0.7)
    ref = getattr(jsv, f"_{step}_step")(
        *(jnp.asarray(x[t]) for t in tables),
        *(jnp.asarray(x[a]) for a in args), lr)
    ours = [_t(x[t]) for t in tables]
    loss = getattr(psv, f"_{step}_step")(*ours, *(_t(x[a]) for a in args),
                                         float(lr))
    for mine, theirs, before in zip(ours, ref[:2], tables):
        assert not np.array_equal(mine.numpy(), x[before])
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=0, atol=STEP_TOL)
    assert float(loss) == pytest.approx(float(ref[2]), rel=1e-6)


def test_step_reads_repeated_rows_before_its_updates():
    """A sequential (read-after-update) step would differ from the
    reference on a batch whose center repeats; the port's does not."""
    x = _step_inputs(3)
    x["centers"][:] = 2
    ref = jsv._sg_ns_step(jnp.asarray(x["w_in"]), jnp.asarray(x["w_out"]),
                          jnp.asarray(x["centers"]),
                          jnp.asarray(x["targets"]),
                          jnp.asarray(x["labels"]), np.float32(5.0))
    w_in, w_out = _t(x["w_in"]), _t(x["w_out"])
    psv._sg_ns_step(w_in, w_out, _t(x["centers"]), _t(x["targets"]),
                    _t(x["labels"]), 5.0)
    np.testing.assert_allclose(w_in.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(w_out.numpy(), np.asarray(ref[1]), atol=1e-5)


def test_glove_step_is_the_references_functional_step():
    rs = np.random.RandomState(4)
    tabs = [((rs.rand(V, D) - 0.5)).astype(np.float32) for _ in range(2)]
    tabs += [np.zeros(V, np.float32), np.zeros(V, np.float32)]
    tabs += [np.full((V, D), 1e-8, np.float32) + rs.rand(V, D)
             .astype(np.float32) * 0.1 for _ in range(2)]
    tabs += [np.full(V, 1e-8, np.float32) for _ in range(2)]
    rows = rs.randint(0, 4, N).astype(np.int32)
    cols = rs.randint(0, 4, N).astype(np.int32)
    logx = np.log(rs.rand(N).astype(np.float32) * 5 + 1)
    fx = rs.rand(N).astype(np.float32)
    ref = jglove._glove_step(*(jnp.asarray(t) for t in tabs),
                             jnp.asarray(rows), jnp.asarray(cols),
                             jnp.asarray(logx), jnp.asarray(fx),
                             np.float32(0.05))
    ours = [_t(t) for t in tabs]
    loss = pglove._glove_step(*ours, _t(rows), _t(cols), _t(logx), _t(fx),
                              0.05)
    for mine, theirs in zip(ours, ref[:8]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=STEP_TOL)
    assert float(loss) == pytest.approx(float(ref[8]), rel=1e-6)


# ----------------------------------------------------------------- fits
STEP_NAMES = ("_sg_ns_step", "_sg_hs_step", "_cbow_hs_step",
              "_cbow_ns_step")


@pytest.fixture
def count_steps(monkeypatch):
    """Counts the port's device steps by name."""
    counts = {}
    for name in STEP_NAMES:
        fn = getattr(psv, name)

        def counted(*a, _fn=fn, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(psv, name, counted)
    return counts


W2V_MODES = {"sg_ns": {}, "cbow_ns": {"elements_learning_algorithm": "cbow"},
             "sg_hs": {"negative": 0, "use_hierarchic_softmax": True},
             "cbow_hs": {"negative": 0, "use_hierarchic_softmax": True,
                         "elements_learning_algorithm": "cbow"},
             "sg_ns_hs": {"use_hierarchic_softmax": True}}


@pytest.mark.parametrize("mode", sorted(W2V_MODES))
def test_word2vec_tables_are_the_references(mode, count_steps):
    corpus = _zipf_corpus(8, 10, 20, seed=6)
    kw = dict(layer_size=16, window=3, min_count=1, batch_size=24,
              learning_rate=0.8, seed=11, **W2V_MODES[mode])
    a, b = P.Word2Vec(**kw), J.Word2Vec(**kw)
    a.build_vocab(iter(corpus))
    b.build_vocab(iter(corpus))
    rs = np.random.RandomState(3)
    n = len(a.vocab)
    syn0 = ((rs.rand(n, 16) - 0.5) / 16).astype(np.float32)
    syn1neg = (rs.rand(n, 16) * 0.1).astype(np.float32)
    syn0_before = syn0.copy()
    a.fit(corpus, initial_syn0=syn0, initial_syn1neg=syn1neg, device="cpu")
    b.fit(corpus, initial_syn0=syn0, initial_syn1neg=syn1neg)
    np.testing.assert_array_equal(syn0, syn0_before)    # never written
    assert sum(count_steps.values()) >= 3
    assert _rel(a.vectors, b.vectors) <= FIT_REL_TOL
    assert _rel(a.w_out, b.w_out) <= FIT_REL_TOL
    assert _rel(a.syn1, b.syn1) <= FIT_REL_TOL
    assert _rel(a.vectors, syn0) > 1e-3                 # it trained


def test_word2vec_native_backend_is_bitwise_the_references():
    corpus = _zipf_corpus(30, 12, 40, seed=7)
    kw = dict(layer_size=16, window=3, min_count=1, negative=4, epochs=2,
              backend="native", n_threads=1, seed=2)
    a, b = P.Word2Vec(**kw).fit(corpus), J.Word2Vec(**kw).fit(corpus)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.w_out, b.w_out)
    assert a.last_loss == b.last_loss


def _docs(seed=8):
    rs = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur"]
    vehicles = ["car", "bus", "road", "wheel"]
    docs = []
    for i in range(6):
        docs.append((f"animal_{i}", " ".join(rs.choice(animals, 8))))
        docs.append((f"vehicle_{i}", " ".join(rs.choice(vehicles, 8))))
    return docs


def test_paragraph_vectors_and_infer_vector_are_the_references(
        count_steps):
    kw = dict(layer_size=12, window=2, min_count=1, negative=3, epochs=2,
              batch_size=48, learning_rate=0.5, seed=4)
    a = P.ParagraphVectors(**kw).fit(_docs(), device="cpu")
    b = J.ParagraphVectors(**kw).fit(_docs())
    assert a.labels == b.labels
    assert count_steps["_sg_ns_step"] >= 3
    assert _rel(a.vectors, b.vectors) <= FIT_REL_TOL
    assert _rel(a.w_out, b.w_out) <= FIT_REL_TOL
    assert _rel(a.label_vectors, b.label_vectors) <= FIT_REL_TOL
    w_out = a.w_out.copy()
    va = a.infer_vector("cat dog fur pet", steps=5)
    vb = b.infer_vector("cat dog fur pet", steps=5)
    assert _rel(va, vb) <= FIT_REL_TOL
    np.testing.assert_array_equal(a.w_out, w_out)   # the table is frozen
    assert a.nearest_labels("car bus road", top_n=3) == \
        b.nearest_labels("car bus road", top_n=3)


def test_glove_is_the_references():
    corpus = _zipf_corpus(10, 10, 20, seed=9)
    kw = dict(layer_size=12, window=3, min_count=1, epochs=2,
              batch_size=64, seed=5)
    a = P.Glove(**kw).fit(corpus, device="cpu")
    b = J.Glove(**kw).fit(corpus)
    n_pairs = len(a._cooccurrences(corpus))
    assert 2 * -(-n_pairs // 64) >= 3                   # batches run
    assert _rel(a.vectors, b.vectors) <= FIT_REL_TOL
    assert a.last_loss == pytest.approx(b.last_loss, rel=1e-5)


def test_spark_word2vec_is_the_references(count_steps):
    corpus = _zipf_corpus(12, 10, 20, seed=10)
    kw = dict(n_workers=2, layer_size=12, window=2, min_count=1, epochs=2,
              batch_size=32, seed=3)
    a = P.SparkWord2Vec(**kw).fit(corpus, device="cpu")
    b = J.SparkWord2Vec(**kw).fit(corpus)
    assert count_steps["_sg_ns_step"] >= 3
    assert _rel(a.vectors, b.vectors) <= FIT_REL_TOL
    assert _rel(a.w_out, b.w_out) <= FIT_REL_TOL


# ------------------------------------------------------- files and text
def test_word_vector_files_read_both_ways(tmp_path):
    corpus = _zipf_corpus(10, 10, 20, seed=12)
    a = P.Word2Vec(layer_size=8, min_count=1, seed=1).fit(corpus,
                                                          device="cpu")
    b = J.Word2Vec(layer_size=8, min_count=1, seed=1).fit(corpus)
    pa, pb = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    a.save_text(pa)
    b.save_text(pb)
    for path, src in ((pa, a), (pb, b)):
        for loader in (P.WordVectors.load_text, J.WordVectors.load_text):
            got = loader(path)
            assert got.vocab.words() == src.vocab.words()
            np.testing.assert_allclose(got.vectors, src.vectors, atol=1e-6)
    assert P.WordVectors.load_text(pb).words_nearest("w1", 3) == \
        J.WordVectors.load_text(pb).words_nearest("w1", 3)


def test_vectorizers_and_tokenizers_are_the_references():
    docs = [(s, "ab"[i % 2]) for i, s in enumerate(_zipf_corpus(12, 9, 15))]
    for name in ("TfidfVectorizer", "BagOfWordsVectorizer"):
        a = getattr(PT, name)(docs, min_word_frequency=2,
                              stop_words=["w0"]).fit()
        b = getattr(JT, name)(docs, min_word_frequency=2,
                              stop_words=["w0"]).fit()
        assert a.vocab == b.vocab
        da, db = a.vectorize(), b.vectorize()
        np.testing.assert_array_equal(da.features, np.asarray(db.features))
        np.testing.assert_array_equal(da.labels, np.asarray(db.labels))
        np.testing.assert_array_equal(a.transform("w1 w2 w2 w9"),
                                      b.transform("w1 w2 w2 w9"))
    texts = ["The QUICK brown fox, 12 dogs!", "我在北京大学学习 NLP 2024",
             "私はカタカナとKanjiをtokenizeします", "고양이가 집에서 잔다"]
    for name, kw in (("DefaultTokenizerFactory", {}),
                     ("NGramTokenizerFactory", {"min_n": 1, "max_n": 3}),
                     ("ChineseTokenizerFactory", {"lexicon": ["北京大学"]}),
                     ("JapaneseTokenizerFactory", {}),
                     ("KoreanTokenizerFactory", {})):
        for t in texts:
            assert getattr(PT, name)(**kw).tokenize(t) == \
                getattr(JT, name)(**kw).tokenize(t), (name, t)
    pp = PT.DefaultTokenizerFactory(PT.CommonPreprocessor())
    jp = JT.DefaultTokenizerFactory(JT.CommonPreprocessor())
    assert pp.tokenize(texts[0]) == jp.tokenize(texts[0])
