"""The port's record readers and bridges (`data/records.py`) against the
JAX package's, on the same seeded inputs (`tests/test_data.py`'s cases):
the CSV and collection readers, classification and regression, the
sequence readers in both alignment modes and with dual readers, the
multi-source iterator, the pre-processor contract, and
`ImageRecordReader` end to end (PIL decode, raw uint8, normalize=True,
grayscale), a CNN of the port training on it.

Every scenario runs once per package and the batches must be bitwise
equal. Both packages parse numeric CSV with their native libraries when
built and with the python csv reader otherwise; the two paths differ by
one ulp on one class of literals, so each path is held against the
reference's same path in its own test.
"""
import types

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.data import normalization as jnorm
from deeplearning4j_tpu.data import records as jrecords
from deeplearning4j_tpu_torch.data import normalization as pnorm
from deeplearning4j_tpu_torch.data import records as precords

PKGS = {"reference": types.SimpleNamespace(r=jrecords, norm=jnorm),
        "port": types.SimpleNamespace(r=precords, norm=pnorm)}


@pytest.fixture
def no_native(monkeypatch):
    """The reference's python CSV path: its native parser reports
    unavailable, as it does where the library is not built."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _arrays(batches):
    out = []
    for b in batches:
        if hasattr(b, "features_masks"):
            out.append(tuple(np.array(a) for a in (*b.features, *b.labels)))
        else:
            out.append(tuple(None if a is None else np.array(a) for a in (
                b.features, b.labels, b.features_mask, b.labels_mask)))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if u is None or v is None:
                assert u is None and v is None
            else:
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)


def _csv(tmp_path, rows, name="data.csv"):
    p = tmp_path / name
    p.write_text("\n".join(",".join(repr(v) for v in r) for r in rows))
    return str(p)


# ------------------------------------------------------------- scenarios
def csv_classification(m, tmp_path):
    rs = np.random.RandomState(1)
    rows = [[float(rs.randn()), float(rs.rand()), int(rs.randint(3))]
            for _ in range(11)]
    p = _csv(tmp_path, rows)
    it = m.r.RecordReaderDataSetIterator(m.r.CSVRecordReader(p), batch_size=4,
                                         label_index=2, num_classes=3)
    out = list(it)
    assert [b.features.shape for b in out] == [(4, 2), (4, 2), (3, 2)]
    it.reset()
    return out + list(it)


def csv_skip_lines_and_delimiter(m, tmp_path):
    p = tmp_path / "semi.csv"
    p.write_text("a;b;c\n# header two\n1.5;2.25;1\n3;4e-3;0\n\n5;6;1\n")
    it = m.r.RecordReaderDataSetIterator(
        m.r.CSVRecordReader(str(p), skip_lines=2, delimiter=";"),
        batch_size=2, label_index=2, num_classes=2)
    return list(it)


def regression_multi_column(m, tmp_path):
    rows = [[1, 2, 10, 20], [3, 4, 30, 40], [5, 6, 50, 60]]
    it = m.r.RecordReaderDataSetIterator(m.r.CollectionRecordReader(rows),
                                         batch_size=2, label_index=2,
                                         label_index_to=3, regression=True)
    out = list(it)
    np.testing.assert_allclose(out[0].features, [[1, 2], [3, 4]])
    np.testing.assert_allclose(out[0].labels, [[10, 20], [30, 40]])
    return out


def unlabeled_rows(m, tmp_path):
    rs = np.random.RandomState(2)
    rows = rs.randn(5, 3).tolist()
    return list(m.r.RecordReaderDataSetIterator(
        m.r.CollectionRecordReader(rows), batch_size=2))


def sequence_align_end(m, tmp_path):
    seqs = [[[0.1, 0], [0.2, 1], [0.3, 2]], [[0.4, 1]], [[0.5, 2], [0.6, 0]]]
    it = m.r.SequenceRecordReaderDataSetIterator(
        m.r.CollectionSequenceRecordReader(seqs), batch_size=2,
        num_classes=3, label_index=1)
    out = list(it)
    np.testing.assert_allclose(out[0].features_mask, [[1, 1, 1], [0, 0, 1]])
    return out


def sequence_align_start_and_regression(m, tmp_path):
    seqs = [[[0.1, 5.0], [0.2, 6.0], [0.3, 7.0]], [[0.4, 8.0]]]
    a = list(m.r.SequenceRecordReaderDataSetIterator(
        m.r.CollectionSequenceRecordReader(seqs), batch_size=2,
        num_classes=None, label_index=1, regression=True, align_end=False))
    b = list(m.r.SequenceRecordReaderDataSetIterator(
        m.r.CollectionSequenceRecordReader(seqs), batch_size=2,
        num_classes=None, label_index=-1, regression=True))
    np.testing.assert_allclose(a[0].features_mask, [[1, 1, 1], [1, 0, 0]])
    return a + b


def sequence_dual_readers(m, tmp_path):
    feats = [[[0.1], [0.2]], [[0.3], [0.4]], [[0.5], [0.6]]]
    labs = [[[0], [1]], [[1], [0]], [[1], [1]]]
    it = m.r.SequenceRecordReaderDataSetIterator(
        m.r.CollectionSequenceRecordReader(feats), batch_size=2,
        num_classes=2, labels_reader=m.r.CollectionSequenceRecordReader(labs))
    out = list(it)
    assert out[0].features_mask is None
    return out


def csv_sequence_files(m, tmp_path):
    rs = np.random.RandomState(3)
    paths = []
    for i, t in enumerate((4, 2, 3)):
        rows = [[float(rs.randn()), int(rs.randint(2))] for _ in range(t)]
        paths.append(_csv(tmp_path, rows, f"seq{i}.csv"))
    return list(m.r.SequenceRecordReaderDataSetIterator(
        m.r.CSVSequenceRecordReader(paths), batch_size=2, num_classes=2))


def multi_source(m, tmp_path):
    rows = [[1, 2, 0], [3, 4, 1], [5, 6, 2], [7, 8, 0], [9, 10, 1]]
    other = [[0.5, 1.5], [2.5, 3.5], [4.5, 5.5], [6.5, 7.5], [8.5, 9.5]]
    it = (m.r.RecordReaderMultiDataSetIterator(batch_size=2)
          .add_reader("r", m.r.CollectionRecordReader(rows))
          .add_reader("o", m.r.CollectionRecordReader(other))
          .add_input("r", 0, 1)
          .add_input("o")
          .add_output_one_hot("r", 2, 3)
          .add_output("o", 1, 1))
    out = list(it)
    assert [b.features[0].shape[0] for b in out] == [2, 2, 1]
    bad = (m.r.RecordReaderMultiDataSetIterator(batch_size=4)
           .add_reader("r", m.r.CollectionRecordReader(rows))
           .add_reader("o", m.r.CollectionRecordReader(other[:3]))
           .add_input("r"))
    with pytest.raises(ValueError, match="misaligned"):
        list(bad)
    return out


def pre_processor_contract(m, tmp_path):
    class Doubler:
        def preprocess(self, ds):
            if hasattr(ds, "features_masks"):
                return type(ds)(tuple(f * 2 for f in ds.features),
                                ds.labels)
            return type(ds)(ds.features * 2, ds.labels, ds.features_mask,
                            ds.labels_mask)

    it = m.r.RecordReaderDataSetIterator(
        m.r.CollectionRecordReader([[1.0, 2.0, 0.0], [3.0, 4.0, 1.0]]),
        batch_size=2, label_index=2, num_classes=2)
    it.set_pre_processor(Doubler())
    sit = m.r.SequenceRecordReaderDataSetIterator(
        m.r.CollectionSequenceRecordReader(
            [[[1.0, 0.0], [2.0, 0.0]], [[3.0, 1.0], [4.0, 1.0]]]),
        batch_size=2, label_index=1, num_classes=2)
    sit.set_pre_processor(Doubler())
    mm = m.r.RecordReaderMultiDataSetIterator(batch_size=2)
    mm.add_reader("a", m.r.CollectionRecordReader([[1.0, 5.0], [2.0, 6.0]]))
    mm.add_input("a", 0, 0)
    mm.add_output("a", 1, 1)
    mm.set_pre_processor(Doubler())
    return list(it) + list(sit) + list(mm)


def missing_num_classes(m, tmp_path):
    it = m.r.RecordReaderDataSetIterator(
        m.r.CollectionRecordReader([[1.0, 0.0]]), batch_size=1,
        label_index=1)
    with pytest.raises(ValueError, match="num_classes required"):
        list(it)
    return []


SCENARIOS = [csv_classification, csv_skip_lines_and_delimiter,
             regression_multi_column, unlabeled_rows, sequence_align_end,
             sequence_align_start_and_regression, sequence_dual_readers,
             csv_sequence_files, multi_source, pre_processor_contract,
             missing_num_classes]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario, tmp_path, no_native):
    got = {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _arrays(scenario(m, d))
    _equal(got["port"], got["reference"])


def _ulp_literals_csv(tmp_path):
    rs = np.random.RandomState(0)
    vals = rs.randn(500, 4) * 10.0 ** rs.randint(-8, 8, (500, 4))
    lines = [",".join(repr(float(v)) for v in r) for r in vals]
    lines.append("0.1,1e-45,3.4028235e38,1.17549435e-38")
    lines.append("16777217,2.00000011920928955078125,"
                 "1.0000000596046447753906251,7.006492321624085e-46")
    p = tmp_path / "num.csv"
    p.write_text("\n".join(lines) + "\n")
    return p, len(lines)


def _csv_features(records, p):
    return list(records.RecordReaderDataSetIterator(
        records.CSVRecordReader(str(p)), batch_size=1000))[0].features


def test_csv_parse_matches_the_reference_python_path(tmp_path, monkeypatch):
    """Without the native libraries both packages parse every value as
    python's float() then round to f32, bitwise alike. The native parser
    rounds the literal straight to f32: on a decimal just above the
    midpoint between two f32 values and within a double's precision of
    it, the double rounding of the python path lands one ulp lower. Both
    sides of that difference are pinned here and in the native test
    below."""
    from deeplearning4j_tpu_torch import native as pnative
    p, n_lines = _ulp_literals_csv(tmp_path)
    monkeypatch.setattr(pnative, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    assert precords.parse_numeric_csv(str(p)) is None
    port = _csv_features(precords, p)
    ref = _csv_features(jrecords, p)
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))
    assert port[-1, 2] == np.float32(1.0)       # float64 first, then f32
    monkeypatch.undo()
    native = precords.parse_numeric_csv(str(p))
    differ = np.argwhere(native.view(np.uint32) != port.view(np.uint32))
    assert differ.tolist() == [[n_lines - 1, 2]]


def test_csv_parse_is_bitwise_the_reference_native_parse(tmp_path):
    """With both native libraries built (same sources, same g++ flags),
    the port's matrix is bitwise the reference's native matrix, the
    literal that is one ulp above the python path's value included, and
    the port's CSV batches carry it."""
    from deeplearning4j_tpu_torch import native as pnative
    assert pnative.available() and jnative.available()
    p, n_lines = _ulp_literals_csv(tmp_path)
    calls = pnative.CALLS["csv_parse_f32"]
    port = precords.parse_numeric_csv(str(p))
    assert pnative.CALLS["csv_parse_f32"] == calls + 2     # two passes
    ref = jrecords.parse_numeric_csv(str(p))
    assert port.shape == ref.shape == (n_lines, 4)
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))
    assert port[-1, 2] == np.nextafter(np.float32(1), np.float32(2))
    batches = _csv_features(precords, p)
    np.testing.assert_array_equal(batches.view(np.uint32),
                                  _csv_features(jrecords, p).view(np.uint32))
    np.testing.assert_array_equal(batches.view(np.uint32),
                                  port.view(np.uint32))


def _png_tree(root, rs, classes=(("dark", 40), ("light", 200)), n=12):
    from PIL import Image
    for label, base in classes:
        d = root / label
        d.mkdir(parents=True)
        for i in range(n):
            arr = np.clip(base + rs.randn(10, 12, 3) * 10, 0,
                          255).astype("uint8")
            Image.fromarray(arr).save(d / f"{i}.png")


@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {"channels": 1},
                                {"shuffle": True, "seed": 3}],
                         ids=["raw", "normalize", "gray", "shuffled"])
def test_image_record_reader_matches_reference(kw, tmp_path, monkeypatch):
    """Label directories -> resized NHWC batches, bitwise the
    reference's: raw 0-255 uint8 (float32 [0, 1] with normalize=True),
    labels one-hot in sorted directory order."""
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "0")
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")
    _png_tree(tmp_path / "train", np.random.RandomState(0))
    got = {}
    for name, m in PKGS.items():
        kw2 = dict(kw)
        channels = kw2.pop("channels", 3)
        rr = m.r.ImageRecordReader(8, 8, channels, **kw2).initialize(
            str(tmp_path / "train"))
        assert rr.labels() == ["dark", "light"]
        it = m.r.RecordReaderDataSetIterator(rr, batch_size=5,
                                             label_index=-1, num_classes=2)
        got[name] = _arrays(it)
        regress = m.r.RecordReaderDataSetIterator(
            rr, batch_size=7, label_index=-1, regression=True)
        got[name] += _arrays(regress)
        got[name] += _arrays(m.r.RecordReaderDataSetIterator(rr, 24))
    _equal(got["port"], got["reference"])
    first = got["port"][0][0]
    assert first.dtype == (np.float32 if kw.get("normalize") else np.uint8)
    assert first.shape == (5, 8, 8, kw.get("channels", 3))


def test_image_reader_trains_a_port_cnn(tmp_path, monkeypatch):
    """The canonical DL4J flow on the port: ImageRecordReader, the scaler
    attached to the iterator (applied on the device seam), a CNN from
    the reference's zip fit for 15 epochs on the CPU: high accuracy, and
    the reference's parameters after the same fit within 1e-4."""
    from deeplearning4j_tpu.nn.conf import (
        InputType as JIT, NeuralNetConfiguration as JNNC,
    )
    from deeplearning4j_tpu.nn.layers import (
        ConvolutionLayer, GlobalPoolingLayer, OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updaters import Adam
    from deeplearning4j_tpu.util.serialization import save_model
    from deeplearning4j_tpu_torch.util.serialization import load_model
    monkeypatch.setenv("DL4J_CUDA_ETL_WORKERS", "0")
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")
    _png_tree(tmp_path / "train", np.random.RandomState(0))
    conf = (JNNC.Builder().seed(1).updater(Adam(1e-2)).list()
            .layer(ConvolutionLayer(n_out=4, kernel=(3, 3),
                                    activation="relu"))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(JIT.convolutional(8, 8, 3)).build())
    jnet = JMLN(conf).init()
    save_model(jnet, str(tmp_path / "cnn.zip"))
    net = load_model(str(tmp_path / "cnn.zip"), device="cpu")
    nets = {"reference": jnet, "port": net}
    for name, m in PKGS.items():
        rr = m.r.ImageRecordReader(8, 8, 3).initialize(
            str(tmp_path / "train"))
        it = m.r.RecordReaderDataSetIterator(rr, batch_size=6,
                                             label_index=-1, num_classes=2)
        it.set_pre_processor(m.norm.ImagePreProcessingScaler())
        nets[name].fit(it, epochs=15)
        assert nets[name].evaluate(it).accuracy() > 0.9, name
        assert it.pre_processor is not None     # restored after the fit
    np.testing.assert_allclose(net.params_flat().numpy(),
                               np.asarray(jnet.params_flat()),
                               rtol=0, atol=1e-4)


def test_load_image_imports_pil_lazily():
    import subprocess
    import sys
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.data.records\n"
            "assert 'PIL' not in sys.modules\n"
            "assert 'torch' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
