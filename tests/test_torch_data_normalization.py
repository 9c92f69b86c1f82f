"""The port's normalizers and device-side normalization against the JAX
package (`data/normalization.py`): transform, revert, save and restore,
each normalizer's `device_affine`, engaging and detaching it on an
iterator chain, and fit with the affine on the device against fit on
host-normalized features (per-call and scan, both containers, bf16
normalize-then-cast), with the pre-processor restored on error.
Mirrors tests/test_device_norm.py.

Tolerances: normalizer outputs f32 rtol 1e-6 (the same numpy math);
the affine against the transform atol 1e-5 (x * (1/s) against x / s);
fits with the device affine against host normalization rtol 2e-4,
atol 2e-5 (the reference's own bound for that comparison).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import normalization as jnorm
from deeplearning4j_tpu.data.dataset import (
    DataSet as JDataSet, MultiDataSet as JMDS,
)
from deeplearning4j_tpu_torch.data import normalization as pnorm
from deeplearning4j_tpu_torch.data.async_iterator import AsyncDataSetIterator
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GraphBuilder, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_leaves

NORMALIZERS = ["standardize", "standardize_labels", "minmax", "image",
               "image_pm1", "vgg16"]


def _pair(kind):
    """(port normalizer, reference normalizer, fitted on the same data)."""
    rs = np.random.RandomState(3)
    x = (rs.randn(64, 3) * 3 + 1).astype(np.float32)
    y = rs.randn(64, 2).astype(np.float32)
    make = {"standardize": lambda m: m.NormalizerStandardize(),
            "standardize_labels": lambda m: m.NormalizerStandardize(
                fit_labels=True),
            "minmax": lambda m: m.NormalizerMinMaxScaler(-1, 2),
            "image": lambda m: m.ImagePreProcessingScaler(),
            "image_pm1": lambda m: m.ImagePreProcessingScaler(-1, 1),
            "vgg16": lambda m: m.VGG16ImagePreProcessor()}[kind]
    p, j = make(pnorm), make(jnorm)
    if hasattr(p, "fit"):
        p.fit(ArrayDataSetIterator(x, y, batch_size=16))
        j.fit(JDataSet(x, y))
    if kind in ("image", "image_pm1", "vgg16"):
        x = rs.randint(0, 256, (8, 4, 4, 3)).astype(np.uint8)
    return p, j, x, y


@pytest.mark.parametrize("kind", NORMALIZERS)
def test_normalizer_matches_the_reference(kind, tmp_path):
    p, j, x, y = _pair(kind)
    pd = p.preprocess(DataSet(x, y))
    jd = j.preprocess(JDataSet(x, y))
    np.testing.assert_allclose(pd.features, np.asarray(jd.features),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pd.labels, np.asarray(jd.labels), rtol=1e-6)
    if hasattr(p, "revert"):
        back = p.revert(pd)
        np.testing.assert_allclose(back.features,
                                   np.asarray(j.revert(jd).features),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(back.features, x, rtol=1e-4, atol=1e-4)
    if hasattr(p, "save"):
        # the statistics file moves between the packages both ways
        p.save(str(tmp_path / "p.json"))
        j.save(str(tmp_path / "j.json"))
        jp = type(j).restore(str(tmp_path / "p.json"))
        pj = type(p).restore(str(tmp_path / "j.json"))
        np.testing.assert_allclose(pj.transform(x), jp.transform(x),
                                   rtol=1e-6)
    pa, ja = p.device_affine(), j.device_affine()
    assert (pa is None) == (ja is None) == (kind == "standardize_labels")
    if pa is not None:
        for a, b in zip(pa, ja):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
        # normalize in f32 on the device, as the host transform does
        got = pnorm.apply_device_affine(
            torch.from_numpy(np.asarray(x)), torch.as_tensor(pa[0]),
            torch.as_tensor(pa[1]), torch.float32)
        np.testing.assert_allclose(got.numpy(), p.transform(x), atol=1e-5)


def test_minmax_unfitted_has_no_affine_and_multi_normalizer_matches():
    assert pnorm.NormalizerMinMaxScaler().device_affine() is None
    rs = np.random.RandomState(4)
    feats = [(rs.randn(16, 3) * 2 + 5).astype(np.float32),
             rs.randn(16, 2).astype(np.float32)]
    labels = (rs.randn(16, 1).astype(np.float32),)
    p = pnorm.MultiNormalizerStandardize().fit([MultiDataSet(tuple(feats),
                                                             labels)])
    j = jnorm.MultiNormalizerStandardize().fit([JMDS(tuple(feats), labels)])
    for a, b in zip(p.preprocess(MultiDataSet(tuple(feats), labels)).features,
                    j.preprocess(JMDS(tuple(feats), labels)).features):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_engage_detaches_and_walks_the_wrapper_chain():
    x = np.zeros((4, 3), np.uint8)
    src = ArrayDataSetIterator(x, x, batch_size=2)
    pp = pnorm.ImagePreProcessingScaler()
    src.set_pre_processor(pp)
    wrapped = AsyncDataSetIterator(src)
    owner, got, aff = pnorm.engage_device_affine(wrapped)
    assert owner is src and got is pp and src.pre_processor is None
    assert aff[1] == np.float32(1 / 255)
    plain = ArrayDataSetIterator(x, x, batch_size=2)
    assert pnorm.engage_device_affine(plain) == (None, None, None)
    # a non-affine pre-processor stays attached
    std = pnorm.NormalizerStandardize(fit_labels=True).fit(
        DataSet(x.astype(np.float32), x.astype(np.float32)))
    plain.set_pre_processor(std)
    assert pnorm.engage_device_affine(plain) == (None, None, None)
    assert plain.pre_processor is std


def test_context_skips_for_a_model_reading_listener():
    x = np.zeros((4, 3), np.uint8)
    it = ArrayDataSetIterator(x, x, batch_size=2)
    pp = pnorm.ImagePreProcessingScaler()
    it.set_pre_processor(pp)

    class Reader:
        reads_model = True

    with pnorm.engaged_device_affine(it, [Reader()]) as aff:
        assert aff is None and it.pre_processor is pp
    with pnorm.engaged_device_affine(it, []) as aff:
        assert aff is not None and it.pre_processor is None
    assert it.pre_processor is pp


def _uint8_data(n=48):
    rs = np.random.RandomState(7)
    x = rs.randint(0, 256, (n, 6)).astype(np.uint8)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _mlp():
    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(1e-2))
            .list().layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph():
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(5)
                      .updater(Adam(1e-2)))
         .add_inputs("in").set_input_types(InputType.feed_forward(6)))
    g.add_layer("d", DenseLayer(n_out=16, activation="relu"), "in")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "d")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device="cpu").init()


@pytest.mark.parametrize("make", [_mlp, _graph])
@pytest.mark.parametrize("scan_steps", [1, 2])
def test_fit_with_the_device_affine_matches_host_normalization(make,
                                                               scan_steps):
    x, y = _uint8_data()
    pp = pnorm.ImagePreProcessingScaler()
    it = ArrayDataSetIterator(x, y, batch_size=12)
    it.set_pre_processor(pp)
    a = make()
    a.fit(it, epochs=2, scan_steps=scan_steps)
    assert it.pre_processor is pp                # restored after the fit
    b = make()
    b.fit(ArrayDataSetIterator(pp.transform(x), y, batch_size=12), epochs=2,
          scan_steps=scan_steps)
    for la, lb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_bf16_compute_normalizes_before_the_cast():
    """features ~ N(1000, 1): the standardized signal lives in f32 bits a
    bf16 cast before the affine (ulp ~4 at 1000) would destroy."""
    rs = np.random.RandomState(9)
    x = (1000.0 + rs.randn(96, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 4000.0).astype(int)]
    pp = pnorm.NormalizerStandardize().fit(DataSet(x, y))
    conf = (NeuralNetConfiguration.Builder().seed(2).updater(Adam(5e-2))
            .compute_dtype("bfloat16").list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    it = ArrayDataSetIterator(x, y, batch_size=32)
    it.set_pre_processor(pp)
    net.fit(it, epochs=40, scan_steps=3)
    assert net.evaluate(it).accuracy() > 0.9


def test_pre_processor_restored_on_error():
    x, y = _uint8_data(12)
    it = ArrayDataSetIterator(x, y, batch_size=12)
    pp = pnorm.ImagePreProcessingScaler()
    it.set_pre_processor(pp)

    class Boom(Exception):
        pass

    class BoomListener:
        def on_epoch_start(self, *a):
            raise Boom()

    net = _mlp()
    net.set_listeners(BoomListener())
    with pytest.raises(Boom):
        net.fit(it)
    assert it.pre_processor is pp and net._input_affine is None


def test_raw_uint8_features_without_a_normalizer_match_the_reference(
        tmp_path):
    """Raw uint8 pixels with no pre-processor are cast to the compute
    dtype (the reference's `_as_jnp`), not read as integer ids."""
    from deeplearning4j_tpu.data.iterator import (
        ArrayDataSetIterator as JArrayIt,
    )
    from deeplearning4j_tpu.nn.conf.base import InputType as JIT
    from deeplearning4j_tpu.nn.conf.network import (
        NeuralNetConfiguration as JNNC,
    )
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
    from deeplearning4j_tpu.util.serialization import (
        load_model as jload, save_model as jsave,
    )
    from deeplearning4j_tpu_torch.util.serialization import load_model
    conf = (JNNC.Builder().seed(5).updater(JSgd(1e-4)).list()
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(6)).build())
    path = str(tmp_path / "u8.zip")
    jsave(JMLN(conf).init(), path)
    x, y = _uint8_data(24)
    ref = jload(path)
    port = load_model(path, device="cpu")
    ref.fit(JArrayIt(x, y, batch_size=12), prefetch=False)
    port.fit(ArrayDataSetIterator(x, y, batch_size=12))
    np.testing.assert_allclose(port.score(), ref.score(), rtol=1e-5)
    np.testing.assert_allclose(port.output(x).numpy(),
                               np.asarray(ref.output(x)), atol=1e-5)
