"""The port's CNN zoo (`models/zoo.py`: ResNet50, LeNet, SimpleCNN)
against the JAX package, and the train CLI with a graph zip.

- ResNet50 at 32×32, 10 classes, batch 2, from one zip each way:
  `output()` (inference: BN from its running state), and one `fit` step
  (params, BN state, score).
- The space-to-depth stem is exactly the standard stem under
  `s2d_stem_weights`.
- LeNet through MultiLayerNetwork (the CNN -> FF preprocessor): output
  and 3 fit steps. SimpleCNN: the reference's config and output.
- `python -m deeplearning4j_tpu_torch.train` with a ResNet50 zip on
  `--device cpu`; without it and without CUDA it raises.

Tolerances: outputs f32 atol 1e-5. ResNet's fit step is compared in
float64 on both sides. At batch 2 the last stage's batch norm normalizes
2 values per channel (1×1 spatial), which amplifies rounding: in f32
the two packages' scores already differ by a few percent after one
training forward, and in f64 the step agrees to ~1e-3 of each leaf's
largest update (held to 1e-2, score rtol 1e-5). At batch 8 the same step
agrees to ~1e-12 of the update in f64 (held to 1e-6, score rtol 1e-10).
The BN state atol 1e-6. LeNet's 3 SGD steps: losses rtol 1e-4,
parameters atol 1e-5.
"""
import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models import zoo as pzoo
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import convolution as pconv
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
from deeplearning4j_tpu_torch.train import cli
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.util.params import iter_leaves
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, params_from_numpy, save_model,
)

RES = dict(num_classes=10, input_shape=(32, 32, 3))


def _perturb(net, seed=0):
    rs = np.random.RandomState(seed)
    net.params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rs.randn(*a.shape).astype("float32"),
        net.params)
    net.state = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rs.randn(*a.shape)).astype("float32"),
        net.state)
    return net


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """The reference ResNet50 (32×32, 10 classes), moved off its init
    constants (params and BN state), and its zip."""
    net = _perturb(jzoo.ResNet50(**RES).init())
    path = str(tmp_path_factory.mktemp("resnet") / "resnet.zip")
    jax_save(net, path)
    return net, path


def _images(n, hw=32, classes=10, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, hw, hw, 3).astype("float32"),
            np.eye(classes, dtype="float32")[rs.randint(0, classes, n)])


@pytest.mark.parametrize("kw", [{}, dict(space_to_depth_stem=True),
                                dict(num_classes=7, input_shape=(64, 48, 3))])
def test_resnet50_conf_is_the_reference_conf(kw):
    port = pzoo.ResNet50(**kw).conf()
    ref = jzoo.ResNet50(**kw).conf()
    assert port.to_dict() == ref.to_dict()
    assert port.topological_order() == ref.topological_order()


def test_resnet50_output_from_the_reference_zip(resnet):
    jnet, path = resnet
    pnet = load_model(path, device="cpu")
    assert isinstance(pnet, ComputationGraph)
    # the parameter dict in the reference's topological order
    assert list(pnet.params) == [n for n in jnet.conf.topological_order()
                                 if n in jnet.params]
    X, _ = _images(2)
    np.testing.assert_allclose(pnet.output(X).numpy(),
                               np.asarray(jnet.output(X)), atol=1e-5)
    assert pnet.num_params() == jnet.num_params() == 23_528_522


def test_resnet50_port_zip_loads_in_the_reference(tmp_path):
    pnet = pzoo.ResNet50(**RES).init(device="cpu")
    with torch.no_grad():
        for _, leaf in iter_leaves(pnet.state):
            leaf.add_(0.05)
    path = str(tmp_path / "p.zip")
    save_model(pnet, path)
    with zipfile.ZipFile(path) as zf:
        assert json.loads(zf.read("metadata.json"))["model_type"] == \
            "ComputationGraph"
        assert "updaterState.bin" in zf.namelist()
    jnet = jax_load(path)
    X, _ = _images(2, seed=3)
    np.testing.assert_allclose(pnet.output(X).numpy(),
                               np.asarray(jnet.output(X)), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(jnet.state["stem_bn"]["var"]),
        pnet.state["stem_bn"]["var"].numpy())


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("batch,update_tol,score_tol", [
    (2, 1e-2, 1e-5), (8, 1e-6, 1e-10)])
def test_resnet50_one_fit_step_matches_in_float64(resnet, x64, batch,
                                                   update_tol, score_tol):
    jnet32, _ = resnet
    conf = dataclasses.replace(jnet32.conf, dtype="float64")
    jnet = JCG(conf)
    jnet._vertex_types = jnet._resolve_types()
    to64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    jnet.params = jax.tree_util.tree_map(to64, jnet32.params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, jnet32.state)
    jnet._build_optimizer()
    pnet = ComputationGraph(
        ComputationGraphConfiguration.from_json(conf.to_json()),
        device="cpu").init()
    pnet.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu",
        template=pnet.params)
    pnet.state = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.state), "cpu",
        template=pnet.state)
    before = {p: t.clone() for p, t in iter_leaves(pnet.params)}
    X, Y = _images(batch, seed=5)
    jnet.fit(JMDS((X.astype("float64"),), (Y.astype("float64"),)),
             scan_steps=1)
    pnet.fit(MultiDataSet((X.astype("float64"),), (Y.astype("float64"),)))
    np.testing.assert_allclose(pnet.score(), jnet._score, rtol=score_tol)
    worst = 0.0
    for path, leaf in iter_leaves(pnet.params):
        ref = jnet.params
        for k in path:
            ref = ref[k]
        update = (leaf - before[path]).abs().max().item()
        err = np.abs(leaf.numpy() - np.asarray(ref)).max()
        worst = max(worst, err / update)
    assert worst <= update_tol
    for path, leaf in iter_leaves(pnet.state):
        ref = jnet.state
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref), atol=1e-6)


def test_space_to_depth_stem_is_exact_under_the_mapping():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 64, 64, 3).astype("float32"))
    w7 = rs.randn(7, 7, 3, 16).astype("float32") * 0.1
    w4 = pzoo.s2d_stem_weights(w7)
    np.testing.assert_array_equal(w4, jzoo.s2d_stem_weights(w7))
    pad = pconv.ZeroPaddingLayer(padding=(3, 3, 3, 3))
    conv7 = pconv.ConvolutionLayer(n_out=16, kernel=(7, 7), stride=(2, 2),
                                   convolution_mode="truncate",
                                   has_bias=False)
    ref, _ = conv7.apply({"W": torch.from_numpy(w7)}, {},
                         pad.apply({}, {}, x)[0])
    s2d = pconv.SpaceToDepthLayer(block_size=2)
    pad2 = pconv.ZeroPaddingLayer(padding=(2, 1, 2, 1))
    conv4 = pconv.ConvolutionLayer(n_out=16, kernel=(4, 4), stride=(1, 1),
                                   convolution_mode="truncate",
                                   has_bias=False)
    out, _ = conv4.apply({"W": torch.from_numpy(w4)}, {},
                         pad2.apply({}, {}, s2d.apply({}, {}, x)[0])[0])
    assert ref.shape == out.shape == (2, 32, 32, 16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    base = pzoo.ResNet50(**RES).init(device="cpu").num_params()
    s2d_net = pzoo.ResNet50(space_to_depth_stem=True, **RES).init(
        device="cpu")
    assert s2d_net.num_params() - base == (192 - 147) * 64
    with pytest.raises(ValueError, match="even"):
        pzoo.ResNet50(space_to_depth_stem=True,
                      input_shape=(33, 32, 3)).conf()


def test_lenet_output_and_three_fit_steps_match(tmp_path):
    # SGD in place of the zoo's Adam: Adam's m/sqrt(v) turns a rounding-
    # level gradient into a full-size step, so leaves with ~0 gradient
    # would differ by up to the learning rate
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
    assert pzoo.LeNet().conf().to_dict() == jzoo.LeNet().conf().to_dict()
    jnet = JMLN(dataclasses.replace(jzoo.LeNet().conf(),
                                    updater=JSgd(0.05))).init()
    rs = np.random.RandomState(2)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rs.randn(*a.shape).astype("float32"),
        jnet.params)
    path = str(tmp_path / "lenet.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    assert isinstance(pnet, MultiLayerNetwork)
    X = rs.rand(12, 28, 28, 1).astype("float32")
    Y = np.eye(10, dtype="float32")[rs.randint(0, 10, 12)]
    np.testing.assert_allclose(pnet.output(X).numpy(),
                               np.asarray(jnet.output(X)), atol=1e-5)
    jc, pc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    pnet.set_listeners(pc)
    jnet.fit((X, Y), batch_size=4, scan_steps=1, prefetch=False)
    pnet.fit((X, Y), batch_size=4)
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-4)
    for p, j in zip(tree_leaves(pnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)


def test_simple_cnn_conf_and_output(tmp_path):
    assert pzoo.SimpleCNN().conf().to_dict() == \
        jzoo.SimpleCNN().conf().to_dict()
    jnet = _perturb(jzoo.SimpleCNN(input_shape=(16, 16, 3)).init(), seed=4)
    path = str(tmp_path / "simple.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    X, _ = _images(3, hw=16)
    np.testing.assert_allclose(pnet.output(X).numpy(),
                               np.asarray(jnet.output(X)), atol=1e-5)


def test_zoo_registry_and_pretrained_cache(tmp_path):
    assert {"LeNet", "SimpleCNN", "ResNet50"} <= set(pzoo.zoo_models())
    assert isinstance(pzoo.model_by_name("resnet50"), pzoo.ResNet50)
    with pytest.raises(FileNotFoundError, match="pretrained"):
        pzoo.LeNet().init_pretrained(cache_dir=str(tmp_path))
    net = pzoo.LeNet().init(device="cpu")
    save_model(net, str(tmp_path / "lenet.zip"))
    again = pzoo.LeNet().init_pretrained(cache_dir=str(tmp_path),
                                         device="cpu")
    for a, b in zip(tree_leaves(again.params), tree_leaves(net.params)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def graph_cli_inputs(tmp_path_factory):
    """A port-written ResNet50 zip and an npz of 8 images, one-hot uint8
    labels."""
    tmp = tmp_path_factory.mktemp("cli")
    net = pzoo.ResNet50(**RES).init(device="cpu")
    src = save_model(net, str(tmp / "resnet.zip"))
    X, Y = _images(8, seed=6)
    data = str(tmp / "images.npz")
    np.savez(data, features=X, labels=Y.astype("uint8"))
    return src, data


def test_train_cli_trains_a_graph_zip_on_the_cpu(graph_cli_inputs, tmp_path,
                                                 capsys):
    src, data = graph_cli_inputs
    out = str(tmp_path / "out.zip")
    code = cli.main(["--model", src, "--dataset", data, "--output", out,
                     "--mode", "single", "--batch-size", "4",
                     "--device", "cpu", "--score-every", "1"])
    assert code == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["iterations"] == 2 and result["epochs"] == 1
    assert np.isfinite(result["final_score"])
    trained = load_model(out, device="cpu")
    assert isinstance(trained, ComputationGraph)
    assert trained.iteration_count == 2
    assert int(trained.opt_state["0"]["trace"]["output"]["W"].ne(0).any())


def test_train_cli_with_a_graph_zip_needs_cuda_by_default(graph_cli_inputs,
                                                         tmp_path,
                                                         monkeypatch):
    src, data = graph_cli_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--model", src, "--dataset", data, "--output",
                  str(tmp_path / "o.zip"), "--mode", "single"])
    assert not (tmp_path / "o.zip").exists()
